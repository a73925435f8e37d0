"""The port's parallel modes across two CPU processes (gloo), step by step,
against the port's one-process step and the JAX package's parallel steps.

Each case runs `tests/torch_parallel_worker.py` (torch and the port only)
as two child processes on a free port, each with a timeout (a stuck
collective kills both and fails); rank 0 writes the final params. The JAX
side runs here, in the parent, on the conftest's fake CPU devices. Weights
go from flax to the port through `convert.py`.

Tolerances:
- two ranks against one process at the full batch, augmentation on: rtol
  5e-4, atol 2e-4 on the params, the JAX package's own for its two data
  parallel realizations (tests/test_parallel.py:121-124); the loss within
  1e-4 relative. f32 on both sides; only the sums' order differs.
- ZeRO-1 (grad_accum 2, EMA) against `make_zero1_train_step` on two of
  the JAX devices, and tp=2 against the JAX dp x tp step: the JAX tests'
  tolerances for those steps against their replicated twins (rtol 5e-4 /
  atol 1e-3 after 3 ZeRO-1 steps, tests/test_zero1.py; rtol 1e-3 / atol
  2e-3 after a TP step, tests/test_tensor_parallel.py: Adam's first steps
  amplify reduction-order noise in near-zero gradients).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.models.dpt import DPTDepthNet as JDPT
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.parallel import mesh as jmesh
from ann3depth_tpu.parallel import sharding_rules as jrules
from ann3depth_tpu.parallel import zero1 as jzero1
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.parallel import sharding_rules
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep

import torch_parallel_worker as worker

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
RANK_TIMEOUT_S = 120
DP_RTOL, DP_ATOL, LOSS_RTOL = 5e-4, 2e-4, 1e-4
ZERO1_RTOL, ZERO1_ATOL = 5e-4, 1e-3
TP_RTOL, TP_ATOL = 1e-3, 2e-3


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env():
    """The children's environment: the repo importable, two threads each.
    The suite runs several workers at once, which is why the port's test
    modules run on one torch thread (the root conftest.py's `one_thread`);
    a fixture does not reach a child process, so its environment says it."""
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")


def wait_all(procs, timeout=RANK_TIMEOUT_S):
    """Wait for every child; on a timeout kill them all and fail. Returns
    their (stdout, stderr)."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail("a rank timed out (collective deadlock?)")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
    return outs


def run_ranks(tmp_path, name, case, inputs, world=2):
    """Write the inputs, run the worker on `world` ranks, return rank 0's
    npz as a dict."""
    np.savez(tmp_path / f"{name}_in.npz", **inputs)
    case = dict(case, inputs=str(tmp_path / f"{name}_in.npz"),
                output=str(tmp_path / f"{name}_out.npz"))
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(case))
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), port, str(path)],
        cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    wait_all(procs)
    with np.load(case["output"]) as out:
        return {k: out[k] for k in out.files}


def batch(b, seed=0, raw_hw=(40, 56), depth_hw=(15, 11)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, *raw_hw, 3), dtype=np.uint8)
    dep = rng.uniform(1.0, 60.0, (b, *depth_hw)).astype(np.float32)
    dep[:, ::3, ::4] = 0.0
    return img, dep


ENCDEC = {"model": {"width_mult": 0.25, "compute_dtype": "float32"},
          "data": {"input_hw": [32, 48]},
          "train": {"warmup_steps": 0, "learning_rate": 1e-3, "steps": 2,
                    "ema_decay": 0.9}}


def encdec_case(kind, steps=2, augment=True, **train):
    over = {k: dict(v) for k, v in ENCDEC.items()}
    over["data"]["augment"] = augment
    over["train"].update(steps=steps, **train)
    return {"kind": kind, "steps": steps, "config": over}


def port_sd(params):
    return convert.to_state_dict(jax.tree.map(np.asarray, params))


def encdec_inputs(b, seed=0):
    params = jstep.init_params(
        jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32),
        (32, 48), seed=seed)
    img, dep = batch(b, seed)
    sd = port_sd(params)
    return params, {"img": img, "dep": dep,
                    **{f"sd/{k}": v.numpy() for k, v in sd.items()}}


def one_process(case, inputs, twin=1):
    """The port's one-process run of a case at the full batch; with twin
    n > 1, of `sharding_rules.tp_twin(model, n)`."""
    cfg = worker.config(case)
    t = cfg.train
    sd = {k[3:]: torch.from_numpy(v) for k, v in inputs.items()
          if k.startswith("sd/")}
    model = sharding_rules.tp_twin(worker.model_of(case, cfg, sd), twin)
    state = tstep.TrainState.create(model, worker.update_rule(cfg),
                                    ema=t.ema_decay > 0)
    generator = torch.Generator()
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=tuple(case.get("target_hw")
                              or tloop.resolved_target_hw(cfg)),
              si_lambda=t.si_lambda, augment=cfg.data.augment,
              loss_kind=t.loss, ema_decay=t.ema_decay,
              grad_accum=t.grad_accum)
    img, dep = torch.from_numpy(inputs["img"]), torch.from_numpy(
        inputs["dep"])
    for step in range(case["steps"]):
        generator.manual_seed(tloop.step_seed(t.seed, step))
        state, metrics = tstep.train_step(state, img, dep, generator, **kw)
    return state, {k: float(v) for k, v in metrics.items()}


def assert_params(got, want, rtol, atol, prefix="p/"):
    names = sorted(want)
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)) \
        == names
    for k in names:
        np.testing.assert_allclose(got[prefix + k], want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_step_as_one_process_at_the_full_batch(tmp_path, accum):
    """Replicated data parallelism (train/step.py's all-reduce), with
    augmentation on: two ranks of 4 rows equal one process at 8, params,
    EMA and loss, after 2 steps (with grad_accum 2: microbatches of 2)."""
    _, inputs = encdec_inputs(8)
    case = encdec_case("dp", batch_size=8, grad_accum=accum)
    got = run_ranks(tmp_path, "dp", case, inputs)
    state, metrics = one_process(case, inputs)
    assert_params(got, {k: v.detach().numpy()
                        for k, v in state.params.items()}, DP_RTOL, DP_ATOL)
    assert_params(got, {k: v.numpy() for k, v in state.ema_params.items()},
                  DP_RTOL, DP_ATOL, prefix="e/")
    assert float(got["m/loss"]) == pytest.approx(metrics["loss"],
                                                 rel=LOSS_RTOL)
    assert float(got["m/rmse"]) == pytest.approx(metrics["rmse"],
                                                 rel=LOSS_RTOL)


def test_shard_step_equals_the_loop_step(tmp_path):
    """parallel/shard_step.py's explicit-collective step against the
    loop's data-parallel step, augmentation off, as
    tests/test_parallel.py:95-124 holds the JAX twins: one step each."""
    _, inputs = encdec_inputs(8, seed=1)
    want = run_ranks(tmp_path, "loop", encdec_case(
        "dp", steps=1, augment=False, batch_size=8, ema_decay=0.0), inputs)
    got = run_ranks(tmp_path, "shard", encdec_case(
        "shard_step", steps=1, augment=False, batch_size=8,
        ema_decay=0.0), inputs)
    assert_params(got, {k[2:]: v for k, v in want.items()
                        if k.startswith("p/")}, DP_RTOL, DP_ATOL)
    assert float(got["m/loss"]) == pytest.approx(float(want["m/loss"]),
                                                 rel=LOSS_RTOL)


def test_zero1_matches_the_jax_zero1_step(tmp_path, cpu_mesh):
    """Two-rank ZeRO-1 with grad_accum 2 and EMA, 3 steps, against
    `make_zero1_train_step` on two of the JAX devices from the same
    weights; each rank holds half the optimizer state."""
    params, inputs = encdec_inputs(8, seed=2)
    steps, lr = 3, 1e-3
    case = encdec_case("zero1", steps=steps, augment=False, batch_size=8,
                       grad_accum=2, learning_rate=lr, schedule="constant")
    got = run_ranks(tmp_path, "zero1", case, inputs)

    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    mesh = jmesh.create_mesh(list(cpu_mesh.devices.flat)[:2])
    with jax.default_matmul_precision("highest"):
        init_fn, step_fn = jzero1.make_zero1_train_step(
            mesh, model.apply, params, input_hw=(32, 48),
            target_hw=tuple(tloop.resolved_target_hw(worker.config(case))),
            si_lambda=0.5, augment=False, resize_precision="highest",
            learning_rate=lr, clip_norm=1.0, weight_decay=0.0,
            grad_accum=2, ema_decay=0.9)
        p = jmesh.replicate(params, mesh)
        ema = jmesh.replicate(jax.tree.map(np.copy, params), mesh)
        opt = init_fn(p)
        sh = jmesh.shard_batch({"i": inputs["img"], "d": inputs["dep"]},
                               mesh)
        step_no = jax.device_put(jnp.zeros((), jnp.int32),
                                 jmesh.replicated(mesh))
        rng = jax.device_put(jax.random.key(0), jmesh.replicated(mesh))
        for _ in range(steps):
            p, opt, step_no, ema, m = step_fn(p, opt, step_no, ema,
                                              sh["i"], sh["d"], rng)
    want = {k: v.numpy() for k, v in port_sd(jax.device_get(p)).items()}
    want_ema = {k: v.numpy()
                for k, v in port_sd(jax.device_get(ema)).items()}
    assert_params(got, want, ZERO1_RTOL, ZERO1_ATOL)
    assert_params(got, want_ema, ZERO1_RTOL, ZERO1_ATOL, prefix="e/")
    assert float(got["m/loss"]) == pytest.approx(float(m["loss"]), rel=1e-4)
    assert float(got["m/rmse"]) == pytest.approx(float(m["rmse"]), rel=1e-4)
    # Adam's two moments of every param: half a rank's share each, up to
    # the padding of each param to 2 chunks and the step counters.
    n_params = sum(v.size for v in want.values())
    per_rank = got["opt_bytes"]
    assert per_rank.shape == (2,) and per_rank[0] == per_rank[1]
    assert 2 * 4 * n_params / 2 <= per_rank[0] <= 2 * 4 * (
        n_params / 2 + len(want)) + 64 * len(want)


TINY_DPT = dict(dim=64, depth=5, heads=2, fusion_features=32,
                tap_layers=(1, 2, 3, 4))


def tiny_dpt_inputs(b, seed=0):
    params = jstep.init_params(
        JDPT(**TINY_DPT, compute_dtype=jnp.float32, remat=False), (32, 32),
        seed=seed)
    img, dep = batch(b, seed, raw_hw=(40, 40), depth_hw=(20, 20))
    return params, {"img": img, "dep": dep, **{
        f"sd/{k}": v.numpy() for k, v in port_sd(params).items()}}


def tp_case(steps, **train):
    return {"kind": "tp", "tp": 2, "steps": steps, "preset": "smoke",
            "tiny_dpt": TINY_DPT, "target_hw": [32, 32],
            "config": {"model": {"name": "dpt-small",
                                 "compute_dtype": "float32"},
                       "data": {"input_hw": [32, 32], "augment": False},
                       "train": {"learning_rate": 1e-3, "warmup_steps": 0,
                                 "schedule": "constant", "ema_decay": 0.0,
                                 "steps": steps, **train}}}


def test_tp2_matches_the_jax_dp_tp_step(tmp_path, cpu_mesh):
    """tp=2 on two ranks (q/k/v/out and the MLP sharded over the model
    axis, the all-reduces by hand) against the JAX package's dp x tp step
    (tests/test_tensor_parallel.py:38) from the same weights, one step."""
    params, inputs = tiny_dpt_inputs(8)
    got = run_ranks(tmp_path, "tp", tp_case(1, batch_size=8), inputs)
    model = JDPT(**TINY_DPT, compute_dtype=jnp.float32, remat=False)
    kw = dict(input_hw=(32, 32), target_hw=(32, 32), si_lambda=0.5,
              augment=False, resize_precision="highest")
    with jax.default_matmul_precision("highest"):
        mesh = jmesh.create_mesh_2d(1, 2, list(cpu_mesh.devices.flat))
        sharded = jrules.shard_params(params, mesh, tensor_parallel=True)
        state = jstep.TrainState.create(model.apply, sharded,
                                        jstep.make_optimizer(1e-3))
        b = jmesh.shard_batch({"i": inputs["img"], "d": inputs["dep"]}, mesh)
        rng = jax.device_put(jax.random.key(0), jmesh.replicated(mesh))
        state, m = jstep.train_step(state, b["i"], b["d"], rng, **kw)
    want = {k: v.numpy()
            for k, v in port_sd(jax.device_get(state.params)).items()}
    assert_params(got, want, TP_RTOL, TP_ATOL)
    assert float(got["m/loss"]) == pytest.approx(float(m["loss"]), rel=2e-4)
    # 5 blocks, attention and MLP sharded: 2 all-reduces forward, 2 backward
    assert got["tp_collectives"].tolist() == [10, 10]


def test_tp_composes_with_grad_accum(tmp_path):
    """--tp 2 with grad_accum 2 (tests/test_tensor_parallel.py:138): two
    steps on two ranks against the port's one process at the full batch,
    held to the TP tolerance (the attention's key weights have near-zero
    gradients at init, which Adam turns into full-size steps)."""
    _, inputs = tiny_dpt_inputs(8, seed=3)
    case = tp_case(2, batch_size=8, grad_accum=2)
    got = run_ranks(tmp_path, "tp_accum", case, inputs)
    state, metrics = one_process(case, inputs)
    assert_params(got, {k: v.detach().numpy()
                        for k, v in state.params.items()}, TP_RTOL, TP_ATOL)
    assert float(got["m/loss"]) == pytest.approx(metrics["loss"],
                                                 rel=LOSS_RTOL)


def test_tp2_gradients_equal_one_process(tmp_path):
    """One plain-SGD step (no momentum, clip or decay) moves each param by
    lr times its gradient, so tp=2 against one process at f32 holds the
    sharded model's gradients (those of every shard, of the replicated
    params behind the all-reduces, and the global norm) to summation
    order: 1e-6 absolute at lr 1e-3 on gradients up to ~1e2."""
    _, inputs = tiny_dpt_inputs(8, seed=4)
    case = tp_case(1, batch_size=8, optimizer="sgd", adam_b1=0.0,
                   clip_norm=0.0)
    got = run_ranks(tmp_path, "tp_sgd", case, inputs)
    state, metrics = one_process(case, inputs)
    assert isinstance(state.optimizer, torch.optim.SGD)
    assert_params(got, {k: v.detach().numpy()
                        for k, v in state.params.items()}, 0, 1e-6)
    assert float(got["m/grad_norm"]) == pytest.approx(
        metrics["grad_norm"], rel=1e-5)


def test_tp2_in_bf16_equals_its_one_process_twin(tmp_path):
    """dpt-small in bf16 at --tp 2 for 3 steps of the preset's warmup
    (lr 0, then 1e-6 and 2e-6: Adam's first steps) against one process
    computing the same sums in the same order (`tp_twin`): params within
    1e-8 (1% of one step's move; a conv's weight gradient may sum in
    another order under another thread count: one ulp seen) and the loss
    within 1e-6. Against the plain model the loss parts by ~1.5%:
    in bf16, partial products summed in f32 and a whole product rounded
    once are different numbers, and DPT's first steps carry that on
    (PERF.md §6). No clip: the twin's global norm sums its squares
    in another order."""
    from ann3depth_tpu_torch.models import registry

    case = {"kind": "tp", "tp": 2, "steps": 3, "preset": "smoke",
            "target_hw": [64, 64],
            "config": {"model": {"name": "dpt-small",
                                 "compute_dtype": "bfloat16"},
                       "data": {"input_hw": [64, 64], "augment": False},
                       "train": {"learning_rate": 1e-4, "warmup_steps": 100,
                                 "ema_decay": 0.0, "steps": 1000,
                                 "batch_size": 8, "clip_norm": 0.0}}}
    cfg = worker.config(case)
    model = tstep.init_params(registry.build(cfg.model), (64, 64), 0)
    img, dep = batch(8, 5, raw_hw=(80, 80), depth_hw=(40, 40))
    inputs = {"img": img, "dep": dep, **{
        f"sd/{k}": v.detach().numpy() for k, v in model.state_dict().items()}}
    got = run_ranks(tmp_path, "tp_bf16", case, inputs)
    state, metrics = one_process(case, inputs, twin=2)
    assert_params(got, {k: v.detach().numpy()
                        for k, v in state.params.items()}, 0, 1e-8)
    assert float(got["m/loss"]) == pytest.approx(metrics["loss"], rel=1e-6)
