"""The port's parallel modules in one process: the mesh's rules and
errors, `shard_batch`, the DPT tensor-parallel rules against the JAX
package's, the ZeRO-1 chunk layout, and one-process ZeRO-1 against the
replicated trainer. The multi-rank steps are held in
tests/test_torch_multiprocess.py and tests/test_torch_multiprocess_cli.py.

JAX's errors are compared with the port's after every number is replaced
by N: the JAX side runs on the conftest's 8 fake devices, the port on its
own rank count.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models.dpt import DPTDepthNet as JDPT
from ann3depth_tpu.parallel import mesh as jmesh
from ann3depth_tpu.parallel import sharding_rules as jrules
from ann3depth_tpu.parallel import zero1 as jzero1
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.models.dpt import DPTDepthNet
from ann3depth_tpu_torch.parallel import mesh as meshlib
from ann3depth_tpu_torch.parallel import multihost, shard_step
from ann3depth_tpu_torch.parallel import sharding_rules as rules
from ann3depth_tpu_torch.parallel import zero1
from ann3depth_tpu_torch.train import checkpoint as tckpt
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return re.sub(r"\d+", "N", str(info.value))


def _world(monkeypatch, n):
    """Make the port's mesh see a world of n ranks (no group is made: the
    rules under test raise before)."""
    monkeypatch.setattr(meshlib, "_world", lambda: (0, n))


def test_auto_data_mesh_errors_match_jax(monkeypatch, cpu_mesh):
    want = _message(lambda: jmesh.auto_data_mesh(8, tp=3))
    _world(monkeypatch, 4)
    assert _message(lambda: meshlib.auto_data_mesh(8, tp=3)) == want
    assert want == "N devices not divisible by tensor_parallel=N"
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    want = _message(lambda: jmesh.auto_data_mesh(3))
    assert _message(lambda: meshlib.auto_data_mesh(3)) == want
    assert "multi-host meshes must span every process" in want


def test_create_mesh_2d_error_matches_jax(monkeypatch, cpu_mesh):
    want = _message(lambda: jmesh.create_mesh_2d(
        3, 4, list(cpu_mesh.devices.flat)))
    _world(monkeypatch, 2)
    assert _message(lambda: meshlib.create_mesh_2d(3, 4)) == want


def test_one_process_mesh_is_one_rank_without_collectives():
    mesh = meshlib.auto_data_mesh(3)
    assert (mesh.shape, mesh.data_rank, mesh.active()) == (
        {"data": 1, "model": 1}, 0, False)
    t = torch.ones(3)
    assert mesh.all_reduce(t) is t and t.tolist() == [1.0, 1.0, 1.0]
    out = torch.empty(3)
    mesh.all_gather(out, torch.arange(3.0))
    assert out.tolist() == [0.0, 1.0, 2.0]


def test_shard_batch_takes_the_rank_rows_and_matches_the_jax_error(
        cpu_mesh):
    x, y = np.arange(8 * 2).reshape(8, 2), torch.arange(8)
    mesh = meshlib.Mesh(n_data=4, n_model=2, data_rank=2, model_rank=1)
    got = meshlib.shard_batch({"x": x, "y": [y]}, mesh)
    np.testing.assert_array_equal(got["x"], x[4:6])
    assert got["y"][0].tolist() == [4, 5]
    want = _message(lambda: jmesh.shard_batch({"x": np.zeros((3, 4))},
                                              cpu_mesh))
    assert _message(lambda: meshlib.shard_batch(
        {"x": np.zeros((3, 4))}, mesh)) == want


def _dpt_pair(dim=128, depth=4, heads=4):
    """A JAX DPT's params and a port DPT (the same widths, f32)."""
    kw = dict(dim=dim, depth=depth, heads=heads, fusion_features=32,
              tap_layers=(0, 1, 2, 3))
    params = jstep.init_params(JDPT(**kw, compute_dtype=jnp.float32,
                                    remat=False), (32, 32), seed=0)
    model = tstep.init_params(DPTDepthNet(**kw, compute_dtype=torch.float32,
                                          remat=False), (32, 32))
    return params, model


def _flax_dim_to_torch(key, shape, axis):
    """The torch dim of the flax leaf's `axis`, through convert's layout
    change: tag each element with its index on `axis` and see which torch
    dim the tags vary along."""
    tags = np.broadcast_to(np.arange(shape[axis]).reshape(
        [-1 if i == axis else 1 for i in range(len(shape))]), shape)
    moved = convert._torch_layout(key, tags.astype(np.float32))
    varying = [d for d in range(moved.ndim)
               if moved.shape[d] > 1 and np.any(np.diff(moved, axis=d))]
    assert len(varying) == 1, (key, varying)
    return varying[0]


def _jax_plan(params, tp, devices):
    """{torch name: sharded torch dim} of the JAX package's placement of
    `params` on a (8/tp) x tp mesh."""
    mesh = jmesh.create_mesh_2d(len(devices) // tp, tp, devices)
    sharded = jrules.shard_params(params, mesh, tensor_parallel=True)
    plan = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        key = jrules._path_str(path)
        spec = tuple(leaf.sharding.spec)
        if "model" in spec:
            plan[convert.torch_name(key)] = _flax_dim_to_torch(
                key, leaf.shape, spec.index("model"))
    return plan


def test_tp_rules_match_jax_on_every_dpt_small_param(cpu_mesh):
    """tp_dim_for on every dpt-small param name against the JAX rule of
    its flax path (tp_spec_for), mapped through convert.py's names and
    layouts."""
    from ann3depth_tpu.models import registry as jreg
    from ann3depth_tpu.config import ModelConfig

    params = jstep.init_params(jreg.build(ModelConfig(
        name="dpt-small", compute_dtype="float32")), (32, 32), seed=0)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) > 50
    hits = 0
    for path, leaf in flat:
        key = jrules._path_str(path)
        spec = jrules.tp_spec_for(key, leaf.ndim)
        axis = (spec.index("model") if spec is not None and "model" in spec
                else None)
        want = (None if axis is None
                else _flax_dim_to_torch(key, leaf.shape, axis))
        assert rules.tp_dim_for(convert.torch_name(key)) == want, key
        hits += want is not None
    assert hits == 6 * 10  # q/k/v weight+bias, out, fc1 weight+bias, fc2


@pytest.mark.parametrize("heads,tp", [(4, 2), (4, 4), (6, 4), (4, 3)])
def test_tp_plan_matches_jax_placement(cpu_mesh, heads, tp):
    """shard_params shards exactly what the JAX package's shard_params
    shards: only where the dimension divides the model axis (6 heads at
    tp=4: the MLP only; tp=3 divides neither)."""
    devices = list(cpu_mesh.devices.flat)[:8 // tp * tp]
    params, model = _dpt_pair(dim=96 if heads == 6 else 128, heads=heads)
    mesh = meshlib.Mesh(n_model=tp, model_rank=tp - 1)
    plan = rules.shard_params(model, mesh)
    assert plan == _jax_plan(params, tp, devices)
    desc = rules.describe_sharding(model)
    assert desc["patch_embed.weight"] == "()"
    unsharded = dict(_dpt_pair(dim=96 if heads == 6 else 128,
                               heads=heads)[1].named_parameters())
    for name, dim in plan.items():
        assert "model" in desc[name]
        full, local = unsharded[name], dict(model.named_parameters())[name]
        assert local.shape[dim] * tp == full.shape[dim]
        # this rank (the last) holds the last slice
        torch.testing.assert_close(local, full.chunk(tp, dim)[-1])


def test_tp_refusals_match_jax(tmp_path):
    """tp with zero1 on a dpt model: both loops refuse it."""
    for get, train in ((jget_config, lambda c: jloop.train(
            c, workdir=str(tmp_path / "j"), progress=False)),
                       (get_config, lambda c: tloop.train(
                           c, workdir=str(tmp_path / "t"), progress=False,
                           device="cpu"))):
        cfg = get("smoke")
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, name="dpt-small"),
            train=dataclasses.replace(cfg.train, tensor_parallel=2,
                                      zero1=True, ckpt_dir=str(tmp_path)))
        with pytest.raises(ValueError, match="tensor_parallel with zero1 "
                                             "is not wired"):
            train(cfg)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_zero1_chunk_layout_matches_jax(n_dev):
    """Each param's flat f32 vector padded to N chunks of ceil(numel/N):
    rank r's chunk is the JAX package's `_local_chunk`, and the packed
    reduce-scatter buffer's row r is every param's chunk r in order."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((5,), (2, 3),
                                                          (4, 1, 2))]
    for x in xs:
        assert zero1.chunk_size(x.size, n_dev) == jzero1._chunk_size(
            x.size, n_dev)
        for r in range(n_dev):
            np.testing.assert_array_equal(
                zero1.local_chunk(torch.from_numpy(x), r, n_dev).numpy(),
                np.asarray(jzero1._local_chunk(jnp.asarray(x), r, n_dev)))
    model = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(x))
                                    for x in xs])
    opt = zero1.Zero1Optimizer(model, tstep.make_optimizer(1e-3),
                               meshlib.Mesh(n_data=n_dev))
    packed = opt._pack([torch.from_numpy(x) for x in xs])
    assert packed.shape == (n_dev, opt.total)
    for r in range(n_dev):
        np.testing.assert_array_equal(packed[r].numpy(), np.concatenate(
            [zero1.local_chunk(torch.from_numpy(x), r, n_dev).numpy()
             for x in xs]))


def _cfg(tmp_path, **train):
    cfg = get_config("smoke")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=(32, 48),
                                      synth_n=8, synth_test_n=4,
                                      synth_img_hw=(40, 56),
                                      synth_depth_hw=(15, 11)),
        train=dataclasses.replace(cfg.train, **{
            **dict(batch_size=4, steps=4, warmup_steps=0, log_every=2,
                   checkpoint_every=2, ema_decay=0.9,
                   ckpt_dir=str(tmp_path)), **train}))


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_one_process_zero1_equals_the_replicated_trainer(tmp_path):
    """ZeRO-1 on one rank (one chunk, no collective) trains as the
    replicated trainer does: the same update rule on the same numbers."""
    a, _ = tloop.train(_cfg(tmp_path / "a"), progress=False, device="cpu")
    b, _ = tloop.train(_cfg(tmp_path / "b", zero1=True), progress=False,
                       device="cpu")
    assert isinstance(b.optimizer, zero1.Zero1Optimizer)
    for k, v in _params(a).items():
        torch.testing.assert_close(b.params[k], v, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(b.ema_params[k], a.ema_params[k],
                                   rtol=1e-6, atol=1e-7)


def test_zero1_and_replicated_checkpoints_interchange(tmp_path):
    """A ZeRO-1 checkpoint holds the torch optimizer's state_dict in the
    params' shapes; a replicated run resumes from it and a ZeRO-1 run
    from a replicated one, both continuing the step counter."""
    tloop.train(_cfg(tmp_path, steps=2, zero1=True), progress=False,
                device="cpu")
    saved = torch.load(tmp_path / "ckpt_2.pt", weights_only=True)
    names = list(saved["model"])
    for i, st in saved["optimizer"]["state"].items():
        assert st["exp_avg"].shape == saved["model"][names[int(i)]].shape
    state, _ = tloop.train(_cfg(tmp_path, steps=4, resume=True),
                           progress=False, device="cpu")
    assert state.step == 4 and isinstance(state.optimizer,
                                          torch.optim.AdamW)
    state, _ = tloop.train(_cfg(tmp_path, steps=6, resume=True, zero1=True),
                           progress=False, device="cpu")
    assert state.step == 6
    assert tckpt.CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]


def test_shard_step_on_one_rank_equals_train_step():
    """make_dp_train_step over a one-rank mesh is the loop's step (no EMA,
    augmentation off): equal params."""
    cfg = _cfg("unused")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (4, 40, 56, 3),
                                        dtype=np.uint8))
    dep = torch.from_numpy(rng.uniform(1, 50, (4, 15, 11)).astype(
        np.float32))
    a, b = (tloop.create_state(cfg, torch.device("cpu")) for _ in range(2))
    kw = dict(input_hw=(32, 48), target_hw=tloop.resolved_target_hw(cfg))
    tstep.train_step(a, img, dep, **kw)
    step = shard_step.make_dp_train_step(meshlib.Mesh(), **kw)
    _, m = step(b, img, dep)
    assert b.step == 1 and sorted(m) == ["grad_norm", "loss", "rmse"]
    for k, v in a.params.items():
        torch.testing.assert_close(b.params[k], v, rtol=0, atol=0)


def test_multihost_without_a_group():
    assert (multihost.process_index(), multihost.process_count(),
            multihost.is_multiprocess(), multihost.backend()) == (
        0, 1, False, "")
    assert multihost.local_device("cpu") == torch.device("cpu")
    g1, g2 = (multihost.replicated_key(7) for _ in range(2))
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))
    with pytest.raises(ValueError, match="--coordinator needs"):
        multihost.initialize("127.0.0.1:1", device="cpu")
    with pytest.raises(ValueError, match="no process group to join"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs"):
        multihost.initialize("127.0.0.1:1", 1, 0, device="cpu",
                             backend="nccl")
    with pytest.raises(ValueError, match="not in"):
        multihost.initialize("127.0.0.1:1", 2, 2, device="cpu")


def test_parallel_state_leaves_a_one_process_run_alone(tmp_path):
    cfg = _cfg(tmp_path)
    state = tloop.create_state(cfg, torch.device("cpu"))
    assert tloop.parallel_state(cfg, state, meshlib.Mesh()) is state


def test_tp_twin_keeps_the_params_and_the_function():
    """The one-process twin of tp=2 keeps every param under its name and,
    in f32, computes the plain model's function (summation order only)."""
    _, model = _dpt_pair(dim=64, heads=2)
    names = list(model.state_dict())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        rules.tp_twin(model, 2)
        got = model(x)
    assert list(model.state_dict()) == names
    assert type(model.block0.attn).__name__ == "_TwinAttention"
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
