"""The port's K-step dispatch (ann3depth_tpu_torch/train/dispatch.py) and
the train loop's new feeds (cache_device, the window pool, the worker
loader, DeviceFeed) and eval pools, on the CPU, case by case against
tests/test_scan_dispatch.py, test_device_cache.py and
test_streaming_pool.py:

- K-step blocks land on the K=1 parameters within the JAX test's rtol
  2e-5 / atol 2e-6 (test_scan_dispatch.py:41), plain, with grad_accum 2,
  with augmentation and on the window pool (on the CPU the block runs the
  slot step the card captures, K times eagerly);
- the port's cache_device loop logs the JAX cache_device loop's losses on
  the smoke preset, from the JAX params carried across, within rtol 2e-2
  (the tolerance of tests/test_torch_train_loop.py's host-fed match):
  both samplers draw one order, so both loops see the same batches;
- every validation error of the JAX loop for these options is raised with
  the same message;
- `eval --cache-device` and the shared protocol pool equal host eval.

Frames are 16x16 synthetic scenes on the smoke preset, as
tests/test_scan_dispatch.py uses them.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.parallel import mesh as meshlib
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.pipeline import device_cache as tdc
from ann3depth_tpu_torch.pipeline import streaming_pool as tsp
from ann3depth_tpu_torch.train import dispatch
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import losses as tlosses
from ann3depth_tpu_torch.train import step as tstep

DATA = dict(input_hw=(32, 48), synth_img_hw=(16, 16), synth_depth_hw=(8, 8),
            synth_n=32, synth_test_n=16)


def _cfg(get, tmp_path, sub, data=None, **train):
    """The smoke preset on 16x16 scenes with a device pool, as
    tests/test_scan_dispatch.py:_cfg builds it."""
    cfg = get("smoke")
    data = {**DATA, "cache_device": True, **(data or {})}
    train = {"steps": 8, "batch_size": 8, "seed": 7,
             "ckpt_dir": str(tmp_path / sub / "ckpt"), "checkpoint_every": 8,
             "log_every": 4, "eval_every": 0, **train}
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **data),
        train=dataclasses.replace(cfg.train, **train))


def _run(cfg, tmp_path, sub, **kw):
    return tloop.train(cfg, workdir=str(tmp_path / sub / "w"),
                       progress=False, device="cpu", **kw)


def _rows(tmp_path, sub):
    with open(tmp_path / sub / "w" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _params_close(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# K-step blocks against K=1.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,train", [
    ({}, {}),
    ({}, {"grad_accum": 2}),
    ({"augment": True}, {"grad_accum": 2, "ema_decay": 0.9}),
    ({"augment": True}, {"optimizer": "adam"}),
])
def test_k_blocks_match_the_k1_loop(tmp_path, data, train):
    s1, m1 = _run(_cfg(get_config, tmp_path, "a", data, **train), tmp_path,
                  "a")
    s4, m4 = _run(_cfg(get_config, tmp_path, "b", data,
                       steps_per_dispatch=4, **train), tmp_path, "b")
    assert s1.step == s4.step == 8
    _params_close(s1, s4)
    assert np.isclose(m1["loss"], m4["loss"], rtol=2e-4)
    if s1.ema_params is not None:
        for k in s1.ema_params:
            np.testing.assert_allclose(s1.ema_params[k].numpy(),
                                       s4.ema_params[k].numpy(), rtol=2e-5,
                                       atol=2e-6)
    # logged at the same steps, the block's last step's metrics
    want = [(r["step"], r["loss"]) for r in _rows(tmp_path, "a")]
    got = [(r["step"], r["loss"]) for r in _rows(tmp_path, "b")]
    assert [s for s, _ in got] == [s for s, _ in want] == [4, 8]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=2e-4)


def test_block_runner_reads_its_slots(tmp_path):
    """The slot step reads row s of the block's buffers and advances s;
    the learning rates are the schedule's at each step."""
    cfg = _cfg(get_config, tmp_path, "r", warmup_steps=4)
    state = tloop.create_state(cfg, torch.device("cpu"))
    ds = SyntheticDepthDataset(n=32, img_hw=(16, 16), depth_hw=(8, 8))
    pool = tdc.DevicePoolSampler(ds, 8, "cpu", steps=8, seed=0)
    kw = dict(input_hw=(32, 48), target_hw=tloop.resolved_target_hw(cfg),
              augment=False, grad_accum=1)
    runner = dispatch.BlockRunner(state, pool, 4, step_kwargs=kw,
                                  draw_seed=lambda s: s)
    blocks = list(pool.index_blocks(4))
    metrics = runner.run(blocks[0])
    assert int(runner.slot) == 4 and state.step == 4
    np.testing.assert_allclose(
        runner.lr_block.numpy(),
        [state.tx.schedule(c) for c in range(4)])
    assert sorted(metrics) == ["grad_norm", "loss", "rmse"]
    runner.run(blocks[1])
    assert state.step == 8 and runner.captures == runner.replays == 0
    (entry,) = runner._entries.values()  # the pool's one key
    np.testing.assert_array_equal(entry.inputs[0].numpy(),
                                  blocks[1].numpy())


def test_k_blocks_on_the_window_pool_match_k1(tmp_path):
    """--steps-per-dispatch composes with the rotating window and echoing
    (tests/test_streaming_pool.py:200)."""
    ds = SyntheticDepthDataset(n=64, img_hw=(96, 128), depth_hw=(48, 64))
    data = {"cache_window_mb": 1, "window_epochs": 2}
    s1, _ = _run(_cfg(get_config, tmp_path, "a", data), tmp_path, "a",
                 dataset=ds)
    s2, _ = _run(_cfg(get_config, tmp_path, "b", data, steps_per_dispatch=2),
                 tmp_path, "b", dataset=ds)
    _params_close(s1, s2)


@pytest.mark.parametrize("b1,weight_decay", [(0.0, 0.0), (0.9, 1e-4)])
def test_sgd_under_k_steps_matches_eager(tmp_path, b1, weight_decay):
    """--optimizer sgd under K-step blocks lands on the K=1 params (the
    rule is train/step.CapturableSGD, whose rate on the card a graph reads
    on the device; tests/test_torch_variants.py holds it against torch's
    SGD), and from one sgd checkpoint a K=2 run resumes as a K=1 run
    does."""
    import shutil

    kw = dict(optimizer="sgd", adam_b1=b1, weight_decay=weight_decay,
              learning_rate=1e-2)
    s1, m1 = _run(_cfg(get_config, tmp_path, "a", checkpoint_every=4, **kw),
                  tmp_path, "a")
    s2, m2 = _run(_cfg(get_config, tmp_path, "b", steps_per_dispatch=2,
                       **kw), tmp_path, "b")
    assert s1.step == s2.step == 8 and np.isfinite(m1["loss"])
    _params_close(s1, s2)
    assert np.isclose(m1["loss"], m2["loss"], rtol=2e-4)
    init = tloop.create_state(_cfg(get_config, tmp_path, "a", **kw), "cpu")
    moved = max(float((x - y).abs().max()) for x, y in zip(
        s1.model.parameters(), init.model.parameters()))
    assert moved > 100 * 2e-6, moved  # the tolerance is not the step size

    # steps 5-8 from the step-4 checkpoint of the 8-step run, at K=1 and 2
    resumed = []
    for k in (1, 2):
        sub = f"r{k}"
        shutil.copytree(tmp_path / "a" / "ckpt", tmp_path / sub / "ckpt")
        (tmp_path / sub / "ckpt" / "ckpt_8.pt").unlink()
        state, _ = _run(_cfg(get_config, tmp_path, sub, resume=True,
                             steps_per_dispatch=k, **kw), tmp_path, sub)
        assert state.step == 8
        resumed.append(state)
    _params_close(resumed[0], resumed[1])
    if b1:
        assert all("momentum_buffer" in st
                   for st in resumed[1].optimizer.state.values())


def test_resume_continues_block_aligned(tmp_path):
    """Mirrors tests/test_scan_dispatch.py:73."""
    cfg = _cfg(get_config, tmp_path, "e", steps_per_dispatch=4,
               checkpoint_every=4)
    half = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              steps=4))
    _run(half, tmp_path, "e")
    full = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              resume=True))
    state, metrics = _run(full, tmp_path, "e")
    assert state.step == 8 and np.isfinite(metrics["loss"])
    assert [r["step"] for r in _rows(tmp_path, "e")] == [4, 8]


def test_inloop_eval_between_blocks_from_the_eval_pool(tmp_path,
                                                       monkeypatch):
    """eval_every at a block boundary fires between dispatches
    (test_scan_dispatch.py:121) and scores the pool's fixed sample."""
    made = []
    real = tdc.DevicePoolSampler

    def spy(*a, **k):
        made.append(k.get("steps"))
        return real(*a, **k)

    monkeypatch.setattr(tdc, "DevicePoolSampler", spy)
    cfg = _cfg(get_config, tmp_path, "ev", steps_per_dispatch=4,
               eval_every=4)
    state, _ = _run(cfg, tmp_path, "ev")
    assert state.step == 8
    evals = [r for r in _rows(tmp_path, "ev") if "eval_rmse" in r]
    assert [r["step"] for r in evals] == [4, 8]
    assert all(np.isfinite(r["eval_rmse"]) for r in evals)
    assert made == [8, 0]  # the train pool, then one eval pool


def test_inloop_eval_of_a_tiny_split_uses_the_host_feed(tmp_path):
    cfg = _cfg(get_config, tmp_path, "tiny", data={"synth_test_n": 8},
               eval_every=4)
    _run(cfg, tmp_path, "tiny")
    evals = [r["eval_rmse"] for r in _rows(tmp_path, "tiny")
             if "eval_rmse" in r]
    assert len(evals) == 2 and all(np.isfinite(evals))


def test_early_stop_between_blocks_restores_in_place(tmp_path):
    cfg = _cfg(get_config, tmp_path, "es", steps_per_dispatch=2, steps=8,
               eval_every=2, log_every=2, checkpoint_every=0,
               early_stop_patience=1, learning_rate=0.5, warmup_steps=0)
    state, _ = _run(cfg, tmp_path, "es")
    assert state.step <= 8
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in state.model.parameters())


# ---------------------------------------------------------------------------
# Against the JAX loop.
# ---------------------------------------------------------------------------

def test_cache_device_loop_matches_jax_loop(tmp_path, monkeypatch):
    """Same initial params, the same pool order, the smoke preset: the
    logged losses agree within rtol 2e-2."""
    over = dict(log_every=1, checkpoint_every=0, learning_rate=1e-2)
    jcfg = _cfg(jget_config, tmp_path, "jax", **over)
    tcfg = _cfg(get_config, tmp_path, "port", **over)
    params = jstep.init_params(jreg.build(jcfg.model), jcfg.data.input_hw,
                               seed=jcfg.train.seed)
    sd = convert.to_state_dict(jax.tree.map(np.asarray, params))
    create = tloop.create_state

    def create_from_jax_params(cfg, device=None):
        state = create(cfg, device)
        state.model.load_state_dict(sd)
        return state

    monkeypatch.setattr(tloop, "create_state", create_from_jax_params)
    mesh = meshlib.create_mesh([jax.devices("cpu")[0]])
    jloop.train(jcfg, workdir=str(tmp_path / "jax" / "w"), mesh=mesh,
                progress=False)
    _run(tcfg, tmp_path, "port")
    want = [r["loss"] for r in _rows(tmp_path, "jax") if "loss" in r]
    got = [r["loss"] for r in _rows(tmp_path, "port") if "loss" in r]
    assert len(want) == len(got) == 8
    np.testing.assert_allclose(got, want, rtol=2e-2)


@pytest.mark.parametrize("data,train", [
    ({"use_grain": True}, {}),
    ({"datasets": ("synthetic", "synthetic")}, {}),
    ({"cache_device": False, "cache_window_mb": 4}, {}),
    ({"cache_window_mb": -1}, {}),
    ({"window_epochs": 2}, {}),
    ({"cache_window_mb": 1, "window_epochs": -1}, {}),
    ({"cache_device": False}, {"steps_per_dispatch": 4}),
    ({}, {"steps_per_dispatch": 4, "log_every": 6}),
    ({}, {"steps_per_dispatch": 3, "checkpoint_every": 8,
          "eval_every": 5}),
    ({}, {"steps_per_dispatch": 0}),
])
def test_validation_errors_equal_jax(tmp_path, data, train):
    jcfg = _cfg(jget_config, tmp_path, "j", data, **train)
    tcfg = _cfg(get_config, tmp_path, "t", data, **train)
    with pytest.raises(ValueError) as want:
        jloop.train(jcfg, workdir=str(tmp_path / "j"), progress=False)
    with pytest.raises(ValueError) as got:
        tloop.train(tcfg, workdir=str(tmp_path / "t"), progress=False,
                    device="cpu")
    assert str(got.value) == str(want.value)


def test_unaligned_resume_raises_the_jax_message(tmp_path):
    """A K=1 checkpoint at step 3, resumed with K=4 to step 8, leaves 5
    steps: both loops refuse with the same message."""
    msgs = []
    for get, train, sub in ((jget_config, jloop.train, "j"),
                            (get_config, tloop.train, "t")):
        kw = {} if sub == "j" else {"device": "cpu"}
        cfg = _cfg(get, tmp_path, sub, steps=3, checkpoint_every=3)
        train(cfg, workdir=str(tmp_path / sub / "w"), progress=False, **kw)
        resumed = _cfg(get, tmp_path, sub, steps_per_dispatch=4,
                       resume=True)
        with pytest.raises(ValueError) as e:
            train(resumed, workdir=str(tmp_path / sub / "w"),
                  progress=False, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("resume step 3 leaves 5 steps")


# ---------------------------------------------------------------------------
# The window pool in the loop (tests/test_streaming_pool.py:186-376).
# ---------------------------------------------------------------------------

def _window_cfg(tmp_path, sub, **train):
    return _cfg(get_config, tmp_path, sub,
                {"synth_img_hw": (96, 128), "synth_depth_hw": (48, 64),
                 "cache_window_mb": 1, "window_epochs": 0}, **train)


def test_window_epochs_auto_persists_and_resumes(tmp_path, monkeypatch):
    ds = SyntheticDepthDataset(n=64, img_hw=(96, 128), depth_hw=(48, 64))
    cfg = _window_cfg(tmp_path, "w", checkpoint_every=4)
    _run(cfg, tmp_path, "w", dataset=ds)
    sidecar = os.path.join(cfg.train.ckpt_dir, "window_epochs.json")
    rec = json.load(open(sidecar))
    assert rec["window_epochs"] >= 1 and rec["cache_window_mb"] == 1
    json.dump({"window_epochs": 3, "cache_window_mb": 1,
               "calibrated_at_step": 0}, open(sidecar, "w"))

    def boom(*a, **k):
        raise AssertionError("a resumed auto run must not recalibrate")

    seen = {}
    real = tsp.StreamingPoolSampler

    def spy(*a, **k):
        seen["window_epochs"] = k.get("window_epochs")
        return real(*a, **k)

    monkeypatch.setattr(tsp, "calibrate_window_epochs", boom)
    monkeypatch.setattr(tsp, "StreamingPoolSampler", spy)
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=16, resume=True))
    state, _ = _run(cfg2, tmp_path, "w", dataset=ds)
    assert state.step == 16 and seen["window_epochs"] == 3
    # an explicit factor conflicting with the persisted one still wins
    cfg3 = dataclasses.replace(
        cfg2, data=dataclasses.replace(cfg2.data, window_epochs=2),
        train=dataclasses.replace(cfg2.train, steps=24))
    _run(cfg3, tmp_path, "w", dataset=ds)
    assert seen["window_epochs"] == 2


def test_window_epochs_sidecar_stale_on_window_change(tmp_path,
                                                      monkeypatch):
    ds = SyntheticDepthDataset(n=64, img_hw=(96, 128), depth_hw=(48, 64))
    cfg = _window_cfg(tmp_path, "s", checkpoint_every=4)
    _run(cfg, tmp_path, "s", dataset=ds)
    sidecar = os.path.join(cfg.train.ckpt_dir, "window_epochs.json")
    json.dump({"window_epochs": 7, "cache_window_mb": 2,
               "calibrated_at_step": 0}, open(sidecar, "w"))
    called = {"n": 0}
    real = tsp.calibrate_window_epochs

    def spy(*a, **k):
        called["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tsp, "calibrate_window_epochs", spy)
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=16, resume=True))
    _run(cfg2, tmp_path, "s", dataset=ds)
    assert called["n"] == 1
    assert json.load(open(sidecar))["cache_window_mb"] == 1


# ---------------------------------------------------------------------------
# Host feeds: DeviceFeed and the worker loader.
# ---------------------------------------------------------------------------

def test_host_fed_loop_goes_through_device_feed(tmp_path, monkeypatch):
    from ann3depth_tpu_torch.pipeline import feed as feedlib

    made = []
    real = feedlib.DeviceFeed

    def spy(*a, **k):
        made.append(k.get("prefetch"))
        return real(*a, **k)

    monkeypatch.setattr(feedlib, "DeviceFeed", spy)
    cfg = _cfg(get_config, tmp_path, "h", {"cache_device": False})
    state, m = _run(cfg, tmp_path, "h")
    assert made == [2] and state.step == 8 and np.isfinite(m["loss"])


@pytest.mark.parametrize("datasets,workers", [
    (("synthetic",), 0), (("synthetic", "synthetic"), 2)])
def test_worker_loader_loop_trains(tmp_path, datasets, workers):
    """Mirrors tests/test_grain_loader.py:47 and :72."""
    cfg = _cfg(get_config, tmp_path, "g", {
        "cache_device": False, "use_grain": True, "num_workers": workers,
        "datasets": datasets})
    state, m = _run(cfg, tmp_path, "g")
    assert state.step == 8 and np.isfinite(m["loss"])


def test_cli_trains_with_the_pipeline_flags(tmp_path, capsys):
    base = ["train", "--config", "smoke", "--device", "cpu", "--datasets",
            "synthetic", "--synth-n", "32", "--synth-hw", "96", "128",
            "--synth-depth-hw", "48", "64", "--batch-size", "8",
            "--steps", "8", "--log-every", "4", "--checkpoint-every", "8"]
    args = cli.build_parser().parse_args(
        base + ["--cache-device", "--cache-window-mb", "1",
                "--window-epochs", "auto", "--steps-per-dispatch", "2"])
    cfg = cli.resolve_config(args)
    assert (cfg.data.cache_device, cfg.data.cache_window_mb,
            cfg.data.window_epochs, cfg.train.steps_per_dispatch) == (
        True, 1, 0, 2)
    assert cli.main(base + ["--ckpt-dir", str(tmp_path / "c"),
                            "--cache-device", "--steps-per-dispatch",
                            "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(line["loss"])
    assert cli.main(base + ["--ckpt-dir", str(tmp_path / "g"),
                            "--use-grain", "--num-workers", "1"]) == 0


# ---------------------------------------------------------------------------
# Eval from a device pool.
# ---------------------------------------------------------------------------

def test_eval_cache_device_equals_host_eval(tmp_path):
    """`eval --cache-device` stages its own pool: the same examples in
    the same order as the host feed, so the same metrics
    (tests/test_device_cache.py:178)."""
    cfg = _cfg(get_config, tmp_path, "e", {"cache_device": False},
               batch_size=4)
    state = tloop.create_state(cfg, torch.device("cpu"))
    ds = SyntheticDepthDataset(n=14, img_hw=(16, 16), depth_hw=(8, 8))
    host = tloop.evaluate(cfg, state=state, dataset=ds)
    cd = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, cache_device=True))
    assert tloop.evaluate(cd, state=state, dataset=ds) == host
    assert tloop.evaluate(cd, state=state, dataset=ds, max_batches=2) == \
        tloop.evaluate(cfg, state=state, dataset=ds, max_batches=2)
    with pytest.raises(ValueError, match="fixed pool sample"):
        tloop.evaluate(cfg, state=state, dataset=ds, report_dir="x",
                       device_batches=[])


def test_protocols_share_one_staged_pool(tmp_path, monkeypatch):
    cfg = _cfg(get_config, tmp_path, "p", batch_size=4)
    state = tloop.create_state(cfg, torch.device("cpu"))
    made = []
    real = tdc.DevicePoolSampler

    def spy(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tdc, "DevicePoolSampler", spy)
    got = tloop.evaluate_protocols(cfg, ["plain", "tta+align"],
                                   state=state, max_batches=2)
    assert len(made) == 1
    host = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, cache_device=False))
    assert got["plain"] == tloop.evaluate(host, state=state, max_batches=2)
    assert got["tta+align"] == tloop.evaluate(
        host, state=state, max_batches=2, tta="flip", align="median")


# ---------------------------------------------------------------------------
# What the captured step reads.
# ---------------------------------------------------------------------------

def test_step_inputs_copy_nothing_from_the_host():
    """identity rows and n_images come from device-side fills now; their
    values are those of the host-built tensors."""
    for in_hw, out_hw in (((480, 640), (240, 320)), ((305, 55), (120, 160))):
        want = torch.tensor([0.0, in_hw[0] / out_hw[0], 0.0,
                             in_hw[1] / out_hw[1], 1.0, 0.0, 1.0, 0.0],
                            dtype=torch.float32)[None].repeat(3, 1)
        assert torch.equal(fp.identity_params(3, in_hw, out_hw), want)
    stats = tlosses.depth_metric_stats(torch.zeros(5, 4, 4, 1),
                                       torch.ones(5, 4, 4), si_lambda=0.5)
    assert stats["n_images"].dtype == torch.float32
    assert float(stats["n_images"]) == 5.0


def test_lr_from_a_tensor_equals_the_schedule(tmp_path):
    """A step handed the learning rate as a tensor updates exactly as one
    that reads schedule(step)."""
    cfg = _cfg(get_config, tmp_path, "lr", warmup_steps=3)
    a = tloop.create_state(cfg, torch.device("cpu"))
    b = tloop.create_state(cfg, torch.device("cpu"))
    ds = SyntheticDepthDataset(n=8, img_hw=(16, 16), depth_hw=(8, 8))
    img, dep = (torch.from_numpy(x) for x in next(ds.batches(8, steps=1)))
    kw = dict(input_hw=(32, 48), target_hw=tloop.resolved_target_hw(cfg))
    for step in range(3):
        tstep.train_step(a, img, dep, **kw)
        lr = torch.tensor([b.tx.schedule(step)], dtype=torch.float64)
        tstep.train_step(b, img, dep, lr=lr, **kw)
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


def test_optimizer_state_loads_keep_the_lr_holder(tmp_path):
    cfg = _cfg(get_config, tmp_path, "o")
    a = tloop.create_state(cfg, torch.device("cpu"))
    ds = SyntheticDepthDataset(n=8, img_hw=(16, 16), depth_hw=(8, 8))
    img, dep = (torch.from_numpy(x) for x in next(ds.batches(8, steps=1)))
    tstep.train_step(a, img, dep, input_hw=(32, 48),
                     target_hw=tloop.resolved_target_hw(cfg))
    saved = a.optimizer.state_dict()
    saved["param_groups"][0]["lr"] = torch.tensor(0.5)
    b = tloop.create_state(cfg, torch.device("cpu"))
    tstep.load_optimizer_state(b.optimizer, saved)
    group = b.optimizer.param_groups[0]
    assert isinstance(group["lr"], float) and group["capturable"] is False
    p, pa = group["params"][0], a.optimizer.param_groups[0]["params"][0]
    assert torch.equal(b.optimizer.state[p]["exp_avg"],
                       a.optimizer.state[pa]["exp_avg"])
    assert float(b.optimizer.state[p]["step"]) == 1.0
