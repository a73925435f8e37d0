"""The port's training extras against the JAX package's, on the CPU:
gradient accumulation, distillation, several datasets, the rollback
resume, early stopping, the best-eval checkpoint, TensorBoard and the
profiler window (ann3depth_tpu_torch/train/{step,loop}.py,
utils/{tb_writer,tracing}.py, cli.py `train`), and the decoder upsample of
encdec and multiscale.

Inputs come from a numpy seed; JAX params go to the port through
`convert.to_state_dict`. Sizes are small: encdec at width 0.25, the
`small` net, 32x48 or 48x64 inputs. Tolerances, as tests/test_torch_train.py
states them for one f32 step: loss, gt_loss, distill, rmse and grad_norm
1e-4 relative (f32 convs in another summation order), updated params 1e-5
absolute (a first Adam step is lr * g / (|g| + eps)). Under accumulation
the two sides also sum the microbatch gradients in another order, which
moves a gradient within ~eps of zero far enough to move its first Adam
step by more: there the params are held to 1e-5 on all but 1% of the
entries and to 2 lr (a flipped step) on every entry. The port's accum-2
step against its accum-1 step over 3 steps: loss and rmse 1e-5 relative,
grad_norm 1e-4, params 5e-4 relative and 2e-4 absolute, as
tests/test_grad_accum.py holds the JAX step. The multi-dataset loss curve
against the JAX loop: 2e-2 relative (the bf16 loop tolerance of
tests/test_torch_train_loop.py). The loop's behaviour mirrors
tests/test_train_integration.py, tests/test_grad_accum.py and
tests/test_distill.py, and it refuses what the JAX loop refuses.
"""

import dataclasses
import functools
import glob
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.config import ModelConfig as JModelConfig
from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert
from ann3depth_tpu_torch.config import ModelConfig, get_config
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep
from ann3depth_tpu_torch.train.checkpoint import CheckpointManager

LR = 1e-3
IN_HW, TARGET_HW = (32, 48), (16, 24)
RAW_HW, DEPTH_HW = (40, 56), (15, 11)
SMOKE_HW = (48, 64)  # the JAX loop tests' input size for the smoke preset


def _batch(seed=0, b=4, raw_hw=RAW_HW, depth_hw=DEPTH_HW):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, *raw_hw, 3), dtype=np.uint8)
    depth = rng.uniform(1.0, 60.0, (b, *depth_hw)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    return img, depth


@functools.lru_cache(maxsize=None)
def _jax_params(name, width_mult, seed):
    model = jreg.build(JModelConfig(name=name, width_mult=width_mult,
                                    compute_dtype="float32"))
    return jax.tree.map(np.asarray,
                        jstep.init_params(model, IN_HW if name != "small"
                                          else SMOKE_HW, seed=seed))


def _pair(name="encdec", width_mult=0.25, seed=0):
    """(JAX TrainState, port TrainState), f32, the same params and rule."""
    params = _jax_params(name, width_mult, seed)
    kw = dict(warmup_steps=0, total_steps=10)
    jm = jreg.build(JModelConfig(name=name, width_mult=width_mult,
                                 compute_dtype="float32"))
    js = jstep.TrainState.create(jm.apply, jax.tree.map(jnp.asarray, params),
                                 jstep.make_optimizer(LR, **kw))
    tm = registry.build(ModelConfig(name=name, width_mult=width_mult,
                                    compute_dtype="float32"))
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    return js, tstep.TrainState.create(tm, tstep.make_optimizer(LR, **kw))


def _params_np(state):
    return {k: v.detach().numpy() for k, v in state.model.state_dict().items()}


def _assert_params_close(js, ts, atol=1e-5, share=0.0):
    """Updated params within atol of the JAX step's on all but `share` of
    the entries, and within 2 LR (a flipped first Adam step) on all."""
    want = convert.to_state_dict(jax.tree.map(np.asarray, js.params))
    got = _params_np(ts)
    diff = np.concatenate([np.abs(got[k] - v.numpy()).ravel()
                           for k, v in want.items()])
    assert (diff > atol).mean() <= share, (diff > atol).mean()
    assert diff.max() <= 2 * LR + 1e-6


# ---------------------------------------------------------------------------
# The decoder upsample.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["encdec", "multiscale"])
def test_train_steps_call_no_interpolate(name, monkeypatch):
    """Every x2/x4 of encdec and multiscale is `ops.resize.upsample_matmul`
    (GEMMs, a fixed summation order in the backward), in the plain step and
    in the accumulated one."""
    import torch.nn.functional as F

    def refuse(*args, **kw):
        raise AssertionError("F.interpolate on the train path")

    monkeypatch.setattr(F, "interpolate", refuse)
    model = tstep.init_params(registry.build(ModelConfig(
        name=name, width_mult=0.25)), IN_HW, 0)
    state = tstep.TrainState.create(model, tstep.make_optimizer(LR))
    img, depth = _batch()
    for accum in (1, 2):
        _, m = tstep.train_step(state, torch.from_numpy(img),
                                torch.from_numpy(depth), input_hw=IN_HW,
                                target_hw=TARGET_HW, grad_accum=accum)
        assert torch.isfinite(m["loss"])


# ---------------------------------------------------------------------------
# Gradient accumulation.
# ---------------------------------------------------------------------------

def test_grad_accum_step_matches_jax():
    """One grad_accum=2 step of the port against JAX train_step(...,
    grad_accum=2), f32 compute, exact-f32 preprocess."""
    img, depth = _batch(seed=1)
    js, ts = _pair()
    js, jm = jstep.train_step(js, jnp.asarray(img), jnp.asarray(depth),
                              jax.random.key(0), input_hw=IN_HW,
                              target_hw=TARGET_HW, use_pallas=False,
                              resize_precision="highest", emit_s2d=0,
                              grad_accum=2)
    ts, tm = tstep.train_step(ts, torch.from_numpy(img),
                              torch.from_numpy(depth), input_hw=IN_HW,
                              target_hw=TARGET_HW, grad_accum=2)
    assert ts.step == int(js.step) == 1
    for k in ("loss", "rmse", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    _assert_params_close(js, ts, share=0.01)


def test_microbatch_split_is_strided():
    x = torch.arange(12).reshape(12, 1)
    out = tstep._to_microbatches(x, 3)
    assert [m[:, 0].tolist() for m in out] == [[0, 3, 6, 9], [1, 4, 7, 10],
                                               [2, 5, 8, 11]]
    assert all(m.is_contiguous() for m in out)


def test_grad_accum_matches_full_batch():
    """Mirrors tests/test_grad_accum.py:39 on the port: 3 steps at accum 2
    equal 3 full-batch steps in params and metrics."""
    img, depth = _batch(seed=2)
    _, a = _pair()
    _, b = _pair()
    for _ in range(3):
        a, ma = tstep.train_step(a, torch.from_numpy(img),
                                 torch.from_numpy(depth), input_hw=IN_HW,
                                 target_hw=TARGET_HW)
        b, mb = tstep.train_step(b, torch.from_numpy(img),
                                 torch.from_numpy(depth), input_hw=IN_HW,
                                 target_hw=TARGET_HW, grad_accum=2)
    assert float(mb["loss"]) == pytest.approx(float(ma["loss"]), rel=1e-5)
    assert float(mb["rmse"]) == pytest.approx(float(ma["rmse"]), rel=1e-5)
    assert float(mb["grad_norm"]) == pytest.approx(float(ma["grad_norm"]),
                                                   rel=1e-4)
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=5e-4,
                                   atol=2e-4, err_msg=k)


def test_grad_accum_augment_takes_a_draw_per_microbatch():
    """With augment, microbatch j is preprocessed with the j-th draw of the
    step's generator: the step equals the same microbatches fed by hand."""
    from ann3depth_tpu_torch.pipeline import preprocess

    img, depth = _batch(seed=3)
    _, a = _pair()
    _, b = _pair()
    kw = dict(input_hw=IN_HW, target_hw=TARGET_HW)
    a, ma = tstep.train_step(a, torch.from_numpy(img),
                             torch.from_numpy(depth),
                             torch.Generator().manual_seed(4), augment=True,
                             grad_accum=2, **kw)
    gen = torch.Generator().manual_seed(4)
    b.optimizer.zero_grad(set_to_none=True)
    total = 0.0
    for j in range(2):
        images, depths = preprocess.preprocess_batch(
            torch.from_numpy(img[j::2]), torch.from_numpy(depth[j::2]),
            generator=gen, **kw)
        loss, _ = tstep.loss_fn(b.model, images, depths, 0.5)
        (loss / 2).backward()
        total += float(loss.detach()) / 2
    b.tx.apply(b.optimizer, 0)
    assert float(ma["loss"]) == pytest.approx(total, rel=1e-5)
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_grad_accum_rejects_indivisible_batch():
    """Mirrors tests/test_grad_accum.py:99."""
    img, depth = _batch(b=6)
    _, ts = _pair()
    with pytest.raises(ValueError, match="not divisible"):
        tstep.train_step(ts, torch.from_numpy(img), torch.from_numpy(depth),
                         input_hw=IN_HW, target_hw=TARGET_HW, grad_accum=4)


# ---------------------------------------------------------------------------
# Distillation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [((24, 32), (6, 8)),
                                          ((6, 8), (24, 32)),
                                          ((15, 11), (16, 24))])
def test_teacher_resize_is_jax_bilinear(in_hw, out_hw):
    """The teacher map's resize (`resample_2d` with the batch carried as
    channels) is jax.image.resize(..., "bilinear") with its antialiasing:
    x4 down, x4 up and a non-integer ratio."""
    from ann3depth_tpu_torch.ops import resize

    x = np.random.default_rng(0).normal(size=(2, *in_hw)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out_hw), "bilinear")
    got = resize.resample_2d(torch.from_numpy(x).permute(1, 2, 0),
                             out_hw).permute(2, 0, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_distill_step_matches_jax():
    """An encdec teacher (stride /2) into the `small` student (stride /8):
    the teacher map takes the antialiased x4 downsample."""
    tparams = jax.tree.map(np.asarray, jstep.init_params(
        jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32),
        SMOKE_HW, seed=7))
    jteacher = jenc.EncDecDepthNet(width_mult=0.25,
                                   compute_dtype=jnp.float32)
    teacher = registry.build(ModelConfig(name="encdec", width_mult=0.25,
                                         compute_dtype="float32"))
    teacher.load_state_dict(convert.to_state_dict(tparams), strict=True)
    teacher.eval().requires_grad_(False)
    target_hw = registry.output_hw("small", SMOKE_HW)
    assert target_hw == (6, 8) != registry.output_hw("encdec", SMOKE_HW)
    img, depth = _batch(seed=5, b=2, raw_hw=(56, 72), depth_hw=(28, 36))
    js, ts = _pair("small", 1.0)
    js, jm = jstep.distill_train_step(
        js, jax.tree.map(jnp.asarray, tparams), jnp.asarray(img),
        jnp.asarray(depth), jax.random.key(0), teacher_apply=jteacher.apply,
        input_hw=SMOKE_HW, target_hw=target_hw, resize_precision="highest",
        distill_alpha=0.3)
    ts, tm = tstep.distill_train_step(
        ts, teacher, torch.from_numpy(img), torch.from_numpy(depth),
        input_hw=SMOKE_HW, target_hw=target_hw, distill_alpha=0.3)
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "gt_loss", "distill", "rmse", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    _assert_params_close(js, ts)
    assert not any(p.grad is not None for p in teacher.parameters())


# ---------------------------------------------------------------------------
# The loop.
# ---------------------------------------------------------------------------

def _smoke(tmp_path, data=None, **train):
    """The smoke preset (the `small` net, f32, synthetic) at the JAX loop
    tests' 48x64 input, with its checkpoints under tmp_path/ckpt."""
    cfg = get_config("smoke")
    train.setdefault("ckpt_dir", str(tmp_path / "ckpt"))
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=SMOKE_HW,
                                      **(data or {})),
        train=dataclasses.replace(cfg.train, **train))


def _records(workdir, key):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [(r["step"], r[key]) for r in map(json.loads, f) if key in r]


def _train(cfg, workdir):
    return tloop.train(cfg, workdir=str(workdir), progress=False,
                       device="cpu")


def test_multi_dataset_training_interleaves(tmp_path):
    """Mirrors tests/test_train_integration.py:107: both sources train,
    batch by batch, with the feed of the copied interleave_batches."""
    from ann3depth_tpu_torch.data import batching
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset

    cfg = _smoke(tmp_path, data=dict(datasets=("synthetic", "synthetic")),
                 steps=4, batch_size=2, log_every=2, checkpoint_every=100,
                 warmup_steps=0)
    seen = []
    inner = tstep.train_step

    def recording(state, img, depth, *a, **kw):
        seen.append(img.numpy().copy())
        return inner(state, img, depth, *a, **kw)

    tstep.train_step = recording
    try:
        state, metrics = _train(cfg, tmp_path)
    finally:
        tstep.train_step = inner
    assert state.step == 4 and np.isfinite(metrics["loss"])
    ds = SyntheticDepthDataset(n=cfg.data.synth_n,
                               img_hw=cfg.data.synth_img_hw,
                               depth_hw=cfg.data.synth_depth_hw)
    want = [b[0] for b in batching.interleave_batches([ds, ds], 2, steps=4,
                                                      seed=0)]
    assert len(seen) == 4
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


def _nyu_fixture(root, n=8, hw=(16, 20)):
    import h5py

    rng = np.random.default_rng(0)
    (root / "nyu").mkdir(parents=True)
    with h5py.File(root / "nyu" / "nyu_depth_v2_labeled.mat", "w") as f:
        f.create_dataset("images", data=rng.integers(
            0, 256, (n, 3, hw[1], hw[0]), dtype=np.uint8))
        f.create_dataset("depths", data=rng.uniform(
            0.5, 10.0, (n, hw[1], hw[0])).astype(np.float32))
    return root


def test_multi_dataset_loss_curve_matches_jax_loop(tmp_path, monkeypatch):
    """Synthetic scenes and an NYU fixture, batch-interleaved, from the same
    initial params: the two loops log the same 5-step loss curve."""
    data = dict(datasets=("synthetic", "nyu"), input_hw=IN_HW,
                data_dir=str(_nyu_fixture(tmp_path / "data")),
                synth_img_hw=RAW_HW, synth_depth_hw=DEPTH_HW, synth_n=8,
                synth_test_n=4)

    def cfg(get, tag):
        c = get("make3d-encdec")
        return dataclasses.replace(
            c, data=dataclasses.replace(c.data, **data),
            model=dataclasses.replace(c.model, width_mult=0.25),
            train=dataclasses.replace(
                c.train, batch_size=2, steps=5, log_every=1,
                checkpoint_every=0, eval_every=0, learning_rate=1e-2,
                ckpt_dir=str(tmp_path / tag / "ckpt")))

    jcfg, tcfg = cfg(jget_config, "jax"), cfg(get_config, "port")
    params = jstep.init_params(jreg.build(jcfg.model), jcfg.data.input_hw,
                               seed=jcfg.train.seed)
    sd = convert.to_state_dict(jax.tree.map(np.asarray, params))
    create = tloop.create_state

    def create_from_jax_params(c, device=None):
        state = create(c, device)
        state.model.load_state_dict(sd)
        return state

    monkeypatch.setattr(tloop, "create_state", create_from_jax_params)
    jloop.train(jcfg, workdir=str(tmp_path / "jax"), progress=False)
    _train(tcfg, tmp_path / "port")
    want = [v for _, v in _records(tmp_path / "jax", "loss")]
    got = [v for _, v in _records(tmp_path / "port", "loss")]
    assert len(want) == len(got) == 5
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_resume_step_rolls_back(tmp_path):
    """Mirrors tests/test_train_integration.py:148."""
    def cfg(**kw):
        return _smoke(tmp_path, batch_size=2, eval_every=0, log_every=100,
                      checkpoint_every=2, **kw)

    _train(cfg(steps=6), tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [2, 4, 6]
    state, _ = _train(cfg(steps=8, resume_step=4), tmp_path)
    assert state.step == 8
    # 6 was deleted at the rollback; the continued timeline saved 6 and 8
    assert mgr.all_steps() == [4, 6, 8]
    assert [s for s, _ in _records(tmp_path, "loss")] == [6, 8]
    with pytest.raises(ValueError, match="no checkpoint at step 5"):
        _train(cfg(steps=8, resume_step=5), tmp_path)


def test_early_stopping_halts_on_stale_eval(tmp_path):
    """Mirrors tests/test_train_integration.py:208."""
    cfg = _smoke(tmp_path, steps=10, batch_size=2, eval_every=1,
                 early_stop_patience=1, early_stop_min_delta=1e9,
                 checkpoint_every=100, log_every=100)
    state, _ = _train(cfg, tmp_path)
    assert state.step == 2
    assert CheckpointManager(cfg.train.ckpt_dir).all_steps() == [2]


def test_early_stopping_restores_best_weights(tmp_path):
    """Mirrors tests/test_train_integration.py:231: the stop-step checkpoint
    holds the best eval's params (step 1), not the stale step 2's."""
    cfg = _smoke(tmp_path, steps=10, batch_size=2, eval_every=1,
                 early_stop_patience=1, early_stop_min_delta=1e9,
                 checkpoint_every=1, log_every=100, warmup_steps=0,
                 learning_rate=1e-2)
    state, _ = _train(cfg, tmp_path)
    assert state.step == 2
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    best, _ = ckpt.restore_params(tloop.create_state(cfg, "cpu"), step=1)
    stop, _ = ckpt.restore_params(tloop.create_state(cfg, "cpu"), step=2)
    for (k, a), b, c in zip(best.model.state_dict().items(),
                            stop.model.state_dict().values(),
                            state.model.state_dict().values()):
        assert torch.equal(b, a) and torch.equal(c, a), k
    # training did move the params: the equality is not an idle run's
    fresh = tloop.create_state(cfg, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(
        fresh.model.state_dict().values(), best.model.state_dict().values()))


def test_save_best_keeps_best_eval_checkpoint(tmp_path):
    """Mirrors tests/test_train_integration.py:384."""
    cfg = _smoke(tmp_path, steps=6, batch_size=2, eval_every=2,
                 save_best=True, checkpoint_every=6, log_every=100,
                 learning_rate=3e-3)
    _train(cfg, tmp_path)
    with open(tmp_path / "ckpt" / "best_metric.json") as f:
        best = json.load(f)
    evals = _records(tmp_path, "eval_rmse")
    assert len(evals) == 3
    min_step, min_rmse = min(evals, key=lambda e: e[1])
    assert best["step"] == min_step and abs(best["rmse"] - min_rmse) < 1e-9
    slot = CheckpointManager(str(tmp_path / "ckpt" / "best"))
    assert slot.all_steps() == [best["step"]]
    _, step = slot.restore_params(tloop.create_state(cfg, "cpu"))
    assert step == best["step"]


def test_save_best_respects_prior_metric_on_resume(tmp_path):
    """Mirrors tests/test_train_integration.py:430."""
    (tmp_path / "ckpt").mkdir()
    prior = {"rmse": 0.0, "step": 999}
    with open(tmp_path / "ckpt" / "best_metric.json", "w") as f:
        json.dump(prior, f)
    cfg = _smoke(tmp_path, steps=4, batch_size=2, eval_every=2,
                 save_best=True, checkpoint_every=4, log_every=100)
    _train(cfg, tmp_path)
    with open(tmp_path / "ckpt" / "best_metric.json") as f:
        assert json.load(f) == prior
    assert CheckpointManager(str(tmp_path / "ckpt" / "best")).all_steps() \
        == []


def test_profile_window_emits_trace(tmp_path):
    """Mirrors tests/test_train_integration.py:334: a window of
    profile_steps steps after the warm steps lands in a trace file."""
    cfg = _smoke(tmp_path, steps=8, batch_size=2, checkpoint_every=100,
                 log_every=100, warmup_steps=0,
                 profile_dir=str(tmp_path / "trace"), profile_steps=2)
    _train(cfg, tmp_path)
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "aten::convolution" for e in events) >= 2


def test_profile_window_left_open_is_closed(tmp_path):
    """A run that stops inside the window (here at a non-finite loss)
    still writes its trace."""
    cfg = _smoke(tmp_path, steps=40, batch_size=2, log_every=7,
                 checkpoint_every=1000, warmup_steps=0, learning_rate=1e18,
                 profile_dir=str(tmp_path / "trace"), profile_steps=30)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _train(cfg, tmp_path)
    assert len(glob.glob(str(tmp_path / "trace" / "*.json"))) == 1


def test_tensorboard_scalars_and_grids(tmp_path):
    """The loop writes its log and eval scalars and the eval grid under
    <workdir>/tb, at the JAX loop's points."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    cfg = _smoke(tmp_path, steps=4, batch_size=2, eval_every=2,
                 log_every=2, checkpoint_every=100, tensorboard=True)
    _train(cfg, tmp_path)
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = acc.Tags()
    assert {"loss", "rmse", "grad_norm", "images_per_sec", "eval/rmse",
            "eval/delta1"} <= set(tags["scalars"])
    assert [e.step for e in acc.Scalars("loss")] == [2, 4]
    assert [e.step for e in acc.Scalars("eval/rmse")] == [2, 4]
    assert tags["images"] == ["triples"]


def test_tensorboard_writer_noops_without_the_package(tmp_path, monkeypatch,
                                                      caplog):
    import builtins

    from ann3depth_tpu_torch.utils import tb_writer

    real = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with caplog.at_level(logging.WARNING, logger=tb_writer.__name__):
        w = tb_writer.TensorBoardWriter(str(tmp_path / "tb"))
    assert any("tensorboard unavailable" in r.message for r in caplog.records)
    w.write_scalars(1, {"loss": 0.5})
    w.write_image(1, "img", np.zeros((8, 8, 3), np.uint8))
    w.close()
    assert not (tmp_path / "tb").exists()


def test_loop_trains_with_grad_accum(tmp_path):
    """Mirrors tests/test_grad_accum.py:116, with augmentation on."""
    cfg = _smoke(tmp_path, data=dict(augment=True), batch_size=4,
                 grad_accum=2, steps=3, checkpoint_every=3, log_every=1)
    state, metrics = _train(cfg, tmp_path)
    assert state.step == 3 and np.isfinite(metrics["loss"])


def test_distill_loop_end_to_end(tmp_path):
    """Mirrors tests/test_distill.py:108: a teacher trains and saves; a
    fresh student trains with distill_from pointing at it and logs the
    distill metrics."""
    teacher = _smoke(tmp_path, steps=4, batch_size=2, checkpoint_every=4,
                     log_every=2, warmup_steps=0,
                     ckpt_dir=str(tmp_path / "teacher"))
    _train(teacher, tmp_path / "tw")
    student = _smoke(tmp_path, steps=4, batch_size=2, checkpoint_every=4,
                     log_every=2, warmup_steps=0,
                     ckpt_dir=str(tmp_path / "student"),
                     distill_from=str(tmp_path / "teacher"),
                     distill_alpha=0.5)
    state, metrics = _train(student, tmp_path / "sw")
    assert state.step == 4
    for k in ("distill", "gt_loss"):
        assert k in metrics and np.isfinite(metrics[k])
    with open(tmp_path / "sw" / "metrics.jsonl") as f:
        last = [json.loads(line) for line in f][-1]
    assert "distill" in last and "gt_loss" in last


def test_restore_teacher_builds_the_distill_model(tmp_path):
    """An encdec teacher (--distill-model, --distill-width-mult) of a
    `small` student: frozen, in eval mode, with the saved params."""
    enc = _smoke(tmp_path, steps=1, batch_size=2, checkpoint_every=1,
                 log_every=1, ckpt_dir=str(tmp_path / "t"))
    enc = dataclasses.replace(enc, model=dataclasses.replace(
        enc.model, name="encdec", width_mult=0.25))
    state, _ = _train(enc, tmp_path / "tw")
    student = _smoke(tmp_path, distill_from=str(tmp_path / "t"),
                     distill_model="encdec", distill_width_mult=0.25)
    teacher = tloop.restore_teacher(student, torch.device("cpu"))
    assert not teacher.training
    for (k, a), b in zip(teacher.state_dict().items(),
                         state.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert not any(p.requires_grad for p in teacher.parameters())


REFUSALS = {  # case -> (train overrides, error, message)
    "accum_does_not_divide_the_batch": (
        dict(batch_size=3, grad_accum=2), ValueError, "not divisible"),
    "accum_below_one": (dict(grad_accum=0), ValueError,
                        "grad_accum must be >= 1"),
    "early_stop_without_eval": (dict(early_stop_patience=2, eval_every=0),
                                ValueError, "eval_every"),
    "save_best_without_eval": (dict(save_best=True, eval_every=0),
                               ValueError, "save_best"),
    "negative_patience": (dict(early_stop_patience=-1), ValueError,
                          "early_stop_patience must be >= 0"),
    "distill_with_accum": (dict(distill_from="T", grad_accum=2,
                                batch_size=4), ValueError,
                           "distill_from composes"),
    "distill_with_zero1": (dict(distill_from="T", zero1=True), ValueError,
                           "distill_from composes"),
    "distill_with_tp": (dict(distill_from="T", tensor_parallel=2),
                        ValueError, "distill_from composes"),
    "tp_below_one": (dict(tensor_parallel=0), ValueError,
                     "tensor_parallel must be >= 1"),
    "tp_on_a_non_dpt_model": (dict(tensor_parallel=2), ValueError,
                              "requires a dpt-family model"),
    "distill_alpha_zero": (dict(distill_from="T", distill_alpha=0.0),
                           ValueError, "distill_alpha"),
    "distill_alpha_above_one": (dict(distill_from="T", distill_alpha=1.5),
                                ValueError, "distill_alpha"),
    "missing_teacher_checkpoint": (dict(distill_from="T"), RuntimeError,
                                   "no teacher checkpoint"),
    "resume_step_without_that_checkpoint": (dict(resume_step=5), ValueError,
                                            "no checkpoint at step 5"),
    "distill_model_without_distill_from": (
        ["--distill-model", "encdec"], SystemExit, "distill-from"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_loop_refuses_what_the_jax_loop_refuses(tmp_path, case):
    """The JAX loop's checks of the options this slice ports: both packages
    refuse each case with the same error."""
    from ann3depth_tpu import cli as jcli

    over, error, match = REFUSALS[case]
    if isinstance(over, list):  # a CLI case
        argv = ["train", "--config", "smoke", "--steps", "1",
                "--ckpt-dir", str(tmp_path / "c")] + over
        for main in (jcli.main, lambda a: cli.main(a + ["--device", "cpu"])):
            with pytest.raises(error, match=match):
                main(argv)
        return
    if over.get("distill_from") == "T":
        over = dict(over, distill_from=str(tmp_path / "teacher"))
    kw = dict(steps=2, batch_size=2, eval_every=2, log_every=1,
              ckpt_dir=str(tmp_path / "c"))
    kw.update(over)
    for get, train in ((jget_config, lambda c: jloop.train(
            c, workdir=str(tmp_path / "j"), progress=False)),
                       (get_config, lambda c: _train(c, tmp_path / "t"))):
        base = get("smoke")
        cfg = dataclasses.replace(
            base, data=dataclasses.replace(base.data, input_hw=SMOKE_HW),
            train=dataclasses.replace(base.train, **kw))
        with pytest.raises(error, match=match):
            train(cfg)


def test_cli_resolves_the_slice_flags():
    """Mirrors tests/test_distill.py:158 and
    tests/test_train_integration.py:280."""
    args = cli.build_parser().parse_args(
        ["train", "--config", "smoke", "--distill-from", "/t/ckpt",
         "--distill-model", "encdec", "--distill-width-mult", "2.0",
         "--distill-alpha", "0.3", "--eval-every", "3",
         "--early-stop-patience", "2", "--early-stop-min-delta", "0.01",
         "--grad-accum", "2", "--save-best", "--resume-step", "4",
         "--tensorboard", "--profile", "/p", "--profile-steps", "3",
         "--datasets", "nyu", "make3d"])
    t = cli.resolve_config(args).train
    assert (t.distill_from, t.distill_model, t.distill_width_mult,
            t.distill_alpha) == ("/t/ckpt", "encdec", 2.0, 0.3)
    assert (t.eval_every, t.early_stop_patience, t.early_stop_min_delta,
            t.grad_accum, t.save_best, t.resume_step, t.tensorboard,
            t.profile_dir, t.profile_steps) == (3, 2, 0.01, 2, True, 4,
                                                True, "/p", 3)
    assert cli.resolve_config(args).data.datasets == ("nyu", "make3d")


def test_cli_train_with_the_slice_flags(tmp_path, capsys):
    """`cli train` with every option of the slice, then a rollback."""
    base = ["train", "--config", "smoke", "--batch-size", "4",
            "--ckpt-dir", str(tmp_path / "c"), "--workdir", str(tmp_path),
            "--device", "cpu", "--checkpoint-every", "2"]
    assert cli.main(base + [
        "--steps", "6", "--datasets", "synthetic", "synthetic",
        "--grad-accum", "2", "--eval-every", "2", "--early-stop-patience",
        "5", "--save-best", "--tensorboard", "--profile",
        str(tmp_path / "p"), "--profile-steps", "2"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["loss"])
    assert (tmp_path / "c" / "best_metric.json").exists()
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert len(glob.glob(str(tmp_path / "p" / "*.json"))) == 1
    assert cli.main(base + ["--steps", "3", "--resume-step", "2"]) == 0
    assert CheckpointManager(str(tmp_path / "c")).all_steps() == [2, 3]
