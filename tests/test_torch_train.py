"""Parity of the port's train and eval steps (ann3depth_tpu_torch/train/
step.py) with the JAX package's, on the CPU.

Inputs come from a numpy seed; JAX params go to the port through
`convert.to_state_dict`. Sizes are small: encdec at width_mult 0.25 (its
widths' floor of 32), input 32x48, raw frames 40x56, raw depth 15x11.

The JAX reference for exact parity is `train_step(..., use_pallas=False,
resize_precision="highest", emit_s2d=0)`: exact-f32 preprocess, and the
model's input stays f32 (emit_s2d would hand it bf16). Tolerances:

- schedule: 1e-6 of the peak rate (optax computes in f32, the port in
  f64, and f32 cancels near the ends of the warmup and cosine ramps);
- optimizer updates over 5 steps: 1e-5 relative, 1e-6 absolute (f32
  rounding of the same elementwise rules);
- one train step in f32 compute: loss, rmse and grad_norm 1e-4 relative
  (f32 convs in another summation order); updated params 1e-5 absolute: the
  first Adam update is lr * g / (|g| + eps), which only a gradient within
  ~1e-9 of zero could move by more;
- the same in bf16 compute: activations round to bf16 (2^-8) after every
  conv, at different places on the two sides (tests/test_torch_encdec.py),
  so loss and rmse 2e-2 relative, grad_norm 5e-2, and the updated params
  lr/2 absolute on all but 1% of entries (an entry whose gradient is near
  zero may take the other sign of the first Adam step);
- eval statistics with crop and median alignment in f32: 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.models import encdec as tenc
from ann3depth_tpu_torch.train import step as tstep

IN_HW, TARGET_HW = (32, 48), (16, 24)
RAW_HW, DEPTH_HW = (40, 56), (15, 11)
LR = 1e-3


# ---------------------------------------------------------------------------
# Schedule and update rule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(warmup_steps=10, total_steps=50),
    dict(warmup_steps=0, total_steps=50),
    dict(warmup_steps=60, total_steps=50),
    dict(warmup_steps=5, total_steps=None),
    dict(warmup_steps=5, total_steps=50, schedule="constant"),
    dict(warmup_steps=0, total_steps=50, schedule="constant"),
])
def test_schedule_matches_optax(kw):
    want = jstep.make_schedule(3e-4, **kw)
    got = tstep.make_schedule(3e-4, **kw)
    for count in range(0, 80):
        w = float(want(count)) if callable(want) else float(want)
        assert got(count) == pytest.approx(w, rel=0, abs=1e-6 * 3e-4), count


def test_first_warmup_lr_is_zero():
    """optax counts from 0: with warmup the first update has lr 0."""
    assert tstep.make_schedule(1e-4, 100, 1000)(0) == 0.0
    assert float(jstep.make_schedule(1e-4, 100, 1000)(0)) == 0.0


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="unknown schedule"):
        tstep.make_schedule(1e-3, schedule="linear")
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstep.make_optimizer(1e-3, optimizer="lamb")
    with pytest.raises(ValueError, match="ignores weight decay"):
        tstep.make_optimizer(1e-3, optimizer="adam", weight_decay=1e-4)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("clip", ["active", "inactive", "off"])
@pytest.mark.parametrize("opt,wd", [("adamw", 1e-2), ("adamw", 0.0),
                                    ("adam", 0.0), ("sgd", 1e-2),
                                    ("sgd", 0.0)])
def test_five_updates_match_optax(opt, wd, clip):
    """5 updates with a warmup+cosine schedule, from the same params and
    gradients: the clip scales gradients of norm ~40 to 1 ("active"),
    leaves gradients of norm ~0.4 alone ("inactive"), or is off."""
    kw = dict(warmup_steps=2, total_steps=8, weight_decay=wd, optimizer=opt,
              clip_norm=0.0 if clip == "off" else 1.0, b1=0.9, b2=0.99)
    params = _tree(0)
    gscale = 10.0 if clip == "active" else 0.1
    grads = [{k: gscale * v for k, v in _tree(s).items()}
             for s in range(1, 6)]

    tx = jstep.make_optimizer(0.1, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)

    rule = tstep.make_optimizer(0.1, **kw)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in ("a", "b")]
    optimizer = rule.init(tp)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        norm = rule.apply(optimizer, count)
        assert float(norm) == pytest.approx(
            float(optax.global_norm(g)), rel=1e-6)
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)


def test_clip_is_optax_not_clip_grad_norm():
    """Above the limit the gradients are scaled by max_norm / norm exactly
    (torch's clip_grad_norm_ would divide by norm + 1e-6)."""
    rule = tstep.make_optimizer(0.0, clip_norm=1.0, optimizer="sgd", b1=0.0)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = rule.init([p])
    p.grad = torch.tensor([3.0, 4.0])
    norm = rule.apply(opt, 0)
    assert float(norm) == 5.0
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8]), rtol=0,
                               atol=0)


def test_ema_update_matches():
    ema = _tree(0)
    want = jax.tree.map(jnp.asarray, ema)
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    for s in range(3):
        p = _tree(2 + s)
        want = jstep.ema_update(want, jax.tree.map(jnp.asarray, p), 0.9)
        tstep.ema_update(got, {k: torch.from_numpy(v) for k, v in p.items()},
                         0.9)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Train and eval steps against the JAX package.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params():
    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=0)
    return jax.tree.map(np.asarray, params)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, *RAW_HW, 3), dtype=np.uint8)
    depth = rng.uniform(1.0, 60.0, (b, *DEPTH_HW)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    depth[:, :, 9:] = 81.0
    return img, depth


def _states(compute, ema_decay=0.0, **opt_kw):
    """(JAX TrainState, port TrainState) from the same params."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    params = _jax_params()
    kw = dict(warmup_steps=0, total_steps=10, **opt_kw)
    jm = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jdt)
    js = jstep.TrainState.create(jm.apply, jax.tree.map(jnp.asarray, params),
                                 jstep.make_optimizer(LR, **kw),
                                 ema=ema_decay > 0)
    tm = tenc.EncDecDepthNet(width_mult=0.25, compute_dtype=tdt)
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    ts = tstep.TrainState.create(tm, tstep.make_optimizer(LR, **kw),
                                 ema=ema_decay > 0)
    return js, ts


def _jax_train_step(state, img, depth, **kw):
    return jstep.train_step(state, jnp.asarray(img), jnp.asarray(depth),
                            jax.random.key(0), input_hw=IN_HW,
                            target_hw=TARGET_HW, use_pallas=False,
                            resize_precision="highest", emit_s2d=0, **kw)


def _port_train_step(state, img, depth, **kw):
    return tstep.train_step(state, torch.from_numpy(img),
                            torch.from_numpy(depth), None, input_hw=IN_HW,
                            target_hw=TARGET_HW, **kw)


def _params_np(state):
    return {k: v.detach().numpy() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("loss_kind", ["si", "berhu"])
def test_train_step_f32_matches_jax(loss_kind):
    img, depth = _batch()
    js, ts = _states("f32", ema_decay=0.5)
    js, jm = _jax_train_step(js, img, depth, loss_kind=loss_kind,
                             ema_decay=0.5)
    ts, tm = _port_train_step(ts, img, depth, loss_kind=loss_kind,
                              ema_decay=0.5)
    assert ts.step == int(js.step) == 1
    for k in ("loss", "rmse", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    want = convert.to_state_dict(jax.tree.map(np.asarray, js.params))
    want_ema = convert.to_state_dict(jax.tree.map(np.asarray, js.ema_params))
    got = _params_np(ts)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(ts.ema_params[k].numpy(),
                                   want_ema[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_train_step_bf16_matches_jax():
    img, depth = _batch(seed=1)
    js, ts = _states("bf16")
    js, jm = _jax_train_step(js, img, depth)
    ts, tm = _port_train_step(ts, img, depth)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2)
    assert float(tm["rmse"]) == pytest.approx(float(jm["rmse"]), rel=2e-2)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=5e-2)
    want = convert.to_state_dict(jax.tree.map(np.asarray, js.params))
    got = _params_np(ts)
    diff = np.concatenate([np.abs(got[k] - v.numpy()).ravel()
                           for k, v in want.items()])
    assert (diff > LR / 2).mean() < 0.01
    assert diff.max() <= 2 * LR + 1e-6  # a flipped first Adam step at most


def test_train_step_makes_no_host_sync_and_counts_steps():
    """Metrics stay tensors; the step counter advances on the host."""
    img, depth = _batch()
    _, ts = _states("f32")
    for i in range(2):
        ts, m = _port_train_step(ts, img, depth)
        assert all(isinstance(v, torch.Tensor) and v.ndim == 0
                   for v in m.values())
        assert ts.step == i + 1


def test_augmented_train_step_uses_one_draw_for_image_and_depth():
    """train_step with a generator draws once; the same draw mapped onto
    both grids reproduces its preprocessed batch."""
    from ann3depth_tpu_torch.ops import fused_preprocess as fp
    from ann3depth_tpu_torch.pipeline import preprocess as tpre

    img, depth = _batch(seed=2, b=4)
    images, depths = tpre.preprocess_batch(
        torch.from_numpy(img), torch.from_numpy(depth), IN_HW, TARGET_HW,
        generator=torch.Generator().manual_seed(5))
    draw = fp.draw_augment(torch.Generator().manual_seed(5), 4)
    ip = fp.params_from_draw(draw, RAW_HW, IN_HW)
    dp = fp.params_from_draw(draw, DEPTH_HW, TARGET_HW)
    torch.testing.assert_close(images, fp.plain_preprocess(
        torch.from_numpy(img), ip, out_hw=IN_HW), rtol=0, atol=0)
    torch.testing.assert_close(depths, fp.plain_preprocess(
        torch.from_numpy(depth)[..., None], dp, out_hw=TARGET_HW,
        depth_mode=True)[..., 0], rtol=0, atol=0)
    # flips agree: both x_scale signs come from the one flip draw
    assert torch.equal(ip[:, 3] < 0, dp[:, 3] < 0)


@pytest.mark.parametrize("crop,align,tta", [("", "", ""),
                                            ("eigen", "median", ""),
                                            ("garg", "", "flip")])
def test_eval_stats_step_matches_jax(crop, align, tta):
    img, depth = _batch(seed=3, b=3)
    js, ts = _states("f32")
    kw = dict(input_hw=IN_HW, target_hw=TARGET_HW, crop=crop, align=align,
              tta=tta)
    with jax.default_matmul_precision("highest"):
        want = jstep.eval_stats_step(js, jnp.asarray(img), jnp.asarray(depth),
                                     **kw)
    got = tstep.eval_stats_step(ts, torch.from_numpy(img),
                                torch.from_numpy(depth), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4,
                                              abs=1e-5), k


def test_eval_report_and_eval_step_match_jax():
    img, depth = _batch(seed=4, b=3)
    js, ts = _states("f32")
    kw = dict(input_hw=IN_HW, target_hw=TARGET_HW)
    with jax.default_matmul_precision("highest"):
        want, *_ = jstep.eval_report_step(js, jnp.asarray(img),
                                          jnp.asarray(depth), align="median",
                                          **kw)
        want_m = jstep.eval_step(js, jnp.asarray(img), jnp.asarray(depth),
                                 **kw)
    got, images, depths, pred_log = tstep.eval_report_step(
        ts, torch.from_numpy(img), torch.from_numpy(depth), align="median",
        **kw)
    assert images.shape == (3, *IN_HW, 3) and depths.shape == (3, *TARGET_HW)
    assert pred_log.shape == (3, *TARGET_HW, 1)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    got_m = tstep.eval_step(ts, torch.from_numpy(img),
                            torch.from_numpy(depth), **kw)
    for k in want_m:
        assert got_m[k] == pytest.approx(float(want_m[k]), rel=1e-4,
                                         abs=1e-5), k


def test_apply_alignment_median_matches_jax():
    rng = np.random.default_rng(6)
    depth = rng.uniform(1.0, 60.0, (3, 8, 10)).astype(np.float32)
    depth[1] = 0.0                  # no valid pixel: shift 0
    depth[2, 0, :5] = 0.0           # 75 valid pixels: an odd count
    pred = rng.normal(1.5, 0.5, (3, 8, 10, 1)).astype(np.float32)
    mask = rng.random((8, 10)) < 0.7
    for m in (None, mask):
        want = jstep.apply_alignment(jnp.asarray(pred), jnp.asarray(depth),
                                     "median", None if m is None
                                     else jnp.asarray(m))
        got = tstep.apply_alignment(torch.from_numpy(pred),
                                    torch.from_numpy(depth), "median",
                                    None if m is None
                                    else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert tstep.apply_alignment(torch.from_numpy(pred),
                                 torch.from_numpy(depth), "") is not None
    with pytest.raises(ValueError, match="unknown align"):
        tstep.apply_alignment(torch.from_numpy(pred),
                              torch.from_numpy(depth), "mean")
