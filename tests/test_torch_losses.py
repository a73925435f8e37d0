"""Parity of the port's losses and metrics (ann3depth_tpu_torch/train/
losses.py) with the JAX package's, on the CPU.

The same numpy inputs (seeded) go through both: targets with missing (0)
and saturated (> MAKE3D_DEPTH_CAP) pixels, one image with no valid pixel,
random masks and the eigen/garg eval crops, in the shapes [B, H, W] and
[B, H, W, 1]. Both sides reduce in f32 and differ in summation order only:
tolerance 1e-5 relative, with 1e-6 absolute for values near zero. Gradients
are held to 1e-5 of their largest entry: where the l2 and berhu residual
exp(pred) - gt cancels, one ulp of exp (JAX and torch round it apart) is a
large relative error of a small entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.train import losses as jl
from ann3depth_tpu_torch.train import losses as tl

RTOL, ATOL = 1e-5, 1e-6
KINDS = ["si", "si+grad", "l2", "berhu"]
SHAPE = (4, 15, 11)


def _inputs(channel=False, seed=0):
    """(pred_log, target, mask) numpy; image 2 has no valid pixel."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(1.0, 60.0, SHAPE).astype(np.float32)
    target[rng.random(SHAPE) < 0.1] = 0.0          # missing laser returns
    target[:, :, 8:] = np.where(rng.random((4, 15, 3)) < 0.5, 81.0,
                                target[:, :, 8:])  # saturated far plane
    target[2] = 0.0
    pred_log = (np.log(np.maximum(target, 1.0))
                + rng.normal(0.0, 0.3, SHAPE)).astype(np.float32)
    mask = rng.random(SHAPE) < 0.8
    if channel:
        return pred_log[..., None], target[..., None], mask[..., None]
    return pred_log, target, mask


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("channel", [False, True])
@pytest.mark.parametrize("fn", ["per_image_si_loss", "per_image_l2_loss",
                                "per_image_berhu_loss",
                                "per_image_grad_loss"])
def test_per_image_losses_match(fn, channel, use_mask):
    pred, target, mask = _inputs(channel)
    mask = mask if use_mask else None
    got = getattr(tl, fn)(_t(pred), _t(target), _t(mask))
    want = getattr(jl, fn)(_j(pred), _j(target), _j(mask))
    assert got.shape == (4,) and got.dtype == torch.float32
    _close(got.numpy(), want)
    assert float(got[2]) == 0.0  # the image with no valid pixel


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
def test_si_loss_lambda_and_scalar_match(lam):
    pred, target, mask = _inputs()
    _close(tl.scale_invariant_log_loss(_t(pred), _t(target), _t(mask),
                                       lam=lam).numpy(),
           jl.scale_invariant_log_loss(_j(pred), _j(target), _j(mask),
                                       lam=lam))


@pytest.mark.parametrize("channel", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_depth_loss_matches(kind, channel):
    pred, target, mask = _inputs(channel, seed=1)
    for m in (None, mask):
        _close(tl.depth_loss(_t(pred), _t(target), _t(m), kind=kind,
                             lam=0.5).numpy(),
               jl.depth_loss(_j(pred), _j(target), _j(m), kind=kind,
                             lam=0.5))
        _close(tl.per_image_depth_loss(_t(pred), _t(target), _t(m),
                                       kind=kind).numpy(),
               jl.per_image_depth_loss(_j(pred), _j(target), _j(m),
                                       kind=kind))


def test_pred_reshaped_to_target():
    """pred [B,H,W,1] against target [B,H,W], as the train step calls it."""
    pred, target, mask = _inputs(seed=2)
    for kind in KINDS:
        _close(tl.depth_loss(_t(pred[..., None]), _t(target), _t(mask),
                             kind=kind).numpy(),
               jl.depth_loss(_j(pred[..., None]), _j(target), _j(mask),
                             kind=kind))


def test_unknown_loss_kind_raises():
    pred, target, _ = _inputs()
    with pytest.raises(ValueError, match="unknown loss kind"):
        tl.depth_loss(_t(pred), _t(target), kind="l1")


@pytest.mark.parametrize("channel", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_loss_gradients_match_jax_grad(kind, channel):
    """d loss / d pred_log against jax.grad; berhu's cutoff carries no
    gradient on either side (stop_gradient / detach)."""
    pred, target, mask = _inputs(channel, seed=3)
    p = _t(pred).clone().requires_grad_(True)
    tl.depth_loss(p, _t(target), _t(mask), kind=kind, lam=0.5).backward()
    want = jax.grad(lambda x: jl.depth_loss(x, _j(target), _j(mask),
                                            kind=kind, lam=0.5))(_j(pred))
    _close(p.grad.numpy(), want, atol=RTOL * float(jnp.abs(want).max()))
    assert not p.grad[2].any()  # no valid pixel, no gradient


def test_berhu_cutoff_is_detached():
    """The gradient is that of the per-pixel loss with the cutoff c held
    constant: sign(r) exp(pred) / n below c and a / c * sign(r) exp(pred)
    / n above it. Through the max, the worst pixel would get more."""
    pred, target, _ = _inputs(seed=4)
    p = _t(pred).clone().requires_grad_(True)
    tl.per_image_berhu_loss(p, _t(target)).sum().backward()
    t = _t(target)
    valid = (t > 1e-6) & (t <= 70.0)
    e = torch.exp(_t(pred))
    r = torch.where(valid, e - t, 0.0)
    a = r.abs()
    c = torch.clamp(0.2 * a.amax(dim=(1, 2), keepdim=True), min=1e-6)
    n = torch.clamp(valid.sum(dim=(1, 2), keepdim=True).float(), min=1.0)
    slope = torch.where(a <= c, 1.0, a / c)
    want = torch.where(valid, slope * torch.sign(r) * e / n, 0.0)
    torch.testing.assert_close(p.grad, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("crop", ["", "eigen", "garg"])
@pytest.mark.parametrize("hw", [(15, 11), (120, 160), (228, 304)])
def test_eval_crop_mask_matches(crop, hw):
    got = tl.eval_crop_mask(hw, crop)
    want = jl.eval_crop_mask(hw, crop)
    if not crop:
        assert got is None and want is None
        return
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_eval_crop_mask_unknown_raises():
    with pytest.raises(ValueError, match="unknown eval crop"):
        tl.eval_crop_mask((8, 8), "kitti")


# Crop masks are [h, w], for [B, h, w] depth maps.
@pytest.mark.parametrize("channel,crop", [(False, ""), (True, ""),
                                          (False, "eigen"), (False, "garg")])
def test_metric_stats_match(channel, crop):
    pred, target, mask = _inputs(channel, seed=5)
    if crop:
        mask_np = jl.eval_crop_mask(SHAPE[1:], crop)
        tmask = tl.eval_crop_mask(SHAPE[1:], crop)
    else:
        mask_np, tmask = mask, _t(mask)
    per_t = tl.per_image_metric_stats(_t(pred), _t(target), tmask)
    per_j = jl.per_image_metric_stats(_j(pred), _j(target), _j(mask_np))
    assert sorted(per_t) == sorted(per_j)
    for k in per_j:
        assert per_t[k].shape == (4,), k
        _close(per_t[k].numpy(), per_j[k])
    assert float(per_t["n_valid"][2]) == 0.0
    assert float(per_t["n_images"].sum()) == 4.0  # counted as the JAX does

    for kind in KINDS:
        st = tl.depth_metric_stats(_t(pred), _t(target), tmask,
                                   si_lambda=0.5, loss_kind=kind)
        sj = jl.depth_metric_stats(_j(pred), _j(target), _j(mask_np),
                                   si_lambda=0.5, loss_kind=kind)
        assert sorted(st) == sorted(sj)
        for k in sj:
            _close(st[k].numpy(), sj[k])
        ft = tl.finalize_depth_metrics(st)
        fj = jl.finalize_depth_metrics(sj)
        assert sorted(ft) == sorted(fj)
        for k in fj:
            _close(ft[k].numpy(), fj[k])


def test_finalize_works_on_host_floats_and_arrays():
    pred, target, mask = _inputs(seed=6)
    st = tl.depth_metric_stats(_t(pred), _t(target), _t(mask), si_lambda=0.5)
    host = {k: float(v) for k, v in st.items()}
    out = tl.finalize_depth_metrics(host)
    assert all(isinstance(v, float) for v in out.values())
    want = jl.finalize_depth_metrics(
        {k: float(v) for k, v in jl.depth_metric_stats(
            _j(pred), _j(target), _j(mask), si_lambda=0.5).items()})
    for k in want:
        _close(out[k], want[k])
    # per-image arrays map elementwise (the report path)
    per = tl.finalize_depth_metrics(
        tl.per_image_metric_stats(_t(pred), _t(target), _t(mask)))
    assert per["rmse"].shape == (4,)
    # an empty split finalizes without dividing by zero
    empty = tl.finalize_depth_metrics({k: 0.0 for k in host})
    assert empty["rmse"] == 0.0 and empty["loss"] == 0.0


@pytest.mark.parametrize("channel", [False, True])
def test_depth_metrics_match(channel):
    pred, target, mask = _inputs(channel, seed=7)
    for m in (None, mask):
        got = tl.depth_metrics(_t(pred), _t(target), _t(m))
        want = jl.depth_metrics(_j(pred), _j(target), _j(m))
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k].numpy(), want[k])


def test_bf16_prediction_reduces_in_f32():
    """A bf16 model output is upcast before any reduction, as in JAX."""
    pred, target, mask = _inputs(seed=8)
    p16 = _t(pred).to(torch.bfloat16)
    got = tl.depth_loss(p16, _t(target), _t(mask))
    assert got.dtype == torch.float32
    want = jl.depth_loss(jnp.asarray(pred, jnp.bfloat16), _j(target),
                         _j(mask))
    _close(got.numpy(), want)
