"""Parity of the port's preprocess (ann3depth_tpu_torch/ops/fused_preprocess.py
and pipeline/preprocess.py) with the JAX package's, on the CPU.

The same numpy inputs and the same [B, 8] param rows go through both. On
the CPU, the port's `fused_preprocess` runs its plain version, so:

- plain vs `oracle_preprocess` at HIGHEST: atol 1e-4. Both are exact f32;
  they differ only in summation order (~1e-6 of values up to ~2.6).
- plain vs the TPU kernel in interpret mode: the kernel's own tolerances
  (tests/test_pallas_preprocess.py:73 and :114), rtol .02 / atol .03 for
  images and .01 / .05 for depth, because that kernel runs its column pass
  in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.compat import reference_spec as jref
from ann3depth_tpu.ops import pallas_preprocess as pp
from ann3depth_tpu.pipeline import preprocess as jpre
from ann3depth_tpu_torch.compat import reference_spec as tref
from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.pipeline import preprocess as tpre

ORACLE_TOL = 1e-4
HI = jax.lax.Precision.HIGHEST


def _frames(b=2, h=40, w=56, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, c),
                                                dtype=np.uint8)


def _depth(b=2, h=30, w=22, seed=0):
    return np.random.default_rng(seed).uniform(1, 60, (b, h, w, 1)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(kind, b, in_hw, out_hw):
    if kind == "identity":
        return pp.identity_params(b, in_hw, out_hw)
    return pp.augment_params(jax.random.key(1), b, in_hw, out_hw)


@pytest.mark.parametrize("name", [
    "INPUT_H", "INPUT_W", "TARGET_H", "TARGET_W", "LIVE_FRAME_H",
    "LIVE_FRAME_W", "MAKE3D_DEPTH_H", "MAKE3D_DEPTH_W", "MAKE3D_IMAGE_H",
    "MAKE3D_IMAGE_W", "NYU_H", "NYU_W", "DPT_RES", "RGB_MEAN", "RGB_STD",
    "MAKE3D_DEPTH_CAP", "DEPTH_EPS", "DEPTH_VALID_RESAMPLE_THRESH",
    "SI_LOSS_LAMBDA", "RESIZE_ALIGN_CORNERS"])
def test_reference_constants_match(name):
    assert getattr(tref, name) == getattr(jref, name)


def test_identity_params_match():
    np.testing.assert_array_equal(
        fp.identity_params(3, (480, 640), (240, 320)).numpy(),
        np.asarray(pp.identity_params(3, (480, 640), (240, 320))))
    assert fp.CROP_FRAC == pp.CROP_FRAC


@pytest.mark.parametrize("kind", ["identity", "augment"])
@pytest.mark.parametrize("norm", [True, False])
def test_plain_matches_oracle_image(kind, norm):
    x = _frames()
    params = _params(kind, 2, (40, 56), (24, 32))
    want = pp.oracle_preprocess(jnp.asarray(x), params, out_hw=(24, 32),
                                norm=norm, precision=HI)
    got = fp.plain_preprocess(_t(x), _t(params), out_hw=(24, 32), norm=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_TOL)


def test_plain_matches_oracle_depth():
    d = _depth()
    d[:, ::4, ::3] = 0.0           # missing pixels
    d[:, :, 15:] = 81.0            # saturated band
    params = pp.identity_params(2, (30, 22), (15, 11))
    want = pp.oracle_preprocess(jnp.asarray(d), params, out_hw=(15, 11),
                                depth_mode=True, precision=HI)
    got = fp.plain_preprocess(_t(d), _t(params), out_hw=(15, 11),
                              depth_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_TOL)


def test_plain_matches_oracle_depth_augmented():
    d = _depth()
    params = _params("augment", 2, (30, 22), (15, 11))
    want = pp.oracle_preprocess(jnp.asarray(d), params, out_hw=(15, 11),
                                depth_mode=True, precision=HI)
    got = fp.plain_preprocess(_t(d), _t(params), out_hw=(15, 11),
                              depth_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_TOL)


def test_plain_depth_masks_saturated_pixels():
    """The no-blend invariant (tests/test_pallas_preprocess.py:179): valid
    outputs are exactly the only valid source value, or 0."""
    depth = np.full((1, 20, 24, 1), 50.0, np.float32)
    depth[0, :, 12:, 0] = 81.0
    params = fp.identity_params(1, (20, 24), (10, 12))
    out = fp.plain_preprocess(_t(depth), params, out_hw=(10, 12),
                              depth_mode=True)[0, ..., 0].numpy()
    assert np.all((np.abs(out - 50.0) < 1e-3) | (out == 0.0)), out
    assert (out == 0.0).any() and (np.abs(out - 50.0) < 1e-3).any()
    want = pp.oracle_preprocess(jnp.asarray(depth), jnp.asarray(params),
                                out_hw=(10, 12), depth_mode=True)
    np.testing.assert_allclose(out, np.asarray(want)[0, ..., 0],
                               atol=ORACLE_TOL)


def test_plain_depth_renormalizes_missing_pixels():
    depth = np.full((1, 16, 16, 1), 4.0, np.float32)
    depth[0, ::2, ::2, 0] = 0.0
    params = fp.identity_params(1, (16, 16), (8, 8))
    out = fp.plain_preprocess(_t(depth), params, out_hw=(8, 8),
                              depth_mode=True).numpy()
    assert (out > 0).any()
    np.testing.assert_allclose(out[out > 0], 4.0, rtol=1e-4)


@pytest.mark.parametrize("kind", ["identity", "augment"])
def test_plain_matches_pallas_kernel_interpret_image(kind):
    x = _frames()
    params = _params(kind, 2, (40, 56), (24, 32))
    want = pp.fused_preprocess(jnp.asarray(x), params, out_hw=(24, 32),
                               interpret=True)
    got = fp.plain_preprocess(_t(x), _t(params), out_hw=(24, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.02,
                               atol=0.03)


def test_plain_matches_pallas_kernel_interpret_depth():
    d = _depth()
    params = pp.identity_params(2, (30, 22), (15, 11))
    want = pp.fused_preprocess(jnp.asarray(d), params, out_hw=(15, 11),
                               depth_mode=True, interpret=True)
    got = fp.plain_preprocess(_t(d), _t(params), out_hw=(15, 11),
                              depth_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.01,
                               atol=0.05)


@pytest.mark.parametrize("kind", ["identity", "augment"])
def test_plain_s2d_matches_oracle_s2d(kind):
    x = _frames(h=40, w=56)
    params = _params(kind, 2, (40, 56), (24, 32))
    want = pp.oracle_preprocess_s2d(jnp.asarray(x), params, out_hw=(24, 32),
                                    precision=HI, out_dtype=jnp.float32)
    got = fp.plain_preprocess_s2d(_t(x), _t(params), out_hw=(24, 32),
                                  out_dtype=torch.float32)
    assert got.shape == (2, 6, 8, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_TOL)
    # The bf16 default: one bf16 rounding (2^-8 relative) on each side.
    got16 = fp.plain_preprocess_s2d(_t(x), _t(params), out_hw=(24, 32))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want),
                               rtol=2 ** -7, atol=1e-2)


def test_augment_params_distributions():
    n, in_hw, out_hw = 20000, (48, 64), (24, 32)
    gen = torch.Generator().manual_seed(0)
    p = fp.augment_params(gen, n, in_hw, out_hw)
    g = fp.geometry_of(p)
    flip = g["x_scale"] < 0
    crop = g["out_scale"] < 1.0
    # Bernoulli(.5) over 20000 draws: std 0.0035, so 0.02 is ~6 sigma.
    assert abs(flip.float().mean().item() - 0.5) < 0.02
    assert abs(crop.float().mean().item() - 0.5) < 0.02
    b, c = g["brightness"], g["contrast"]
    assert b.min() >= -0.2 and b.max() <= 0.2
    assert c.min() >= 0.8 and c.max() <= 1.2
    # U(lo, hi): mean (lo+hi)/2, std (hi-lo)/sqrt(12).
    assert abs(b.mean().item()) < 0.01 and abs(c.mean().item() - 1.0) < 0.01
    assert abs(b.std().item() - 0.4 / 12 ** 0.5) < 0.005
    assert abs(c.std().item() - 0.4 / 12 ** 0.5) < 0.005
    assert torch.all(g["photo"] == 1.0)
    # Geometry: the crop window is CROP_FRAC of the frame, flips mirror it.
    frac = torch.where(crop, fp.CROP_FRAC, 1.0)
    torch.testing.assert_close(g["y_scale"], frac * in_hw[0] / out_hw[0])
    torch.testing.assert_close(g["x_scale"].abs(), frac * in_hw[1] / out_hw[1])
    assert torch.all(g["x_start"][flip] > 0)


def test_augment_params_deterministic_per_seed():
    a = fp.augment_params(torch.Generator().manual_seed(9), 4, (32, 40),
                          (16, 20))
    b = fp.augment_params(torch.Generator().manual_seed(9), 4, (32, 40),
                          (16, 20))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_preprocess_on_cpu_runs_plain_and_counts_nothing():
    x = _t(_frames())
    params = fp.identity_params(2, (40, 56), (24, 32))
    before = fp.fused_preprocess.launches
    got = fp.fused_preprocess(x, params, out_hw=(24, 32))
    want = fp.plain_preprocess(x, params, out_hw=(24, 32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fp.fused_preprocess.launches == before


def test_fused_preprocess_other_devices_raise():
    """No quiet fallback: a tensor that is neither on the CPU nor on a card
    is refused."""
    x = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    params = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError, match="no fused_preprocess"):
        fp.fused_preprocess(x, params, out_hw=(4, 4))


def test_preprocess_image_matches_jax():
    x = _frames(b=3, h=48, w=64)
    want = jpre.preprocess_image(jnp.asarray(x), (24, 32))
    got = tpre.preprocess_image(_t(x), (24, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_TOL)


def test_preprocess_depth_matches_jax():
    d = _depth(b=2, h=30, w=22)[..., 0]
    want = jpre.preprocess_depth(jnp.asarray(d), (15, 11))
    got = tpre.preprocess_depth(_t(d), (15, 11))
    assert got.shape == (2, 15, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_TOL)


def test_preprocess_batch_eval_path_matches_jax():
    x = _frames(b=2, h=32, w=40)
    d = _depth(b=2, h=16, w=20)[..., 0]
    jim, jdp = jpre.preprocess_batch(jnp.asarray(x), jnp.asarray(d),
                                     (16, 20), (8, 10))
    tim, tdp = tpre.preprocess_batch(_t(x), _t(d), (16, 20), (8, 10))
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=ORACLE_TOL)
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), atol=ORACLE_TOL)


def test_preprocess_batch_flip_consistency():
    """One draw drives image and depth: they flip and crop together."""
    b, h, w = 8, 32, 40
    img = np.tile(np.linspace(0, 255, w, dtype=np.uint8)[None, None, :, None],
                  (b, h, 1, 3))
    dep = np.tile(np.linspace(1, 50, 20, dtype=np.float32)[None, None, :],
                  (b, 10, 1))
    im_out, dep_out = tpre.preprocess_batch(
        _t(img), _t(dep), (16, 20), (8, 10),
        generator=torch.Generator().manual_seed(4))
    for i in range(b):
        im_flipped = bool(im_out[i, 0, 0, 0] > im_out[i, 0, -1, 0])
        dep_flipped = bool(dep_out[i, 0, 0] > dep_out[i, 0, -1])
        assert im_flipped == dep_flipped


def test_normalize_roundtrip_matches_jax():
    x = np.random.default_rng(5).uniform(0, 1, (2, 4, 5, 3)).astype(
        np.float32)
    n = tpre.normalize_rgb(_t(x))
    np.testing.assert_allclose(n.numpy(),
                               np.asarray(jpre.normalize_rgb(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(tpre.denormalize_rgb(n).numpy(), x, atol=1e-6)
