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
- `plain_preprocess_v2` vs the TPU v2 kernel in interpret mode: both round
  the f32 row pass to bf16 and sum exact bf16 products in f32, so they may
  differ only where a row-pass value rounds one bf16 ulp apart
  (`fp.v2_error_bound`, about 7e-3 in normalized units here, tighter than
  the rtol .02 / atol .03 of tests/test_pallas_preprocess.py:89), and in
  mean by under 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.compat import reference_spec as jref
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.ops import pallas_preprocess as pp
from ann3depth_tpu.pipeline import preprocess as jpre
from ann3depth_tpu_torch.compat import reference_spec as tref
from ann3depth_tpu_torch.models import registry as treg
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
    "SI_LOSS_LAMBDA", "RESIZE_ALIGN_CORNERS", "EVAL_CROPS"])
def test_reference_constants_match(name):
    assert getattr(tref, name) == getattr(jref, name)


@pytest.mark.parametrize("input_hw", [(240, 320), (32, 48), (480, 640)])
def test_registry_shapes_match(input_hw):
    assert treg.output_hw("encdec", input_hw) == \
        jreg.output_hw("encdec", input_hw)
    assert treg.s2d_input_factor("encdec") == jreg.s2d_input_factor("encdec")


@pytest.mark.parametrize("name", ["small", "multiscale", "dpt", "dpt-small"])
def test_registry_models_not_ported_raise(name):
    """These models were not ported before; now the port's registry gives
    the JAX one's output shapes and stem layouts for them, and only an
    unknown name raises."""
    for input_hw in ((240, 320), (384, 384)):
        assert treg.output_hw(name, input_hw) == \
            jreg.output_hw(name, input_hw)
    assert treg.s2d_input_factor(name) == jreg.s2d_input_factor(name)
    with pytest.raises(KeyError, match="unknown model"):
        treg.output_hw(name + "-nosuch", (240, 320))


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


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("kind", ["identity", "augment"])
def test_plain_v2_matches_pallas_v2_interpret_image(kind, norm):
    x = _frames()
    params = _params(kind, 2, (40, 56), (24, 32))
    want = np.asarray(pp.fused_preprocess_v2(
        jnp.asarray(x), params, out_hw=(24, 32), norm=norm, interpret=True))
    got = fp.plain_preprocess_v2(_t(x), _t(params), out_hw=(24, 32),
                                 norm=norm).numpy()
    _, t = fp.v2_operands(_t(params), (40, 56), (24, 32), 3)
    bound = fp.v2_error_bound(t)["max_abs"]
    assert bound < 0.03
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    assert np.abs(got - want).mean() < 1e-4


@pytest.mark.parametrize("kind", ["identity", "augment"])
def test_plain_v2_matches_pallas_v2_interpret_depth(kind):
    d = _depth()
    d[:, ::4, ::3] = 0.0           # missing pixels
    d[:, :, 15:] = 81.0            # saturated band
    params = _params(kind, 2, (30, 22), (15, 11))
    want = np.asarray(pp.fused_preprocess_v2(
        jnp.asarray(d), params, out_hw=(15, 11), depth_mode=True,
        interpret=True))
    got = fp.plain_preprocess_v2(_t(d), _t(params), out_hw=(15, 11),
                                 depth_mode=True).numpy()
    _, t = fp.v2_operands(_t(params), (30, 22), (15, 11), 1)
    bound = fp.v2_error_bound(t, depth_mode=True)
    assert not ((got > 0) != (want > 0)).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound["max_abs"])
    assert np.abs(got - want).mean() < 1e-3


def _nudged(w, direction):
    """The f32 weights moved one f32 ulp towards +inf or -inf (zeros stay:
    the kernel's bands hold the same zeros)."""
    return torch.where(w != 0,
                       torch.nextafter(w, torch.full_like(w, direction)), w)


@pytest.mark.parametrize("direction", [float("inf"), float("-inf")])
@pytest.mark.parametrize("kind", ["identity", "augment", "depth"])
def test_v2_error_bound_covers_weights_an_ulp_apart(kind, direction):
    """The v2 kernel builds its own f32 weights, which may sit a few f32
    ulps from triangle_matrix's and so round to the neighbouring bf16. The
    widened `v2_error_bound` covers plain v2's arithmetic on weights nudged
    by one ulp, on T with its largest entry one bf16 ulp up, and on T with
    every weight of one band one bf16 ulp up."""
    from ann3depth_tpu_torch.ops.resize import (triangle_matrix,
                                                triangle_matrix_interleaved)
    depth_mode = kind == "depth"
    if depth_mode:
        x = _depth()
        x[:, ::4, ::3] = 0.0
        x[:, :, 15:] = 81.0
        in_hw, out_hw = (30, 22), (15, 11)
        params = _t(_params("augment", 2, in_hw, out_hw))
    else:
        x = _frames()
        in_hw, out_hw = (40, 56), (24, 32)
        params = _t(_params(kind, 2, in_hw, out_hw))
    x, c = _t(x), x.shape[-1]
    g = fp.geometry_of(params)
    ay = triangle_matrix(out_hw[0], in_hw[0], g["y_start"], g["y_scale"])
    ax_t = triangle_matrix_interleaved(in_hw[1], out_hw[1], c, g["x_start"],
                                       g["x_scale"])
    t = ax_t.to(torch.bfloat16)
    bound = fp.v2_error_bound(t, depth_mode=depth_mode, weights_apart=True)
    kw = dict(out_hw=out_hw, depth_mode=depth_mode)
    want = fp.v2_from_operands(x, params, ay, t, **kw)
    torch.testing.assert_close(want, fp.plain_preprocess_v2(x, params, **kw),
                               rtol=0, atol=0)
    ulps = fp._bf16_ulps(t.float())
    t_flip = t.clone().reshape(-1)
    k = int(t_flip.float().argmax())
    t_flip[k] = (t_flip[k].float() + ulps.reshape(-1)[k]).to(torch.bfloat16)
    # Every weight of the band whose ulps sum highest, one bf16 ulp up.
    col = ulps.sum(dim=-2)
    b_, j = divmod(int(col.argmax()), col.shape[-1])
    t_band = t.clone()
    t_band[b_, :, j] = (t_band[b_, :, j].float() + ulps[b_, :, j]).to(
        torch.bfloat16)
    variants = [(_nudged(ay, direction),
                 _nudged(ax_t, direction).to(torch.bfloat16)),
                (ay, t_flip.reshape(t.shape)), (ay, t_band)]
    for ay_v, t_v in variants:
        got = fp.v2_from_operands(x, params, ay_v, t_v, **kw)
        if depth_mode:
            v = ((x > tref.DEPTH_EPS) & (x <= tref.MAKE3D_DEPTH_CAP)).float()
            v = v.reshape(2, *in_hw)
            zv = torch.bmm(torch.bmm(ay, v).to(torch.bfloat16).float(),
                           t.float()).reshape(want.shape)
            differ = (got > 0) != (want > 0)
            assert bool((zv[differ] - 0.5).abs().le(
                bound["decision_band"]).all())
            diff = (got - want).abs()[~differ]
        else:
            diff = (got - want).abs()
        assert float(diff.max()) <= bound["max_abs"]


def test_plain_v2_within_bf16_of_exact_plain():
    """v2 differs from the exact-f32 function by its bf16 column pass only:
    the tolerance of tests/test_pallas_preprocess.py:89."""
    x = _frames()
    params = _params("augment", 2, (40, 56), (24, 32))
    got = fp.plain_preprocess_v2(_t(x), _t(params), out_hw=(24, 32))
    want = fp.plain_preprocess(_t(x), _t(params), out_hw=(24, 32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.02,
                               atol=0.03)


def test_v2_operands_match_jax():
    params = _params("augment", 2, (40, 56), (24, 32))
    ay, t = fp.v2_operands(_t(params), (40, 56), (24, 32), 3)
    assert ay.dtype == torch.float32 and t.dtype == torch.bfloat16
    assert ay.shape == (2, 24, 40) and t.shape == (2, 168, 96)
    g = pp.geometry_of(params)
    from ann3depth_tpu.ops.resize import (triangle_matrix,
                                          triangle_matrix_interleaved)
    want_ay = jax.vmap(lambda s, sc: triangle_matrix(24, 40, s, sc))(
        g["y_start"], g["y_scale"])
    want_t = jax.vmap(lambda s, sc: triangle_matrix_interleaved(
        56, 32, 3, s, sc))(g["x_start"], g["x_scale"]).astype(jnp.bfloat16)
    np.testing.assert_allclose(ay.numpy(), np.asarray(want_ay), atol=1e-6)
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(want_t.astype(jnp.float32)),
                               atol=2 ** -8)


def test_fused_preprocess_v2_on_cpu_runs_plain_and_counts_nothing():
    x = _t(_frames())
    params = fp.identity_params(2, (40, 56), (24, 32))
    before = fp.fused_preprocess_v2.launches
    got = fp.fused_preprocess_v2(x, params, out_hw=(24, 32))
    want = fp.plain_preprocess_v2(x, params, out_hw=(24, 32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fp.fused_preprocess_v2.launches == before
    meta = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no fused_preprocess_v2"):
        fp.fused_preprocess_v2(meta, torch.empty((1, 8), device="meta"),
                               out_hw=(4, 4))


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
