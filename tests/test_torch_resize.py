"""Parity of the port's resize math (ann3depth_tpu_torch/ops/resize.py)
with the JAX package's (ann3depth_tpu/ops/resize.py).

Both sides compute in f32 from the same inputs; the only difference is the
summation order of the sums and matmuls, so every comparison holds to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ann3depth_tpu.ops import resize as jrz
from ann3depth_tpu_torch.ops import resize as trz

TOL = 1e-6  # f32 on both sides; summation order only


def _np(a):
    return np.array(a, dtype=np.float32)


@pytest.mark.parametrize("crop_start", [None, 0.3])
@pytest.mark.parametrize("crop_frac", [1.0, 0.875])
@pytest.mark.parametrize("flip", [None, False, True])
def test_window_params(crop_start, crop_frac, flip):
    js, jsc = jrz.window_params(
        48, 20, crop_start=crop_start, crop_frac=crop_frac,
        flip=None if flip is None else jnp.asarray(flip))
    ts, tsc = trz.window_params(
        48, 20, crop_start=crop_start, crop_frac=crop_frac,
        flip=None if flip is None else torch.tensor(flip))
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=TOL)
    np.testing.assert_allclose(tsc.numpy(), _np(jsc), atol=TOL)


@pytest.mark.parametrize("out_size,in_size,start,scale", [
    (24, 48, 0.0, 2.0),          # antialiased downsample
    (48, 24, 0.0, 0.5),          # 2-tap upsample
    (16, 37, 0.0, 37 / 16),      # non-integer ratio
    (20, 48, 42.0, -2.1),        # flipped crop window
    (12, 40, 3.5, 3.0),          # crop window
])
def test_triangle_matrix(out_size, in_size, start, scale):
    want = jrz.triangle_matrix(out_size, in_size, start, scale)
    got = trz.triangle_matrix(out_size, in_size, start, scale)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)


def test_triangle_matrix_batched_rows_equal_single_rows():
    starts = torch.tensor([0.0, 42.0, 3.5])
    scales = torch.tensor([2.0, -2.1, 3.0])
    got = trz.triangle_matrix(20, 48, starts, scales)
    assert got.shape == (3, 20, 48)
    for i in range(3):
        want = jrz.triangle_matrix(20, 48, float(starts[i]), float(scales[i]))
        np.testing.assert_allclose(got[i].numpy(), _np(want), atol=TOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_triangle_matrix_interleaved(channels):
    want = jrz.triangle_matrix_interleaved(14, 6, channels, 1.0, -2.0)
    got = trz.triangle_matrix_interleaved(14, 6, channels, 1.0, -2.0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_matmul(factor):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    want = jrz.upsample_matmul(jnp.asarray(x), factor)
    got = trz.upsample_matmul(torch.from_numpy(x), factor)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)


def test_upsample2x_equals_half_pixel_bilinear_interpolate():
    """F.interpolate(bilinear, align_corners=False), which DPT's fusion
    upsample uses for the JAX model's jax.image.resize, is the same
    half-pixel x2 as upsample2x_matmul, which encdec and multiscale use."""
    x = np.random.default_rng(1).standard_normal((2, 6, 9, 4)).astype(
        np.float32)
    want = trz.upsample2x_matmul(torch.from_numpy(x))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        scale_factor=2, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


@pytest.mark.parametrize("hw,factor", [((6, 8), 2), ((7, 5), 2),
                                       ((5, 9), 4), ((1, 3), 2)])
def test_upsample_aligned_equals_align_corners_interpolate(hw, factor):
    """upsample_aligned_nhwc (DPT-Large's fusion and head upsample) is
    F.interpolate(bilinear, align_corners=True) in f32, forward and
    backward, within 1e-6 of the largest value, on even and odd sizes."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, *hw, 3, generator=gen, requires_grad=True)
    got = trz.upsample_aligned_nhwc(x, factor)
    want = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                         mode="bilinear", align_corners=True
                         ).permute(0, 2, 3, 1)
    assert got.shape == want.shape and got.is_contiguous()
    g = torch.randn(got.shape, generator=gen)
    (dgot,) = torch.autograd.grad(got, x, g)
    (dwant,) = torch.autograd.grad(want, x, g)
    for a, b in ((got.detach(), want.detach()), (dgot, dwant)):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-6, err


@pytest.mark.parametrize("hw", [(24, 24), (7, 5), (48, 12)])
def test_upsample_aligned_bf16_keeps_f32_weights(hw):
    """In bf16, upsample_aligned_nhwc holds its weights as F.interpolate
    does (in f32, not rounded to bf16): a constant map stays exactly
    constant (weights rounded to bf16 miss a row sum of 1 by up to 2**-9,
    a bias of every output), and against F.interpolate in f64 on the same
    bf16 values, forward and backward, the error is the roundings of the
    two GEMMs' outputs alone: at most 2**-7 of the largest value, and
    unbiased on average."""
    one = torch.ones(2, *hw, 3, dtype=torch.bfloat16)
    assert bool((trz.upsample_aligned_nhwc(one, 2) == 1).all())
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, *hw, 16, generator=gen).bfloat16().requires_grad_()
    g = torch.randn(4, 2 * hw[0], 2 * hw[1], 16, generator=gen).bfloat16()
    got = trz.upsample_aligned_nhwc(x, 2)
    (dgot,) = torch.autograd.grad(got, x, g)
    x64 = x.detach().double().permute(0, 3, 1, 2).requires_grad_()
    want = F.interpolate(x64, scale_factor=2, mode="bilinear",
                         align_corners=True)
    (dwant,) = torch.autograd.grad(want, x64, g.double().permute(0, 3, 1, 2))
    for a, b in ((got, want), (dgot, dwant)):
        err = a.detach().double().permute(0, 3, 1, 2) - b.detach()
        scale = float(b.abs().max())
        assert float(err.abs().max()) <= 2 ** -7 * scale
        assert abs(float(err.mean())) <= 1e-3 * float(b.abs().mean())


def test_resample_2d():
    x = np.random.default_rng(2).uniform(0, 255, (30, 22, 3)).astype(
        np.float32)
    want = jrz.resample_2d(jnp.asarray(x), (12, 9), y_start=2.0,
                           y_scale=2.2, x_start=20.0, x_scale=-2.0)
    got = trz.resample_2d(torch.from_numpy(x), (12, 9), y_start=2.0,
                          y_scale=2.2, x_start=20.0, x_scale=-2.0)
    # values up to 255: the same f32 agreement, relative
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=1e-4)


def test_resample_2d_matches_jax_image_resize():
    x = np.random.default_rng(3).uniform(0, 1, (24, 32, 3)).astype(np.float32)
    want = jax.image.resize(x, (12, 16, 3), "bilinear")
    got = trz.resample_2d(torch.from_numpy(x), (12, 16))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
