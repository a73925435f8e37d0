"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the v1 kernel and its plain version are both f32 and differ in
summation order only: 1e-4 for normalized images, 1e-3 m for depth. The v2
kernel and `plain_preprocess_v2` both round the f32 row pass to bf16, and
the kernel builds its own weights (f32 ulps from triangle_matrix's), so
they may differ by one bf16 ulp of a row-pass value carried through the
column weights, or by one bf16 ulp of each column weight of a band times
the largest row value (`fp.v2_error_bound(..., weights_apart=True)`), and
in mean by under 1e-4 (images) or 1e-3 m (depth); depth validity decisions
may differ only within the bound's band around zv = 0.5. A train step fed by the kernel and one fed by the plain
preprocess agree to 1e-2 relative in loss: the model computes in bf16
(2^-8 relative), and its inputs differ by f32 summation order only; so do
a distillation step fed both ways and an accumulated step against a
full-batch one. Repeated train steps in torch's deterministic mode agree
bit for bit (a DPT at upsample "matmul" too). The capturable sgd rule on
the card gives the CPU rule's params within 1e-6 (p - lr t against
p + (-lr) t may round apart by an ulp). The int8 ops (ops/quant.py) give the CPU's answer bit for bit
(exact int32 sums, the same f32 quantize and dequantize); an exported
serving program gives the eager program's within EXPORT_RTOL. A one-rank
NCCL group's all-reduce moves no value: its runs (eager, and a CUDA graph
that captures the all-reduce) equal the runs without a group bit for bit.
"""

import copy
import math

import numpy as np
import pytest
import torch

from ann3depth_tpu_torch.compat import reference_spec as ref
from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.train import step as steplib

pytestmark = pytest.mark.cuda

V2_IMAGE_MEAN_TOL = 1e-4
V2_DEPTH_MEAN_TOL = 1e-3
STEP_LOSS_RTOL = 1e-2
# An exported serving program runs the eager program's ops on the same
# weights; cuDNN may still pick another algorithm for a traced conv.
EXPORT_RTOL = 1e-6
IN_HW = (32, 48)  # the small models' input size


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("kind", ["identity", "augment", "upsample"])
def test_kernel_matches_plain_image(cuda, dtype, kind):
    gen = torch.Generator(device=cuda).manual_seed(0)
    in_hw, out_hw = ((24, 32), (40, 56)) if kind == "upsample" else \
        ((61, 83), (24, 32))
    frames = torch.randint(0, 256, (3, *in_hw, 3), generator=gen,
                           device=cuda).to(dtype)
    if kind == "augment":
        params = fp.augment_params(gen, 3, in_hw, out_hw, device=cuda)
    else:
        params = fp.identity_params(3, in_hw, out_hw, device=cuda)
    before = fp.fused_preprocess.launches
    got = fp.fused_preprocess(frames, params, out_hw=out_hw)
    assert fp.fused_preprocess.launches == before + 1
    want = fp.plain_preprocess(frames, params, out_hw=out_hw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_matches_plain_depth(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    depth = 1 + 59 * torch.rand((2, 30, 22, 1), generator=gen, device=cuda)
    depth[:, :, 15:] = 81.0
    params = fp.identity_params(2, (30, 22), (15, 11), device=cuda)
    got = fp.fused_preprocess(depth, params, out_hw=(15, 11), depth_mode=True)
    want = fp.plain_preprocess(depth, params, out_hw=(15, 11),
                               depth_mode=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def test_kernel_rejects_what_it_does_not_take(cuda):
    params = fp.identity_params(1, (8, 8), (4, 4), device=cuda)
    with pytest.raises(ValueError, match="depth mode"):
        fp.fused_preprocess(torch.zeros((1, 8, 8, 3), device=cuda), params,
                            out_hw=(4, 4), depth_mode=True)
    with pytest.raises(ValueError, match="params"):
        fp.fused_preprocess(torch.zeros((1, 8, 8, 3), device=cuda),
                            params.cpu(), out_hw=(4, 4))


def _v2_zv(depth, params, out_hw):
    """The plain v2 validity weight zv of each output (its decision is
    zv >= 0.5)."""
    b, h_in, w_in, _ = depth.shape
    ay, t = fp.v2_operands(params, (h_in, w_in), out_hw, 1)
    v = ((depth > ref.DEPTH_EPS) & (depth <= ref.MAKE3D_DEPTH_CAP)).float()
    v = v.reshape(b, h_in, w_in)
    rv = torch.bmm(ay, v).to(torch.bfloat16).float()
    return torch.bmm(rv, t.float()).reshape(b, *out_hw, 1)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("kind", ["identity", "augment", "upsample"])
def test_v2_kernel_matches_plain_image(cuda, dtype, kind):
    gen = torch.Generator(device=cuda).manual_seed(0)
    in_hw, out_hw = ((24, 32), (40, 56)) if kind == "upsample" else \
        ((61, 83), (24, 32))
    frames = torch.randint(0, 256, (3, *in_hw, 3), generator=gen,
                           device=cuda).to(dtype)
    if kind == "augment":
        params = fp.augment_params(gen, 3, in_hw, out_hw, device=cuda)
    else:
        params = fp.identity_params(3, in_hw, out_hw, device=cuda)
    before = fp.fused_preprocess_v2.launches
    got = fp.fused_preprocess_v2(frames, params, out_hw=out_hw)
    assert fp.fused_preprocess_v2.launches == before + 1
    want = fp.plain_preprocess_v2(frames, params, out_hw=out_hw)
    torch.cuda.synchronize()
    _, t = fp.v2_operands(params, in_hw, out_hw, 3)
    err = (got - want).abs()
    bound = fp.v2_error_bound(t, weights_apart=True)
    assert float(err.max()) <= bound["max_abs"]
    assert float(err.mean()) <= V2_IMAGE_MEAN_TOL


def test_v2_kernel_matches_plain_image_without_norm(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    frames = torch.randint(0, 256, (2, 61, 83, 1), generator=gen,
                           device=cuda).to(torch.uint8)
    params = fp.identity_params(2, (61, 83), (24, 32), device=cuda)
    got = fp.fused_preprocess_v2(frames, params, out_hw=(24, 32), norm=False)
    want = fp.plain_preprocess_v2(frames, params, out_hw=(24, 32),
                                  norm=False)
    _, t = fp.v2_operands(params, (61, 83), (24, 32), 1)
    assert float((got - want).abs().max()) <= \
        fp.v2_error_bound(t, weights_apart=True)["max_abs"]


@pytest.mark.parametrize("kind", ["identity", "augment"])
def test_v2_kernel_matches_plain_depth(cuda, kind):
    gen = torch.Generator(device=cuda).manual_seed(1)
    depth = 1 + 59 * torch.rand((3, 30, 22, 1), generator=gen, device=cuda)
    depth[:, :, 15:] = 81.0
    depth[:, ::4, ::3] = 0.0
    if kind == "augment":
        params = fp.augment_params(gen, 3, (30, 22), (15, 11), device=cuda)
    else:
        params = fp.identity_params(3, (30, 22), (15, 11), device=cuda)
    got = fp.fused_preprocess_v2(depth, params, out_hw=(15, 11),
                                 depth_mode=True)
    want = fp.plain_preprocess_v2(depth, params, out_hw=(15, 11),
                                  depth_mode=True)
    torch.cuda.synchronize()
    _, t = fp.v2_operands(params, (30, 22), (15, 11), 1)
    bound = fp.v2_error_bound(t, depth_mode=True, weights_apart=True)
    differ = (got > 0) != (want > 0)
    zv = _v2_zv(depth, params, (15, 11))
    assert bool((zv[differ] - 0.5).abs().le(bound["decision_band"]).all())
    err = (got - want).abs()[~differ]
    assert float(err.max()) <= bound["max_abs"]
    assert float(err.mean()) <= V2_DEPTH_MEAN_TOL


def test_v2_kernel_rejects_what_it_does_not_take(cuda):
    params = fp.identity_params(1, (8, 8), (4, 4), device=cuda)
    with pytest.raises(ValueError, match="depth mode"):
        fp.fused_preprocess_v2(torch.zeros((1, 8, 8, 3), device=cuda),
                               params, out_hw=(4, 4), depth_mode=True)
    with pytest.raises(ValueError, match="params"):
        fp.fused_preprocess_v2(torch.zeros((1, 8, 8, 3), device=cuda),
                               params.cpu(), out_hw=(4, 4))
    with pytest.raises(ValueError, match="image mode takes C=3"):
        fp.fused_preprocess_v2(
            torch.zeros((1, 8, 8, 2), dtype=torch.uint8, device=cuda),
            params, out_hw=(4, 4))


# The band-resample design (csrc/band_resample.cuh): tiles of
# fp.TILE_ROWS output rows whose bands cross the frame's edges, ragged last
# tiles, one frame, other tile sizes, and param rows outside the plan.

IMPLS = {"v1": (fp.fused_preprocess, fp.plain_preprocess),
         "v2": (fp.fused_preprocess_v2, fp.plain_preprocess_v2)}
KERNEL_NAMES = {"v1": "fused_preprocess", "v2": "fused_preprocess_v2"}
EDGE_DRAWS = {  # (flip, crop, crop offset on both axes)
    "crop_at_0": (False, True, 0.0), "crop_at_1": (False, True, 1.0),
    "flip": (True, False, 0.5), "flip_crop_at_0": (True, True, 0.0),
    "flip_crop_at_1": (True, True, 1.0)}


def _edge_params(kind, b, in_hw, out_hw, device):
    flip, crop, off = EDGE_DRAWS[kind]
    full = lambda v: torch.full((b,), v)  # noqa: E731
    draw = dict(flip=full(flip), crop=full(crop), oy=full(off),
                ox=full(off), brightness=torch.linspace(-0.2, 0.2, b),
                contrast=torch.linspace(0.8, 1.2, b))
    return fp.params_from_draw(draw, in_hw, out_hw).to(device)


def _assert_image_close(impl, got, want, params, in_hw, out_hw):
    """v1: f32 against f32 (1e-4); v2: fp.v2_error_bound and the mean
    tolerance."""
    assert bool(torch.isfinite(got).all())
    if impl == "v1":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        return
    _, t = fp.v2_operands(params, in_hw, out_hw, got.shape[-1])
    err = (got - want).abs()
    bound = fp.v2_error_bound(t, weights_apart=True)
    assert float(err.max()) <= bound["max_abs"]
    assert float(err.mean()) <= V2_IMAGE_MEAN_TOL


def _assert_depth_close(impl, got, want, depth, params, out_hw):
    """v1: 1e-3 m; v2: decisions differ only within the bound's band, the
    values elsewhere within its max and the mean tolerance."""
    if impl == "v1":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
        return
    _, t = fp.v2_operands(params, depth.shape[1:3], out_hw, 1)
    bound = fp.v2_error_bound(t, depth_mode=True, weights_apart=True)
    differ = (got > 0) != (want > 0)
    zv = _v2_zv(depth, params, out_hw)
    assert bool((zv[differ] - 0.5).abs().le(bound["decision_band"]).all())
    err = (got - want).abs()[~differ]
    assert float(err.max()) <= bound["max_abs"]
    assert float(err.mean()) <= V2_DEPTH_MEAN_TOL


@pytest.mark.parametrize("kind", sorted(EDGE_DRAWS))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_tile_bands_across_frame_edges_image(cuda, impl, kind):
    """Crop windows at offsets 0 and 1 and flips put the first and last
    tiles' bands against the frame's edges; 27 output rows leave a ragged
    last tile."""
    kernel, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(4)
    frames = torch.randint(0, 256, (3, 61, 83, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    params = _edge_params(kind, 3, (61, 83), (27, 32), cuda)
    got = kernel(frames, params, out_hw=(27, 32))
    want = plain(frames, params, out_hw=(27, 32))
    _assert_image_close(impl, got, want, params, (61, 83), (27, 32))


@pytest.mark.parametrize("kind", sorted(EDGE_DRAWS))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_tile_bands_across_frame_edges_depth(cuda, impl, kind):
    """Make3D's laser grid (305x55 -> 120x160): 220-byte source rows, not
    16-byte aligned, and an upsampled x axis."""
    kernel, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(5)
    depth = 1 + 59 * torch.rand((2, 305, 55, 1), generator=gen, device=cuda)
    depth[:, :, 20:26] = 81.0
    depth[:, ::7, ::5] = 0.0
    params = _edge_params(kind, 2, (305, 55), (120, 160), cuda)
    got = kernel(depth, params, out_hw=(120, 160), depth_mode=True)
    want = plain(depth, params, out_hw=(120, 160), depth_mode=True)
    _assert_depth_close(impl, got, want, depth, params, (120, 160))


@pytest.mark.parametrize("h_out", [1, 7, 9, 17])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_output_height_not_a_multiple_of_the_tile(cuda, impl, h_out):
    kernel, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(6)
    frames = torch.randint(0, 256, (2, 40, 56, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    params = fp.augment_params(gen, 2, (40, 56), (h_out, 24), device=cuda)
    got = kernel(frames, params, out_hw=(h_out, 24))
    want = plain(frames, params, out_hw=(h_out, 24))
    _assert_image_close(impl, got, want, params, (40, 56), (h_out, 24))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_batch_of_one(cuda, impl):
    kernel, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(7)
    frames = torch.randint(0, 256, (1, 120, 160, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    params = fp.augment_params(gen, 1, (120, 160), (60, 80), device=cuda)
    got = kernel(frames, params, out_hw=(60, 80))
    want = plain(frames, params, out_hw=(60, 80))
    _assert_image_close(impl, got, want, params, (120, 160), (60, 80))


@pytest.mark.parametrize("tile_rows", [1, 4, 16])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_other_tile_sizes(cuda, impl, tile_rows):
    _, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(8)
    frames = torch.randint(0, 256, (2, 61, 83, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    params = fp.augment_params(gen, 2, (61, 83), (27, 32), device=cuda)
    plan = fp.band_plan(frames.shape, (27, 32), tile_rows=tile_rows)
    got = fp._launch_band(KERNEL_NAMES[impl], frames, params,
                          out_hw=(27, 32), plan=plan)
    want = plain(frames, params, out_hw=(27, 32))
    _assert_image_close(impl, got, want, params, (61, 83), (27, 32))


@pytest.mark.parametrize("depth_mode", [False, True])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_params_outside_the_plan_take_the_direct_path(cuda, impl,
                                                      depth_mode):
    """Windows wider than the frame (|scale| above in/out) have more taps
    than the plan holds: those blocks compute from device memory, with the
    same result."""
    kernel, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(9)
    in_hw, out_hw = (61, 83), (24, 32)
    params = fp.identity_params(2, in_hw, out_hw, device=cuda)
    params[:, 1] *= 1.7
    params[1, 3] *= -2.5
    params[1, 2] = 83.0
    if depth_mode:
        frames = 1 + 59 * torch.rand((2, *in_hw, 1), generator=gen,
                                     device=cuda)
        frames[:, ::4, ::3] = 0.0
    else:
        frames = torch.randint(0, 256, (2, *in_hw, 3), generator=gen,
                               device=cuda).to(torch.uint8)
    plan = fp.band_plan(frames.shape, out_hw)
    lo, hi = fp.band_bounds(out_hw[1], in_hw[1], params[:, 2].cpu(),
                            params[:, 3].cpu())
    assert int((hi - lo + 1).max()) > plan.taps_x
    got = kernel(frames, params, out_hw=out_hw, depth_mode=depth_mode)
    want = plain(frames, params, out_hw=out_hw, depth_mode=depth_mode)
    if depth_mode:
        _assert_depth_close(impl, got, want, frames, params, out_hw)
    else:
        _assert_image_close(impl, got, want, params, in_hw, out_hw)


# The shapes of the other model families' paths: dpt-384 (480x640 frames
# and NYU-shaped depth to 384x384; Make3D's laser grid to 384x384, which
# upsamples both axes) and make3d-small (Make3D's grid to 30x40: a row band
# of 21 taps).

@pytest.mark.parametrize("kind", ["identity", "augment"])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_dpt_image_shape(cuda, impl, kind):
    kernel, plain = IMPLS[impl]
    gen = torch.Generator(device=cuda).manual_seed(12)
    frames = torch.randint(0, 256, (2, 480, 640, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    if kind == "augment":
        params = fp.augment_params(gen, 2, (480, 640), (384, 384),
                                   device=cuda)
    else:
        params = fp.identity_params(2, (480, 640), (384, 384), device=cuda)
    got = kernel(frames, params, out_hw=(384, 384))
    want = plain(frames, params, out_hw=(384, 384))
    _assert_image_close(impl, got, want, params, (480, 640), (384, 384))


DEPTH_SHAPES = {  # (raw grid, out_hw, param rows)
    "nyu_to_384": ((480, 640), (384, 384), "identity"),
    "make3d_to_384_upsampled": ((305, 55), (384, 384), "augment"),
    "make3d_to_30x40_21_taps": ((305, 55), (30, 40), "identity")}


@pytest.mark.parametrize("shape", sorted(DEPTH_SHAPES))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_family_depth_shapes(cuda, impl, shape):
    kernel, plain = IMPLS[impl]
    in_hw, out_hw, rows = DEPTH_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(13)
    depth = 1 + 59 * torch.rand((2, *in_hw, 1), generator=gen, device=cuda)
    depth[:, :, in_hw[1] // 3:in_hw[1] // 3 + 5] = 81.0
    depth[:, ::7, ::5] = 0.0
    if rows == "augment":
        params = fp.augment_params(gen, 2, in_hw, out_hw, device=cuda)
    else:
        params = fp.identity_params(2, in_hw, out_hw, device=cuda)
    plan = fp.band_plan(depth.shape, out_hw, itemsize=4, depth_mode=True)
    if shape == "make3d_to_30x40_21_taps":
        assert plan.taps_y == 21
    if shape == "make3d_to_384_upsampled":
        assert in_hw[0] < out_hw[0] and in_hw[1] < out_hw[1]
    got = kernel(depth, params, out_hw=out_hw, depth_mode=True)
    want = plain(depth, params, out_hw=out_hw, depth_mode=True)
    assert bool(torch.isfinite(got).all())
    _assert_depth_close(impl, got, want, depth, params, out_hw)


def _small_state(device):
    model = registry.build(ModelConfig(name="encdec", width_mult=0.25))
    model = steplib.init_params(model, IN_HW, 0, device=device)
    tx = steplib.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    return steplib.TrainState.create(model, tx)


def _copy_state(state):
    model = copy.deepcopy(state.model)
    return steplib.TrainState.create(model, state.tx)


@pytest.mark.parametrize("augment", [False, True])
def test_train_step_with_kernel_matches_plain_preprocess(cuda, augment):
    """One train_step through the kernel against step_on_batch fed by the
    plain preprocess, from the same state, batch and augmentation draw."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    img = torch.randint(0, 256, (4, 40, 56, 3), generator=gen,
                        device=cuda).to(torch.uint8)
    depth = 1 + 59 * torch.rand((4, 15, 11), generator=gen, device=cuda)
    state = _small_state(cuda)
    twin = _copy_state(state)
    kw = dict(input_hw=(32, 48), target_hw=(16, 24))

    before = fp.fused_preprocess.launches
    g1 = torch.Generator(device=cuda).manual_seed(7)
    _, m_kernel = steplib.train_step(state, img, depth, g1, augment=augment,
                                     **kw)
    assert fp.fused_preprocess.launches == before + 2

    g2 = torch.Generator(device=cuda).manual_seed(7)
    if augment:
        draw = fp.draw_augment(g2, 4, device=cuda)
        ip = fp.params_from_draw(draw, (40, 56), (32, 48))
        dp = fp.params_from_draw(draw, (15, 11), (16, 24))
    else:
        ip = fp.identity_params(4, (40, 56), (32, 48), device=cuda)
        dp = fp.identity_params(4, (15, 11), (16, 24), device=cuda)
    images = fp.plain_preprocess(img, ip, out_hw=(32, 48))
    depths = fp.plain_preprocess(depth[..., None], dp, out_hw=(16, 24),
                                 depth_mode=True)[..., 0]
    _, m_plain = steplib.step_on_batch(twin, images, depths)
    for k in ("loss", "rmse", "grad_norm"):
        assert torch.isfinite(m_kernel[k])
        torch.testing.assert_close(m_kernel[k], m_plain[k],
                                   rtol=STEP_LOSS_RTOL, atol=0)
    assert state.step == twin.step == 1


# The live path at batch one: the kernel-fed program against the same
# program fed by the plain preprocess, f32 model: log-depth within 1e-4
# (inputs differ by f32 summation order), rendered LUT indices within 1 of
# each other on at most 1% of the pixels.
LIVE_LOG_TOL = 1e-4
LIVE_INDEX_SHARE = 0.01


def _live_model(device):
    from ann3depth_tpu_torch import serving

    model = registry.build(ModelConfig(name="encdec", width_mult=0.25,
                                       compute_dtype="float32"))
    return serving.prepare_model(steplib.init_params(model, IN_HW, 0), device)


def _assert_live_close(got, want):
    from ann3depth_tpu_torch.live.infer import lut_index_distance

    (gd, gr), (wd, wr) = got, want
    torch.testing.assert_close(gd.log(), wd.log(), rtol=0, atol=LIVE_LOG_TOL)
    d = lut_index_distance(gr.cpu().numpy(), wr.cpu().numpy())
    assert d.max() <= 1 and (d > 0).mean() <= LIVE_INDEX_SHARE


@pytest.mark.parametrize("tta", ["", "flip"])
def test_live_step_with_kernel_matches_plain_at_batch_one(cuda, tta,
                                                          monkeypatch):
    from ann3depth_tpu_torch.live import infer as live

    model = _live_model(cuda)
    gen = torch.Generator(device=cuda).manual_seed(10)
    frame = torch.randint(0, 256, (1, 96, 128, 3), generator=gen,
                          device=cuda).to(torch.uint8)
    kw = dict(input_hw=(32, 48), display_hw=(96, 128), tta=tta)
    before = fp.fused_preprocess.launches
    got = live.live_step(model, frame, **kw)
    assert fp.fused_preprocess.launches == before + (2 if tta else 1)
    monkeypatch.setattr(fp, "fused_preprocess", fp.plain_preprocess)
    want = live.live_step(model, frame, **kw)
    assert got[1].dtype == torch.uint8 and got[1].shape == (1, 96, 128, 3)
    _assert_live_close(got, want)


def test_live_engine_with_smoothing_matches_plain_fed_steps(cuda,
                                                            monkeypatch):
    """LiveEngine (pinned copies, one frame in flight, EMA carry on the
    card, the step a CUDA graph replayed a frame) against a chain of
    plain-fed live_step calls."""
    from ann3depth_tpu_torch.live import infer as live

    model = _live_model(cuda)
    engine = live.LiveEngine(model, (96, 128), (32, 48), smooth=0.8)
    gen = torch.Generator(device=cuda).manual_seed(11)
    frames = torch.randint(0, 256, (4, 96, 128, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    before = fp.fused_preprocess.launches
    replays = engine._graph.replays
    tokens = [engine.submit(frames[0].cpu().numpy())]
    got = []
    for f in frames[1:]:
        tokens.append(engine.submit(f.cpu().numpy()))
        got.append(engine.retrieve(tokens[-2], fetch_depth=True))
    got.append(engine.retrieve(tokens[-1], fetch_depth=True))
    # the kernel runs inside the captured step: no launch from Python
    assert fp.fused_preprocess.launches == before
    assert engine._graph.captures == 1
    assert engine._graph.replays == replays + 4
    monkeypatch.setattr(fp, "fused_preprocess", fp.plain_preprocess)
    carry, has_prev = torch.zeros((1, 16, 24), device=cuda), 0.0
    for i, (depth, rendered, _) in enumerate(got):
        d, r, carry = live.live_step(
            model, frames[i:i + 1], input_hw=(32, 48), display_hw=(96, 128),
            smooth=0.8, prev_log=carry,
            has_prev=torch.tensor(has_prev, device=cuda))
        has_prev = 1.0
        _assert_live_close((torch.from_numpy(depth)[None],
                            torch.from_numpy(rendered)[None]),
                           (d.cpu(), r.cpu()))


def test_serving_graphs_equal_the_eager_program(cuda):
    """`make_serving_fn` on the card: a CUDA graph for each batch size
    (the v1 kernel recorded in it, launched only by the warm call before
    the capture), each replay equal to the eager program bit for bit, and
    a host input copied straight into the graph's static input."""
    from ann3depth_tpu_torch import serving

    model = _live_model(cuda)
    fn = serving.make_serving_fn(model, IN_HW)
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randint(0, 256, (4, 48, 64, 3), generator=gen,
                      device=cuda).to(torch.uint8)
    before = fp.fused_preprocess.launches
    for b in (4, 2, 4, 2):
        got = fn(x[:b]).clone()
        assert torch.equal(got, fn.fn(x[:b]))
    assert fp.fused_preprocess.launches == before + 2 + 4  # warm + eager
    assert fn.captures == len(fn) == 2 and fn.replays == 4
    assert torch.equal(fn(x[:2].cpu()), fn.fn(x[:2]))


# Determinism of the encdec, multiscale and matmul-upsample DPT train steps.
# In the default mode cuDNN may pick nondeterministic algorithms (and cuDNN
# attention's backward sums in no fixed order); torch's deterministic mode
# (which needs CUBLAS_WORKSPACE_CONFIG set before the process's first cuBLAS
# handle, hence a child process) picks deterministic ones and raises on any
# op without a deterministic implementation, as F.interpolate's CUDA
# backward is (a DPT at upsample "resize").
DETERMINISTIC_RUNS = r"""
import json, sys
import torch
torch.use_deterministic_algorithms(True)
from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import step as steplib

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
img = torch.randint(0, 256, (8, 96, 128, 3), generator=gen,
                    device=dev).to(torch.uint8)
depth = 1 + 59 * torch.rand((8, 61, 11), generator=gen, device=dev)


def build(name):
    if name == "dpt-matmul":
        from ann3depth_tpu_torch.models.dpt import DPTDepthNet
        return DPTDepthNet(dim=64, depth=4, heads=2, fusion_features=32,
                           tap_layers=(0, 1, 2, 3), upsample="matmul")
    return registry.build(ModelConfig(name=name, width_mult=0.5))


def run(name):
    model = steplib.init_params(build(name), (64, 96), 0, device=dev)
    state = steplib.TrainState.create(model, steplib.make_optimizer(
        1e-3, warmup_steps=0, total_steps=20))
    draws, losses = torch.Generator(device=dev), []
    for i in range(20):
        draws.manual_seed(i)
        state, m = steplib.train_step(state, img, depth, draws,
                                      input_hw=(64, 96),
                                      target_hw=model.output_hw((64, 96)),
                                      augment=True)
        losses.append(m["loss"])
    return torch.stack(losses).tolist()


print(json.dumps([run(sys.argv[1]), run(sys.argv[1])]))
"""


@pytest.mark.parametrize("name", ["encdec", "multiscale", "dpt-matmul"])
def test_train_steps_are_bitwise_repeatable_in_deterministic_mode(cuda,
                                                                  name):
    """20 augmented train steps, twice from one state and one feed, under
    torch.use_deterministic_algorithms(True): equal losses, bit for bit."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, "-c", DETERMINISTIC_RUNS, name],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    first, second = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(first) == 20 and all(map(math.isfinite, first))
    assert first == second


def test_grad_accum_step_matches_full_batch_step(cuda):
    """One grad_accum=2 step against one full-batch step from the same
    state and batch, bf16 compute: loss and rmse within STEP_LOSS_RTOL; the
    updated params within 2 lr (a flipped first Adam step) everywhere and
    lr/2 on all but 1% of the entries."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    img = torch.randint(0, 256, (8, 40, 56, 3), generator=gen,
                        device=cuda).to(torch.uint8)
    depth = 1 + 59 * torch.rand((8, 15, 11), generator=gen, device=cuda)
    state = _small_state(cuda)
    twin = _copy_state(state)
    kw = dict(input_hw=(32, 48), target_hw=(16, 24))
    before = fp.fused_preprocess.launches
    _, full = steplib.train_step(state, img, depth, **kw)
    _, accum = steplib.train_step(twin, img, depth, grad_accum=2, **kw)
    assert fp.fused_preprocess.launches == before + 2 + 4
    for k in ("loss", "rmse"):
        torch.testing.assert_close(accum[k], full[k], rtol=STEP_LOSS_RTOL,
                                   atol=0)
    lr = 1e-3
    with torch.no_grad():
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(
            state.model.parameters(), twin.model.parameters())])
    assert float(diff.max()) <= 2 * lr + 1e-6
    assert float((diff > lr / 2).float().mean()) <= 0.01


def test_distill_step_with_kernel_matches_plain_preprocess(cuda,
                                                           monkeypatch):
    """One distill_train_step (an encdec teacher into the `small` student,
    so the teacher map is resized x4 down) through the kernel against the
    same step fed by the plain preprocess."""
    teacher = steplib.init_params(registry.build(ModelConfig(
        name="encdec", width_mult=0.25)), IN_HW, 1, device=cuda)
    teacher.eval().requires_grad_(False)
    student = registry.build(ModelConfig(name="small",
                                         compute_dtype="float32"))
    student = steplib.init_params(student, IN_HW, 0, device=cuda)
    tx = steplib.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = steplib.TrainState.create(student, tx)
    twin = _copy_state(state)
    gen = torch.Generator(device=cuda).manual_seed(13)
    img = torch.randint(0, 256, (4, 40, 56, 3), generator=gen,
                        device=cuda).to(torch.uint8)
    depth = 1 + 59 * torch.rand((4, 15, 11), generator=gen, device=cuda)
    kw = dict(input_hw=IN_HW, target_hw=registry.output_hw("small", IN_HW),
              distill_alpha=0.5)
    before = fp.fused_preprocess.launches
    _, got = steplib.distill_train_step(state, teacher, img, depth, **kw)
    assert fp.fused_preprocess.launches == before + 2
    monkeypatch.setattr(fp, "fused_preprocess", fp.plain_preprocess)
    _, want = steplib.distill_train_step(twin, teacher, img, depth, **kw)
    for k in ("loss", "gt_loss", "distill", "rmse", "grad_norm"):
        assert torch.isfinite(got[k])
        torch.testing.assert_close(got[k], want[k], rtol=STEP_LOSS_RTOL,
                                   atol=0)


# ---------------------------------------------------------------------------
# The input pipeline and the K-step CUDA graph (train/dispatch.py). A block
# of K steps replayed from the graph against K eager steps from the same
# pool stream: the JAX scan test's rtol 2e-5 / atol 2e-6 on the params
# (tests/test_scan_dispatch.py:41), the small f32 net on 16x16 scenes.
# ---------------------------------------------------------------------------

def _pool_cfg(tmp_path, sub, data=None, **train):
    import dataclasses

    from ann3depth_tpu_torch.config import get_config

    cfg = get_config("smoke")
    data = {**dict(input_hw=IN_HW, synth_img_hw=(16, 16),
                   synth_depth_hw=(8, 8), synth_n=32, synth_test_n=16,
                   cache_device=True), **(data or {})}
    train = {"steps": 8, "batch_size": 8, "seed": 7, "log_every": 4,
             "checkpoint_every": 8, "eval_every": 0,
             "ckpt_dir": str(tmp_path / sub), **train}
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **data),
        train=dataclasses.replace(cfg.train, **train))


def _train(cfg, tmp_path, sub, **kw):
    from ann3depth_tpu_torch.train import loop

    return loop.train(cfg, workdir=str(tmp_path / sub), progress=False,
                      **kw)


def _assert_params_close(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-6, msg=k)


def _eager_k1(monkeypatch):
    """The loop's K=1 step eager on the card (the twin a graph is held
    against)."""
    from ann3depth_tpu_torch.train import dispatch

    monkeypatch.setattr(dispatch, "eager_reason",
                        lambda state, device: "the eager twin")


@pytest.mark.parametrize("data,train", [
    ({}, {}), ({"augment": True}, {"grad_accum": 2, "ema_decay": 0.9}),
    ({}, {"optimizer": "sgd", "adam_b1": 0.9, "weight_decay": 1e-4})])
def test_graph_blocks_match_eager_steps(cuda, tmp_path, monkeypatch, data,
                                        train):
    before = fp.fused_preprocess.launches
    with monkeypatch.context() as mp:
        _eager_k1(mp)
        eager, m1 = _train(_pool_cfg(tmp_path, "k1", data, **train),
                           tmp_path, "k1")
    per_step = (fp.fused_preprocess.launches - before) // 8
    assert per_step == 2 * train.get("grad_accum", 1)
    before = fp.fused_preprocess.launches
    graph, m4 = _train(_pool_cfg(tmp_path, "k4", data, steps_per_dispatch=4,
                                 **train), tmp_path, "k4")
    # Only the eager first block runs Python: the second one replays.
    assert fp.fused_preprocess.launches - before == 4 * per_step
    assert eager.step == graph.step == 8
    _assert_params_close(eager, graph)
    torch.testing.assert_close(torch.tensor(m4["loss"]),
                               torch.tensor(m1["loss"]), rtol=2e-4, atol=0)


def test_graph_on_the_window_pool_matches_eager_steps(cuda, tmp_path):
    """The graph reads the one active window buffer; the staging thread
    fills the next window on its own stream meanwhile."""
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset

    ds = SyntheticDepthDataset(n=64, img_hw=(96, 128), depth_hw=(48, 64))
    data = {"cache_window_mb": 1, "window_epochs": 2}
    with pytest.MonkeyPatch.context() as mp:
        _eager_k1(mp)
        eager, _ = _train(_pool_cfg(tmp_path, "w1", data, steps=16),
                          tmp_path, "w1", dataset=ds)
    graph, _ = _train(_pool_cfg(tmp_path, "w2", data, steps=16,
                                steps_per_dispatch=2), tmp_path, "w2",
                      dataset=ds)
    _assert_params_close(eager, graph)


def test_device_feed_keeps_order_under_a_delayed_consumer(cuda):
    """The consumer's stream sleeps before it reads each batch, while the
    feed runs ahead through a ring of two pinned buffers: every batch the
    consumer reads still holds its own host bytes."""
    import numpy as np

    from ann3depth_tpu_torch.pipeline.feed import DeviceFeed

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             rng.random((4, 16, 16), dtype=np.float32)) for _ in range(12)]
    feed = DeviceFeed(iter(host), device=cuda, prefetch=1)
    read = []
    for img, dep in feed:
        assert img.device.type == "cuda"
        torch.cuda._sleep(2_000_000)  # ~1 ms of the consumer's stream
        read.append((img.clone(), dep.clone()))
        del img, dep
    torch.cuda.synchronize()
    assert len(read) == 12
    for (img, dep), (want_img, want_dep) in zip(read, host):
        assert np.array_equal(img.cpu().numpy(), want_img)
        assert np.array_equal(dep.cpu().numpy(), want_dep)


def test_a_failed_capture_raises(cuda, tmp_path, monkeypatch):
    """A step that syncs the host cannot be captured: the run raises at
    the capture and trains no step eagerly in its place."""
    from ann3depth_tpu_torch.train import dispatch

    inner = steplib.train_step

    def syncing_step(*args, **kw):
        state, metrics = inner(*args, **kw)
        float(metrics["loss"])  # a host sync: not capturable
        return state, metrics

    monkeypatch.setattr(steplib, "train_step", syncing_step)
    captured = []
    real = dispatch.BlockRunner._capture

    def spy(self, entry):
        captured.append(self.state.step)
        return real(self, entry)

    monkeypatch.setattr(dispatch.BlockRunner, "_capture", spy)
    for k, data in ((4, {}), (1, {}), (1, {"cache_device": False})):
        with pytest.raises(RuntimeError):
            _train(_pool_cfg(tmp_path, f"f{k}{len(data)}", data,
                             steps_per_dispatch=k), tmp_path, "f")
        assert captured.pop() == k and not captured
    torch.cuda.synchronize()


@pytest.mark.parametrize("data,train", [
    ({"cache_device": False, "augment": True}, {"ema_decay": 0.9}),
    ({"augment": True}, {}),
    ({"cache_device": False, "augment": True}, {"grad_accum": 2}),
    ({"cache_device": False}, {"optimizer": "sgd", "adam_b1": 0.9})],
    ids=["host-feed", "pool", "grad-accum-2", "sgd"])
def test_captured_k1_step_equals_the_eager_step(cuda, tmp_path, monkeypatch,
                                                data, train):
    """The loop at K=1 on the card replays a CUDA graph of its step (the
    first step eager, then one capture; the v1 wrapper sees only the
    eager step's launches), from the host feed and from the pool: params,
    optimizer state and the logged losses equal the eager loop's bit for
    bit, with cuDNN's deterministic algorithms (the small net's f32 convs
    may otherwise sum in another order from run to run)."""
    import json

    from ann3depth_tpu_torch.train import dispatch

    made = []
    init = dispatch.BlockRunner.__init__

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(dispatch.BlockRunner, "__init__", kept)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for name in ("eager", "graph"):
        with monkeypatch.context() as mp:
            if name == "eager":
                _eager_k1(mp)
            before = fp.fused_preprocess.launches
            state, last = _train(_pool_cfg(tmp_path, name, data, **train),
                                 tmp_path, name)
            launches = fp.fused_preprocess.launches - before
        with open(tmp_path / name / "metrics.jsonl") as f:
            losses = [json.loads(line)["loss"] for line in f]
        runs[name] = state, last, losses, launches
    (runner,) = made
    accum = train.get("grad_accum", 1)
    assert runner.captures == 1 and runner.replays == 7
    assert runs["eager"][3] == 8 * 2 * accum and runs["graph"][3] == 2 * accum
    assert runs["graph"][2] == runs["eager"][2] and runs["graph"][1] == \
        runs["eager"][1]
    eager, graph = runs["eager"][0], runs["graph"][0]
    for (name, x), y in zip(eager.model.state_dict().items(),
                            graph.model.state_dict().values()):
        assert torch.equal(x, y), name
    for pe, pg in zip(eager.model.parameters(), graph.model.parameters()):
        for k, v in eager.optimizer.state[pe].items():
            assert torch.equal(v, graph.optimizer.state[pg][k]), k


# ---------------------------------------------------------------------------
# int8 (ops/quant.py) and the exported serving program on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,cin,cout,k,stride", [
    ((60, 80), 48, 64, 3, 1), ((30, 40), 64, 128, 3, 2),
    ((30, 40), 128, 64, 1, 1)])
def test_qconv_on_the_card_equals_the_cpu(cuda, hw, cin, cout, k, stride):
    """The int8 products are exact int32 sums and the quantize and
    dequantize are the same f32 ops: the card's answer is the CPU's, bit
    for bit."""
    from ann3depth_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, cin, *hw), generator=gen).to(
        memory_format=torch.channels_last)
    w = 0.1 * torch.randn((cout, cin, k, k), generator=gen)
    want = quant.qconv(x, w, stride)
    got = quant.qconv(x.to(cuda), w.to(cuda), stride)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_qmatmul_on_the_card_equals_the_cpu_and_refuses_small_shapes(cuda):
    from ann3depth_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 576, 384), generator=gen).to(torch.bfloat16)
    w = 0.05 * torch.randn((1536, 384), generator=gen)
    want = quant.qmatmul(x, w)
    got = quant.qmatmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="M > 16"):
        quant.qmatmul(x[:1, :16].to(cuda), w.to(cuda))


def test_exported_program_on_the_card_matches_eager(cuda, tmp_path):
    """A polymorphic and an int8 export of a small encdec, served on the
    card through a CUDA graph of the exported program: equal to the eager
    serving fn, its first call launching the kernel once (the warm call
    before the capture) and replaying the graph once."""
    import dataclasses

    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.config import get_config

    for quant in ("none", "int8"):
        cfg = get_config("make3d-encdec")
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, input_hw=(64, 96)),
            model=dataclasses.replace(cfg.model, width_mult=0.25,
                                      quant=quant))
        model = steplib.init_params(registry.build(cfg.model), (64, 96), 0)
        out = tmp_path / quant
        serving.export_serving(cfg, model, out, raw_hw=(120, 160),
                               device="cuda")
        loaded = serving.load_serving(out)
        eager = serving.make_serving_fn(serving.prepare_model(model, cuda),
                                        (64, 96))
        x = torch.randint(0, 256, (3, 120, 160, 3), dtype=torch.uint8)
        before = fp.fused_preprocess.launches
        got = loaded.predict(x.numpy())
        assert fp.fused_preprocess.launches == before + 1
        assert loaded.fn.captures == loaded.fn.replays == 1
        want = eager(x.to(cuda)).cpu().numpy()
        assert got.shape == want.shape == (3, 32, 48)
        np.testing.assert_allclose(got, want, rtol=EXPORT_RTOL, atol=0,
                                   err_msg=quant)


# ---------------------------------------------------------------------------
# The parallel modes on the card (parallel/): the per-rank shapes of the v1
# kernel, a one-rank NCCL group whose all-reduce moves no value (the step
# and its CUDA graph give the non-distributed numbers bit for bit), and two
# ranks sharing the card over gloo.
# ---------------------------------------------------------------------------

def test_v1_at_the_dpt_per_rank_batch(cuda):
    """dpt-384 b16 on two ranks: each rank's augmented b8 to 384x384."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    frames = torch.randint(0, 256, (8, 480, 640, 3), generator=gen,
                           device=cuda).to(torch.uint8)
    params = fp.augment_params(gen, 8, (480, 640), (384, 384), device=cuda)
    got = fp.fused_preprocess(frames, params, out_hw=(384, 384))
    want = fp.plain_preprocess(frames, params, out_hw=(384, 384))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("k", [1, 4])
def test_one_rank_nccl_step_is_the_single_device_step(cuda, tmp_path, k):
    """A one-rank NCCL group (the step all-reduces its gradients and
    metrics, and under K > 1 the graph captures that all-reduce) gives the
    numbers of the run without a group, bit for bit, with cuDNN's
    deterministic algorithms (the small net computes in f32, whose convs
    may otherwise sum in another order from run to run)."""
    import datetime

    import torch.distributed as dist

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, m_plain = _train(_pool_cfg(
            tmp_path, f"plain{k}", {"augment": True}, steps_per_dispatch=k,
            ema_decay=0.9), tmp_path, f"plain{k}")
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            grouped, m_grouped = _train(_pool_cfg(
                tmp_path, f"nccl{k}", {"augment": True},
                steps_per_dispatch=k, ema_decay=0.9), tmp_path, f"nccl{k}")
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert m_grouped == m_plain
    for (name, x), y in zip(plain.model.state_dict().items(),
                            grouped.model.state_dict().values()):
        assert torch.equal(x, y), name


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two ranks on one card over gloo with CUDA tensors through the CLI:
    they train in lockstep (rank 0 prints the metrics); K > 1 refuses,
    since gloo's collectives cannot be captured in a CUDA graph."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    base = ["train", "--config", "smoke", "--dist-backend", "gloo",
            "--synth-n", "16", "--batch-size", "4", "--steps", "4",
            "--log-every", "2", "--checkpoint-every", "4"]

    def ranks(extra):
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ann3depth_tpu_torch", *base, *extra,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(r)], cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
        return [(p.returncode, *out) for p, out in zip(procs, outs)]

    outs = ranks(["--ckpt-dir", str(tmp_path / "a")])
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-2000:]
    metrics = json.loads(outs[0][1].strip().splitlines()[-1])
    assert math.isfinite(metrics["loss"])
    outs = ranks(["--ckpt-dir", str(tmp_path / "b"), "--cache-device",
                  "--steps-per-dispatch", "2"])
    assert all(rc != 0 for rc, _, _ in outs)
    assert "gloo backend's collectives cannot be captured" in outs[0][2]


# ---------------------------------------------------------------------------
# The capturable sgd rule on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b1,weight_decay", [(0.0, 0.0), (0.9, 1e-4)])
def test_capturable_sgd_on_the_card_matches_the_cpu_rule(cuda, b1,
                                                         weight_decay):
    """The sgd rule on the card (a device-tensor rate) against the same
    rule on the CPU (a float rate) on the same gradients, three steps,
    within 1e-6."""
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(64, 33, generator=gen), torch.randn(17,
                                                            generator=gen)]
    cpu = [torch.nn.Parameter(t.clone()) for t in init]
    dev = [torch.nn.Parameter(t.to(cuda)) for t in init]
    rule = steplib.make_inner_optimizer(lambda c: 0.1 / (c + 1), "sgd",
                                        b1=b1, weight_decay=weight_decay)
    opt_cpu, opt_dev = rule.init(cpu), rule.init(dev)
    assert isinstance(opt_dev, steplib.CapturableSGD)
    assert isinstance(opt_cpu, steplib.CapturableSGD)
    assert isinstance(opt_dev.param_groups[0]["lr"], torch.Tensor)
    assert isinstance(opt_cpu.param_groups[0]["lr"], float)
    for count in range(3):
        for pc, pd in zip(cpu, dev):
            g = torch.randn(pc.shape, generator=gen)
            pc.grad, pd.grad = g.clone(), g.to(cuda)
        rule.apply(opt_cpu, count)
        rule.apply(opt_dev, count)
        for pc, pd in zip(cpu, dev):
            torch.testing.assert_close(pd.detach().cpu(), pc.detach(),
                                       rtol=0, atol=1e-6)
