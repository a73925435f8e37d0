"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the v1 kernel and its plain version are both f32 and differ in
summation order only: 1e-4 for normalized images, 1e-3 m for depth. The v2
kernel and `plain_preprocess_v2` both round the f32 row pass to bf16, so
they may differ by one bf16 ulp of a row-pass value carried through the
column weights (`fp.v2_error_bound`), and in mean by under 1e-4 (images) or
1e-3 m (depth); depth validity decisions may differ only within the bound's
band around zv = 0.5. A train step fed by the kernel and one fed by the plain
preprocess agree to 1e-2 relative in loss: the model computes in bf16
(2^-8 relative), and its inputs differ by f32 summation order only.
"""

import copy

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
    assert float(err.max()) <= fp.v2_error_bound(t)["max_abs"]
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
        fp.v2_error_bound(t)["max_abs"]


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
    bound = fp.v2_error_bound(t, depth_mode=True)
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
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=cuda)
    ay, t = fp.v2_operands(params, (8, 8), (4, 4), 3)
    with pytest.raises(ValueError, match="ay must be"):
        fp.launch_v2(frames, params, ay, t.float(), out_hw=(4, 4))


def _small_state(device):
    model = registry.build(ModelConfig(name="encdec", width_mult=0.25))
    model = steplib.init_params(model, 0, device=device)
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
