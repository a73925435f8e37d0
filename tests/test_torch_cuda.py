"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the kernel and the plain version are both f32 and differ in
summation order only: 1e-4 for normalized images, 1e-3 m for depth.
"""

import pytest
import torch

from ann3depth_tpu_torch.ops import fused_preprocess as fp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
