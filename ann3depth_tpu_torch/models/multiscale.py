"""Multi-scale coarse+fine depth CNN.

Counterpart of `ann3depth_tpu/models/multiscale.py`: a shared
space-to-depth stem `Stage` at stride 4; a coarse branch (two strided
`Stage`s to stride 16, a `GlobalContext` block, an f32 1-channel head
upsampled x4 back to stride 4); a fine branch of two `Stage`s at stride 4
on the stem features with the coarse map as one more channel, whose f32
head predicts a residual; then bilinear x2 of coarse + residual to stride
2. It reuses encdec's `Stage`, `Conv` and `space_to_depth`, as the JAX
model does.

Where flax and torch differ, beyond what models/encdec.py handles:
- `GlobalContext` takes the spatial mean, then two `Dense` layers with
  bias (torch Linear, [out, in] weights) in the compute dtype.
- The x4 of the coarse map is the JAX model's `upsample_matmul` in f32,
  and the final x2 (`jax.image.resize` there) is the same function at an
  integer factor: both are `ops.resize.upsample_matmul`, two fixed
  matmuls, whose backward (unlike F.interpolate's on CUDA) sums in a fixed
  order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ann3depth_tpu_torch.models.encdec import (Conv, Stage, head_input,
                                               init_flax_, remat_call,
                                               space_to_depth)
from ann3depth_tpu_torch.ops.resize import upsample_matmul


class GlobalContext(nn.Module):
    """Full-image receptive field: spatial mean -> Dense -> relu -> Dense,
    broadcast-added onto the NCHW input."""

    def __init__(self, features):
        super().__init__()
        self.mlp_in = nn.Linear(features, features)
        self.mlp_out = nn.Linear(features, features)

    def forward(self, x):
        g = x.mean(dim=(2, 3)).to(x.dtype)
        g = self.mlp_out(F.relu(self.mlp_in(g)))
        return x + g.to(x.dtype)[:, :, None, None]


def _up(x, factor):
    """Bilinear integer-factor upsample of an NCHW map, in its dtype, as
    NCHW in channels_last memory (the einsum's result is a permuted view;
    the fine branch's conv would copy it to plain NCHW)."""
    up = upsample_matmul(x.permute(0, 2, 3, 1), factor)
    return up.contiguous().permute(0, 3, 1, 2)


class MultiScaleDepthNet(nn.Module):
    """x: NHWC [B, H, W, 3] normalized f32 (or the pre-space-to-depth
    [B, H/4, W/4, 48]) -> NHWC [B, H/2, W/2, 1] log-depth f32. H and W must
    be multiples of 16."""

    S2D_INPUT_FACTOR = 4
    OUTPUT_STRIDE = 2

    def __init__(self, width_mult=1.0, compute_dtype=torch.bfloat16,
                 remat=False, widths=(64, 128, 256)):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.widths = [max(32, int(c * width_mult) // 8 * 8) for c in widths]
        w0, w1, w2 = self.widths
        self.stem = Stage(3 * self.S2D_INPUT_FACTOR ** 2, w0, stride=1)
        self.coarse1 = Stage(w0, w1)
        self.coarse2 = Stage(w1, w2)
        self.context = GlobalContext(w2)
        self.coarse_head = Conv(w2, 1, 3, bias=True)
        self.fine1 = Stage(w0 + 1, w0, stride=1)
        self.fine2 = Stage(w0, w0, stride=1)
        self.fine_head = Conv(w0, 1, 3, bias=True)

    def init_weights(self, generator=None, input_hw=None):
        """flax init: lecun_normal conv and dense kernels, zero biases,
        GroupNorm scale 1 and bias 0."""
        return init_flax_(self, generator)

    def forward(self, x):
        if x.shape[-1] == 3:
            x = space_to_depth(x, self.S2D_INPUT_FACTOR)
        elif x.shape[-1] != 3 * self.S2D_INPUT_FACTOR ** 2:
            raise ValueError(f"expected NHWC RGB or s2d input, got "
                             f"{tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2)
        dt = self.compute_dtype
        dev = x.device.type
        low = dt != torch.float32

        def run(module, *args):
            return remat_call(self.remat, module, *args)

        # No weight-cast cache, here and below: a CUDA graph cannot capture it.
        with torch.autocast(dev, dtype=dt, enabled=low, cache_enabled=False):
            stem = run(self.stem, x.to(dt))
            c = run(self.coarse2, run(self.coarse1, stem))
            c = self.context(c)
        with torch.autocast(dev, enabled=False):
            coarse = _up(self.coarse_head(head_input(c)), 4)
        with torch.autocast(dev, dtype=dt, enabled=low, cache_enabled=False):
            f = torch.cat([stem, coarse.to(dt)], dim=1)
            f = run(self.fine2, run(self.fine1, f))
        with torch.autocast(dev, enabled=False):
            y = coarse + self.fine_head(head_input(f))
            y = _up(y, 2)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def output_hw(input_hw):
        h, w = input_hw
        return (h // MultiScaleDepthNet.OUTPUT_STRIDE,
                w // MultiScaleDepthNet.OUTPUT_STRIDE)

    @staticmethod
    def width_mult_of(state_dict, widths=(64, 128, 256)):
        """The width_mult that rebuilds a state_dict's widths."""
        return state_dict["coarse2.conv_down.weight"].shape[0] / widths[-1]
