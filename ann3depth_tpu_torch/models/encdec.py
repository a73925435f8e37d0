"""Encoder-decoder depth CNN.

Counterpart of `ann3depth_tpu/models/encdec.py` (`quant="none"`): a 4x4
space-to-depth stem, three strided-conv encoder stages with one GroupNorm
each, two decoder stages (1x1 projection, bilinear x2, 3x3 conv, projected
additive skip) and an f32 3x3 head whose 1-channel log-depth map is
upsampled x2 to stride 2.

Public layout is the JAX package's: NHWC in, NHWC out. Inside, tensors are
NCHW in channels_last memory, which is the same bytes as NHWC, so the
permutes at the edges are free. Params are f32; with compute_dtype bf16 the
body runs under bf16 autocast and the head in f32.

Points where flax and torch differ, each handled here:
- flax "SAME" pads a stride-2 3x3 conv (0,1) on even sizes, not (1,1):
  `same_padding` computes flax's split and `Conv` pads with F.pad.
- flax's space_to_depth orders channels dy*(f*C) + dx*C + ch;
  F.pixel_unshuffle orders them ch*f*f + dy*f + dx, so the reshape and
  permute are written out.
- flax GroupNorm's eps is 1e-6 (torch's default is 1e-5); its statistics
  are taken in f32 and its output is in the compute dtype.
- Init is flax's lecun_normal (truncated normal, variance 1/fan_in) for
  conv kernels, zero head bias, GroupNorm scale 1 and bias 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# rescaled by this constant so that its variance is exactly 1/fan_in.
_TRUNC_STDDEV = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int):
    """(before, after) padding of flax/XLA "SAME" on one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(weight: torch.Tensor, generator=None):
    """In-place flax lecun_normal for an OIHW conv kernel."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STDDEV
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return weight


class Conv(nn.Module):
    """flax nn.Conv(padding="SAME") on NCHW: OIHW weight, optional bias."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, bias=False):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        k = self.weight.shape[-1]
        ph = same_padding(x.shape[2], k, self.stride)
        pw = same_padding(x.shape[3], k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride)


def space_to_depth(x, factor: int = 2):
    """NHWC [B, H, W, C] -> [B, H/f, W/f, C*f*f], channel dy*(f*C)+dx*C+ch."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


class Stage(nn.Module):
    """Encoder stage: strided conv -> GroupNorm -> relu -> conv -> relu."""

    def __init__(self, in_ch, features, stride=2):
        super().__init__()
        self.conv_down = Conv(in_ch, features, 3, stride)
        self.norm = nn.GroupNorm(8, features, eps=1e-6)
        self.conv_refine = Conv(features, features, 3)

    def forward(self, x):
        x = self.conv_down(x)
        x = F.group_norm(x.float(), self.norm.num_groups, self.norm.weight,
                         self.norm.bias, self.norm.eps).to(x.dtype)
        x = F.relu(x)
        y = self.conv_refine(x)
        return F.relu(x + y)


class UpStage(nn.Module):
    """Decoder stage: 1x1 projection at low res -> bilinear x2 -> 3x3 conv
    + 1x1-projected additive skip."""

    def __init__(self, in_ch, skip_ch, features):
        super().__init__()
        self.proj_down = Conv(in_ch, features, 1)
        self.conv_up = Conv(features, features, 3)
        self.proj_skip = Conv(skip_ch, features, 1)

    def forward(self, x, skip):
        x = self.proj_down(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = self.conv_up(x)
        return F.relu(x + self.proj_skip(skip))


class EncDecDepthNet(nn.Module):
    """x: NHWC [B, H, W, 3] normalized f32 (or the pre-space-to-depth
    [B, H/4, W/4, 48]) -> NHWC [B, H/2, W/2, 1] log-depth f32.

    H and W must be multiples of 16, or the decoder's x2 misses the skip's
    shape."""

    S2D_INPUT_FACTOR = 4

    def __init__(self, width_mult=1.0, compute_dtype=torch.bfloat16,
                 enc_widths=(64, 128, 256)):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.widths = [max(32, int(c * width_mult) // 8 * 8)
                       for c in enc_widths]
        w0, w1, w2 = self.widths
        stem = 3 * self.S2D_INPUT_FACTOR ** 2
        self.enc0 = Stage(stem, w0, stride=1)
        self.enc1 = Stage(w0, w1)
        self.enc2 = Stage(w1, w2)
        self.dec0 = UpStage(w2, w1, w1)
        self.dec1 = UpStage(w1, w0, w0)
        self.head = Conv(w0, 1, 3, bias=True)

    def init_weights(self, generator=None):
        """flax init: lecun_normal conv kernels, zero head bias, GroupNorm
        scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        return self

    def forward(self, x):
        if x.shape[-1] == 3:
            x = space_to_depth(x, self.S2D_INPUT_FACTOR)
        elif x.shape[-1] != 3 * self.S2D_INPUT_FACTOR ** 2:
            raise ValueError(f"expected NHWC RGB or s2d input, got "
                             f"{tuple(x.shape)}")
        # NHWC bytes viewed as NCHW channels_last.
        x = x.permute(0, 3, 1, 2)
        low = self.compute_dtype != torch.float32
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=low):
            x = x.to(self.compute_dtype)
            s0 = self.enc0(x)
            s1 = self.enc1(s0)
            x = self.enc2(s1)
            x = self.dec0(x, s1)
            x = self.dec1(x, s0)
        with torch.autocast(x.device.type, enabled=False):
            y = self.head(x.float())
            y = F.interpolate(y, scale_factor=2, mode="bilinear",
                              align_corners=False)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def width_mult_of(state_dict, enc_widths=(64, 128, 256)):
        """The width_mult that rebuilds a state_dict's widths."""
        return state_dict["enc2.conv_down.weight"].shape[0] / enc_widths[-1]
