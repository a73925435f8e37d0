"""Encoder-decoder depth CNN.

Counterpart of `ann3depth_tpu/models/encdec.py`: a 4x4
space-to-depth stem, three strided-conv encoder stages with one GroupNorm
each, two decoder stages (1x1 projection, bilinear x2, 3x3 conv, projected
additive skip) and an f32 3x3 head whose 1-channel log-depth map is
upsampled x2 to stride 2. Both x2 upsamples are `ops.resize.upsample_matmul`
(the JAX model's `upsample="matmul"`, its default; at an integer factor the
same function as its head's `jax.image.resize`): two fixed matmuls, so the
backward is a GEMM with a fixed summation order, where F.interpolate's CUDA
backward sums with atomics. The decoder's takes its bf16 map to f32 and
rounds the result once; the JAX stage's bf16 einsums round after each
matmul (see `UpStage`). With quant "int8" every stage conv is an int8
`ops.quant.QConv` (the head stays f32), with "int8-qat" its fake-quant
training twin; the params are the same under every quant.

The JAX model's variant fields: `norm="none"` drops each stage's GroupNorm
(and its params); `upsample="resize"` makes the decoder's x2 an
`F.interpolate` bilinear in the compute dtype, cast as JAX's
`.astype(dtype)`; `UpStage(refine=True)` adds a residual 3x3 conv after
the skip. The defaults ("group", "matmul", no refine) are the registry's.

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
- flax's nn.remat of each stage is `remat_call`: activation checkpointing
  (`torch.utils.checkpoint`, non-reentrant) while autograd records.

`Conv`, `same_padding`, `space_to_depth`, `lecun_normal_`, `Stage` and
`remat_call` are shared with the other models, as the JAX models import
them from `encdec`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ann3depth_tpu_torch.ops.resize import upsample_matmul

# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# rescaled by this constant so that its variance is exactly 1/fan_in.
_TRUNC_STDDEV = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int):
    """(before, after) padding of flax/XLA "SAME" on one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(weight: torch.Tensor, generator=None):
    """In-place flax lecun_normal for an OIHW conv kernel or an [out, in]
    dense one: fan_in is everything but the output axis."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STDDEV
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return weight


def init_flax_(model, generator=None):
    """flax's default init on every layer of `model`: lecun_normal conv and
    dense kernels with zero biases, norm scale 1 and bias 0."""
    for m in model.modules():
        if isinstance(m, (Conv, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model


def remat_call(remat: bool, module, *args):
    """module(*args), recomputed in the backward pass instead of keeping its
    activations when `remat` is set and autograd records (flax nn.remat)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class Conv(nn.Module):
    """flax nn.Conv(padding="SAME") on NCHW: OIHW weight, optional bias."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, bias=False):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        return conv2d_same(x, self.weight, self.bias, self.stride)


def conv2d_same(x, weight, bias=None, stride=1):
    """F.conv2d of NCHW x with an OIHW weight, padded as flax "SAME"."""
    k = weight.shape[-1]
    ph = same_padding(x.shape[2], k, stride)
    pw = same_padding(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride)


def space_to_depth(x, factor: int = 2):
    """NHWC [B, H, W, C] -> [B, H/f, W/f, C*f*f], channel dy*(f*C)+dx*C+ch."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


def make_conv(in_ch, out_ch, kernel, stride=1, quant="none"):
    """`Conv` (no bias), or its param-compatible int8 twin
    (`ops.quant.QConv`) for quant "int8", and its fake-quant training twin
    for "int8-qat" (the JAX `_conv`)."""
    if quant in ("int8", "int8-qat"):
        from ann3depth_tpu_torch.ops.quant import QConv
        return QConv(in_ch, out_ch, kernel, stride, qat=quant == "int8-qat")
    if quant != "none":
        raise ValueError(f"unknown quant {quant!r}")
    return Conv(in_ch, out_ch, kernel, stride)


class Stage(nn.Module):
    """Encoder stage: strided conv -> GroupNorm -> relu -> conv -> relu.
    norm "none": no GroupNorm (and no norm params)."""

    def __init__(self, in_ch, features, stride=2, quant="none", norm="group"):
        super().__init__()
        if norm not in ("group", "none"):
            raise ValueError(f"norm must be 'group' or 'none', not {norm!r}")
        self.conv_down = make_conv(in_ch, features, 3, stride, quant)
        self.norm = (nn.GroupNorm(8, features, eps=1e-6) if norm == "group"
                     else None)
        self.conv_refine = make_conv(features, features, 3, quant=quant)

    def forward(self, x):
        x = self.conv_down(x)
        if self.norm is not None:
            x = F.group_norm(x.float(), self.norm.num_groups,
                             self.norm.weight, self.norm.bias,
                             self.norm.eps).to(x.dtype)
        x = F.relu(x)
        y = self.conv_refine(x)
        return F.relu(x + y)


class UpStage(nn.Module):
    """Decoder stage: 1x1 projection at low res -> bilinear x2 (by
    `upsample`: "matmul" or "resize") -> 3x3 conv + 1x1-projected additive
    skip; with `refine`, a 3x3 conv added back (relu after)."""

    def __init__(self, in_ch, skip_ch, features, quant="none",
                 upsample="matmul", refine=False):
        super().__init__()
        if upsample not in ("matmul", "resize"):
            raise ValueError(f"upsample must be 'matmul' or 'resize', not "
                             f"{upsample!r}")
        self.upsample = upsample
        self.proj_down = make_conv(in_ch, features, 1, quant=quant)
        self.conv_up = make_conv(features, features, 3, quant=quant)
        self.proj_skip = make_conv(skip_ch, features, 1, quant=quant)
        self.conv_refine = (make_conv(features, features, 3, quant=quant)
                            if refine else None)

    def forward(self, x, skip):
        x = self.proj_down(x)
        with torch.autocast(x.device.type, enabled=False):
            if self.upsample == "resize":
                up = F.interpolate(x, scale_factor=2, mode="bilinear",
                                   align_corners=False)
            else:
                # NCHW channels_last is NHWC bytes: both permutes are
                # views. The matmuls run in f32 and the result is rounded
                # once to the compute dtype. Rounding after each of the two
                # bf16 matmuls, as the JAX stage does, is the same function
                # but moves the bf16 step further from the JAX step
                # whenever the two sides' inputs differ by a rounding
                # (tests/test_torch_train.py).
                up = upsample_matmul(x.permute(0, 2, 3, 1).float(), 2)
                up = up.to(x.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv_up(up) + self.proj_skip(skip))
        if self.conv_refine is not None:
            x = F.relu(x + self.conv_refine(x))
        return x


class EncDecDepthNet(nn.Module):
    """x: NHWC [B, H, W, 3] normalized f32 (or the pre-space-to-depth
    [B, H/4, W/4, 48]) -> NHWC [B, H/2, W/2, 1] log-depth f32.

    H and W must be multiples of 16, or the decoder's x2 misses the skip's
    shape."""

    S2D_INPUT_FACTOR = 4
    OUTPUT_STRIDE = 2  # input HW -> output HW ratio

    def __init__(self, width_mult=1.0, compute_dtype=torch.bfloat16,
                 enc_widths=(64, 128, 256), remat=False, quant="none",
                 norm="group", upsample="matmul"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.widths = [max(32, int(c * width_mult) // 8 * 8)
                       for c in enc_widths]
        w0, w1, w2 = self.widths
        stem = 3 * self.S2D_INPUT_FACTOR ** 2
        self.enc0 = Stage(stem, w0, stride=1, quant=quant, norm=norm)
        self.enc1 = Stage(w0, w1, quant=quant, norm=norm)
        self.enc2 = Stage(w1, w2, quant=quant, norm=norm)
        self.dec0 = UpStage(w2, w1, w1, quant=quant, upsample=upsample)
        self.dec1 = UpStage(w1, w0, w0, quant=quant, upsample=upsample)
        self.head = Conv(w0, 1, 3, bias=True)  # f32 under every quant

    def init_weights(self, generator=None, input_hw=None):
        """flax init: lecun_normal conv kernels, zero head bias, GroupNorm
        scale 1 and bias 0 (no param depends on input_hw)."""
        return init_flax_(self, generator)

    def forward(self, x):
        if x.shape[-1] == 3:
            x = space_to_depth(x, self.S2D_INPUT_FACTOR)
        elif x.shape[-1] != 3 * self.S2D_INPUT_FACTOR ** 2:
            raise ValueError(f"expected NHWC RGB or s2d input, got "
                             f"{tuple(x.shape)}")
        # NHWC bytes viewed as NCHW channels_last.
        x = x.permute(0, 3, 1, 2)
        low = self.compute_dtype != torch.float32
        # No weight-cast cache: a CUDA graph cannot capture it (the casts
        # are the same values either way).
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=low, cache_enabled=False):
            x = x.to(self.compute_dtype)
            s0 = remat_call(self.remat, self.enc0, x)
            s1 = remat_call(self.remat, self.enc1, s0)
            x = remat_call(self.remat, self.enc2, s1)
            x = remat_call(self.remat, self.dec0, x, s1)
            x = remat_call(self.remat, self.dec1, x, s0)
        with torch.autocast(x.device.type, enabled=False):
            y = self.head(x.float())
            return upsample_matmul(y.permute(0, 2, 3, 1), 2)

    @staticmethod
    def output_hw(input_hw):
        h, w = input_hw
        return (h // EncDecDepthNet.OUTPUT_STRIDE,
                w // EncDecDepthNet.OUTPUT_STRIDE)

    @staticmethod
    def width_mult_of(state_dict, enc_widths=(64, 128, 256)):
        """The width_mult that rebuilds a state_dict's widths."""
        return state_dict["enc2.conv_down.weight"].shape[0] / enc_widths[-1]
