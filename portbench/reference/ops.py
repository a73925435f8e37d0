"""Plain layers of the reference models: "SAME" convolutions, bilinear
resampling as matrices, the group norm, and the fp8 control's rounding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0  # largest finite float8 e4m3fn
E5M2_MAX = 57344.0  # largest finite float8 e5m2


def _round(x, dtype, top):
    """x rounded to the float8 `dtype` under a per-tensor scale (amax ->
    top)."""
    scale = top / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(dtype).to(x.dtype) / scale


class Fp8(torch.autograd.Function):
    """x rounded to float8 e4m3 in the forward and its gradient to float8
    e5m2 in the backward, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def lowp_round(lowp, x):
    """x as the control holds a tensor that the program holds in bf16."""
    if not lowp:
        return x
    if lowp != "fp8":
        raise ValueError(f"unknown lowp {lowp!r}")
    return Fp8.apply(x)


def same_pad(size, kernel, stride):
    """(before, after) padding of TensorFlow's "SAME" on one axis: the
    output has ceil(size / stride) positions and the odd pad goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b=None, stride=1, lowp=None):
    """NCHW x, OIHW w, "SAME" padding. Under `lowp` the operands and the
    output are rounded (lowp_round)."""
    x, w = lowp_round(lowp, x), lowp_round(lowp, w)
    k = w.shape[-1]
    ph = same_pad(x.shape[2], k, stride)
    pw = same_pad(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return lowp_round(lowp, F.conv2d(x, w, b, stride))


def resize_matrix(n_out, n_in, device=None):
    """[n_out, n_in] bilinear resize with half-pixel centres; an
    antialiased triangle (radius = the scale) when shrinking. Rows are
    normalised, so taps that fall outside the input are dropped."""
    scale = n_in / n_out
    radius = max(scale, 1.0)
    src = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale - 0.5
    pos = torch.arange(n_in, dtype=torch.float64)
    w = (1.0 - (src[:, None] - pos[None, :]).abs() / radius).clamp(min=0.0)
    w = w / w.sum(dim=1, keepdim=True)
    return w.to(torch.float32).to(device)


def resize_nchw(x, out_hw):
    """Bilinear resize of NCHW x (two matrix products, f32)."""
    h, w = x.shape[2], x.shape[3]
    ay = resize_matrix(out_hw[0], h, x.device)
    ax = resize_matrix(out_hw[1], w, x.device)
    y = torch.einsum("oh,nchw->ncow", ay, x)
    return torch.einsum("pw,ncow->ncop", ax, y)


def upsample(x, factor):
    return resize_nchw(x, (x.shape[2] * factor, x.shape[3] * factor))


def group_norm(x, groups, weight, bias, eps=1e-6):
    n, c, h, w = x.shape
    g = x.reshape(n, groups, c // groups, h, w)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = g.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    g = (g - mean) / torch.sqrt(var + eps)
    return g.reshape(n, c, h, w) * weight[:, None, None] + bias[:, None, None]
