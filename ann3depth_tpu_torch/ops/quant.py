"""Int8 inference quantization: dynamic per-tensor activation scales,
per-output-channel weight scales, int8 x int8 -> int32 products.

Counterpart of `ann3depth_tpu/ops/quant.py`, with the same arithmetic:

  - `quantize_sym`: symmetric quantization to int8 with an f32 scale,
    max(|x|, 1e-8) / 127, rounding half to even (`torch.round`, as
    `jnp.round`).
  - `qconv`: quantize the activation (one scale) and the OIHW kernel (a
    scale per output channel), pad with int8 zeros as flax "SAME" pads,
    gather the windows as int8 (im2col on the NHWC bytes) and multiply with
    `torch._int_mm` into int32, then dequantize `(y * sx) * sk`. Int32 sums
    are exact, so the result equals the JAX `lax.conv_general_dilated` on
    int8 bit for bit.
  - `qmatmul`: the same for `x [..., in] @ weight[out, in]^T`.
  - `fake_quant` / `qconv_fake`: the quantize-dequantize simulation with a
    straight-through gradient, for quantization-aware training.

The modules share their float twins' parameters, so a checkpoint moves
between bf16 training, int8-qat fine-tuning and int8 serving unchanged:
`QConv` is `models.encdec.Conv` (OIHW `weight`), `QLinear` is `nn.Linear`,
`QAttention` is `models.dpt.Attention` (`query`/`key`/`value`/`out`). Each
computes in f32 and int8 with autocast off, and gives its output in the
dtype of its input, which in the models is the compute dtype.

On a CUDA tensor `torch._int_mm` (cuBLASLt) takes more than 16 rows, and
an inner and an output size that are multiples of 8, with the weight as
the transpose of a row-major [out, in] matrix. A shape outside those rules
raises here: nothing falls back to a float product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ann3depth_tpu_torch.models.encdec import Conv, conv2d_same, same_padding
from ann3depth_tpu_torch.models.dpt import Attention

QMAX = 127.0


def _scale(amax):
    """max(amax, 1e-8) / 127 in f32, divided as IEEE divides: CUDA divides
    by a host scalar as a product with its reciprocal, which lands one ulp
    off the JAX package's (and the CPU's) quotient, so the divisor is a
    tensor on amax's device."""
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, QMAX)


def quantize_sym(x, dim=None):
    """Symmetric int8 quantization -> (int8 values, f32 scale).

    dim=None: one scale for the whole tensor (activations); a tuple of dims:
    |max| over those dims, kept (per-output-channel weight scales)."""
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=dim, keepdim=True)
    scale = _scale(amax)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale.to(torch.float32)


def fake_quant(x, dim=None):
    """f32 quantize -> dequantize with a straight-through (identity)
    gradient: the forward is the value the int8 path computes, the backward
    passes the gradient unchanged (dynamic scales clip nothing)."""
    x = x.float()
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim,
                                                           keepdim=True)
    scale = _scale(amax)
    xq = torch.clamp(torch.round(x / scale), -QMAX, QMAX) * scale
    return x + (xq - x).detach()


def _int_mm(a, b_t):
    """int8 a [M, K] @ int8 b_t [N, K]^T -> int32 [M, N]."""
    if a.device.type == "cuda":
        m, k = a.shape
        n = b_t.shape[0]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(
                f"torch._int_mm on CUDA takes M > 16 and K, N multiples of "
                f"8; got M={m}, K={k}, N={n}")
    return torch._int_mm(a.contiguous(), b_t.contiguous().t())


def qconv(x, weight, stride=1):
    """Int8 conv of NCHW x (any float dtype) with an f32 OIHW weight,
    padded as flax "SAME" -> f32 NCHW in channels_last memory."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    xq, sx = quantize_sym(x.float())
    kq, sk = quantize_sym(weight.float(), dim=(1, 2, 3))
    ph = same_padding(h, kh, stride)
    pw = same_padding(w, kw, stride)
    # NHWC bytes (a view of channels_last), padded with int8 zeros.
    xq = F.pad(xq.permute(0, 2, 3, 1), (0, 0, *pw, *ph))
    win = xq.unfold(1, kh, stride).unfold(2, kw, stride)  # [B,Ho,Wo,C,kh,kw]
    ho, wo = win.shape[1], win.shape[2]
    y = _int_mm(win.reshape(b * ho * wo, c * kh * kw),
                kq.reshape(o, c * kh * kw))
    y = (y.float() * sx) * sk.reshape(1, o)
    return y.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def qmatmul(x, weight):
    """Int8 `x [..., in] @ weight[out, in]^T` (f32 weight) -> f32
    [..., out]: one activation scale, a scale per output row of weight."""
    lead = x.shape[:-1]
    xq, sx = quantize_sym(x.float().reshape(-1, x.shape[-1]))
    kq, sk = quantize_sym(weight.float(), dim=(1,))
    y = _int_mm(xq, kq)
    return ((y.float() * sx) * sk.reshape(1, -1)).reshape(*lead, -1)


def qconv_fake(x, weight, stride=1):
    """QAT twin of `qconv`: both operands fake-quantized (straight-through
    gradients), convolved in f32."""
    return conv2d_same(fake_quant(x), fake_quant(weight, dim=(1, 2, 3)),
                       stride=stride)


class QConv(Conv):
    """`Conv` (no bias) computed by `qconv`, or by `qconv_fake` with qat."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, qat=False):
        super().__init__(in_ch, out_ch, kernel, stride)
        self.qat = qat

    def forward(self, x):
        op = qconv_fake if self.qat else qconv
        with torch.autocast(x.device.type, enabled=False):
            return op(x, self.weight, self.stride).to(x.dtype)


class QLinear(nn.Linear):
    """`nn.Linear` with its product in int8 (`qmatmul`), bias added in f32."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return (qmatmul(x, self.weight) + self.bias).to(x.dtype)


class QAttention(Attention):
    """`Attention` with the q/k/v/out projections in int8, step by step as
    the JAX `QMultiHeadAttention`: q scaled by 1/sqrt(d) in f32, scores and
    `w @ v` in the input's dtype, the softmax in f32. No fused attention:
    its online softmax rounds elsewhere."""

    def forward(self, x):
        b, t, e = x.shape
        h = self.heads
        d = e // h
        dt = x.dtype

        def proj(lin, y):
            return qmatmul(y, lin.weight) + lin.bias

        with torch.autocast(x.device.type, enabled=False):
            q = proj(self.query, x).reshape(b, t, h, d)
            k = proj(self.key, x).reshape(b, t, h, d)
            v = proj(self.value, x).reshape(b, t, h, d)
            # An IEEE quotient, as in _scale.
            q = (q / torch.full((), d, dtype=torch.float32,
                                device=q.device).sqrt()).to(dt)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k.to(dt))
            w = torch.softmax(scores.float(), dim=-1).to(dt)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v.to(dt))
            out = proj(self.out, o.float().reshape(b, t, e))
        return out.to(dt)
