"""Resampling weight math, as torch tensor code.

Counterpart of `ann3depth_tpu/ops/resize.py`. A 1-D resize (antialiased,
with optional crop and mirror) is `out = W @ in` with the row-normalized
triangle kernel

    src(o) = start + (o + 0.5) * scale - 0.5          # half-pixel centers
    r      = max(|scale|, 1)                           # antialias radius
    W[o,i] = max(0, 1 - |src(o) - i| / r);  W /= max(W.sum(axis=1), 1e-8)

Crop changes (start, scale) to the source window; a horizontal flip is a
negative scale anchored at the window's right edge. `start` and `scale`
may be Python floats or tensors of any batch shape `[...]`; the matrices
then come back as `[..., out, in]`.

`upsample_aligned_nhwc`, DPT-Large's align_corners=True upsample, runs a
hand-written CUDA kernel pair on a CUDA tensor (csrc/upsample_aligned_nhwc.cu:
a lerp in f32 on the NHWC bytes forward, a gather backward), registered as
the torch ops `torch.ops.ann3depth.upsample_aligned_nhwc` and
`upsample_aligned_nhwc_backward` (CUDA and fake kernels); on a CPU tensor
it runs two batched GEMMs by fixed (hi, lo) matrices (`_pair_resize`).
`upsample_aligned_nhwc.launches` and `upsample_aligned_nhwc_backward.
launches` count the kernels' calls outside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from ann3depth_tpu_torch.ops import _kernels


def _f32(v, device=None):
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device or v.device)
    if isinstance(v, (int, float)):
        # torch.full copies nothing from the host (a graph can capture it)
        return torch.full((), v, dtype=torch.float32, device=device)
    return torch.tensor(v, dtype=torch.float32, device=device)


def window_params(in_size, out_size, *, crop_start=None, crop_frac=1.0,
                  flip=None):
    """(start, scale) f32 tensors for resampling a source window to out_size.

    crop_start: [0,1] position of the crop window within the slack (None ->
      centered); crop_frac: window size as a fraction of the source;
    flip: bool (tensor) -- mirror the window.
    """
    win = in_size * crop_frac
    scale = win / out_size
    if crop_start is None:
        off = (in_size - win) * 0.5
    else:
        off = crop_start * (in_size - win)
    start = off
    if flip is not None:
        flip = torch.as_tensor(flip)
        # src'(o) = (off + win) + (o + 0.5) * (-scale) - 0.5 reverses the
        # output columns of the unflipped window.
        start = torch.where(flip, _f32(off + win), _f32(start))
        scale = torch.where(flip, -_f32(scale), _f32(scale))
    return _f32(start), _f32(scale)


def _triangle(out_size, in_size, start, scale, device):
    start = _f32(start, device)[..., None, None]
    scale = _f32(scale, device)[..., None, None]
    o = torch.arange(out_size, dtype=torch.float32, device=start.device)
    i = torch.arange(in_size, dtype=torch.float32, device=start.device)
    src = start + (o[:, None] + 0.5) * scale - 0.5
    r = torch.clamp(scale.abs(), min=1.0)
    return torch.clamp(1.0 - (src - i[None, :]).abs() / r, min=0.0)


def triangle_matrix(out_size: int, in_size: int, start, scale, *,
                    device=None):
    """Row-normalized triangle resize matrix `[..., out_size, in_size]`."""
    w = _triangle(out_size, in_size, start, scale, device)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-8)


def triangle_matrix_interleaved(in_size: int, out_size: int, channels: int,
                                start, scale, *, device=None):
    """`[..., in*C, out*C]` column-resize matrix for channel-interleaved
    rows, i.e. kron(Ax^T, I_C): rows index (position k//C, channel k%C) of
    the input, columns those of the output."""
    ax = triangle_matrix(out_size, in_size, start, scale, device=device)
    eye = torch.eye(channels, dtype=torch.float32, device=ax.device)
    t = ax.transpose(-1, -2)[..., :, None, :, None] * eye[:, None, :]
    return t.reshape(*ax.shape[:-2], in_size * channels, out_size * channels)


@functools.lru_cache(maxsize=64)
def _upsample_matrix(size: int, factor: int, dtype, device):
    """The fixed `[size*factor, size]` matrix of an integer-factor
    upsample, built once per (size, factor, dtype, device): a model's
    forward then launches no kernel to build it. Built outside any
    inference_mode, so that autograd may save it."""
    with torch.inference_mode(False):
        return triangle_matrix(size * factor, size, 0.0, 1.0 / factor,
                               device=device).to(dtype)


def upsample_matmul(x, factor: int = 2):
    """Bilinear integer-factor upsample of NHWC `[B, H, W, C]` as two fixed
    matmuls (half-pixel centers, scale 1/f). Runs in x.dtype."""
    b, h, w, c = x.shape
    ay = _upsample_matrix(h, factor, x.dtype, x.device)
    ax = _upsample_matrix(w, factor, x.dtype, x.device)
    y = torch.einsum("oh,bhwc->bowc", ay, x)
    return torch.einsum("pw,bowc->bopc", ax, y)


def upsample_matmul_nhwc(x, factor: int = 2):
    """`upsample_matmul` as two batched GEMMs on the NHWC bytes: the rows
    as [B, H, W*C], then the columns as [B*H*f, W, C]. The same function
    (the same fixed matrices, in x.dtype), but its result is contiguous
    NHWC, where einsum's is a permuted view that a conv after it copies,
    and its backward is GEMMs on contiguous operands too. The two round
    apart by an ulp at some shapes, so encdec, multiscale and live keep
    `upsample_matmul` and their numbers; only DPT's "matmul" runs this."""
    b, h, w, c = x.shape
    ay = _upsample_matrix(h, factor, x.dtype, x.device)
    ax = _upsample_matrix(w, factor, x.dtype, x.device)
    y = torch.bmm(ay.expand(b, -1, -1), x.reshape(b, h, w * c))
    n = b * h * factor
    y = torch.bmm(ax.expand(n, -1, -1), y.view(n, w, c))
    return y.view(b, h * factor, w * factor, c)


@functools.lru_cache(maxsize=64)
def _aligned_upsample_matrix(size: int, factor: int, dtype, device):
    """The fixed `[size*factor, size]` matrix of an align_corners=True
    upsample, as a pair (hi, lo) in `dtype`: output o samples the input at
    o * (size - 1) / (size*factor - 1), between its two nearest positions
    (the first and last samples are the corners). The weights are
    fractions of size*factor - 1, which a 16-bit dtype rounds so that a
    row no longer sums to 1; there lo holds what hi misses (hi + lo is the
    exact weight to about 16 bits), elsewhere lo is None. Used on the CPU
    only: a CUDA tensor runs the kernel, which takes its weights from
    integers (csrc/upsample_aligned_nhwc.cu)."""
    n = size * factor
    with torch.inference_mode(False):
        src = (torch.arange(n, dtype=torch.float64)
               * ((size - 1) / max(n - 1, 1)))
        left = src.floor()
        frac = src - left
        right = (left + 1).clamp(max=size - 1)
        m = torch.zeros(n, size, dtype=torch.float64)
        rows = torch.arange(n)
        m[rows, left.long()] += 1.0 - frac
        m[rows, right.long()] += frac
        hi = m.to(dtype)
        lo = (None if torch.finfo(dtype).bits >= 32
              else (m - hi.double()).to(dtype=dtype, device=device))
        return hi.to(device), lo


def _pair_bmm(hi, lo, x):
    """(hi + lo) @ x over x's batch: both products in one GEMM's f32
    accumulator (baddbmm adds lo @ x in its epilogue), rounded to x.dtype
    once; hi @ x where lo is None."""
    n = x.shape[0]
    if lo is None:
        return torch.bmm(hi.expand(n, -1, -1), x)
    return torch.baddbmm(torch.bmm(lo.expand(n, -1, -1), x),
                         hi.expand(n, -1, -1), x)


def _pair_resize(x, ay, ax):
    """NHWC x resized by the (hi, lo) pairs `ay` of its rows and `ax` of
    its columns, as two batched GEMMs on the NHWC bytes."""
    b, h, w, c = x.shape
    ho, wo = ay[0].shape[0], ax[0].shape[0]
    y = _pair_bmm(*ay, x.reshape(b, h, w * c))
    y = _pair_bmm(*ax, y.view(b * ho, w, c))
    return y.view(b, ho, wo, c)


class _PairUpsample(torch.autograd.Function):
    """`_pair_resize` whose backward is `_pair_resize` by the transposed
    pairs, so that the gradient too sums hi and lo before it rounds
    (autograd would round each product apart, and lo's share is under
    half an ulp)."""

    @staticmethod
    def forward(ctx, x, ay_hi, ay_lo, ax_hi, ax_lo):
        ctx.save_for_backward(ay_hi, ay_lo, ax_hi, ax_lo)
        return _pair_resize(x, (ay_hi, ay_lo), (ax_hi, ax_lo))

    @staticmethod
    def backward(ctx, g):
        ay_hi, ay_lo, ax_hi, ax_lo = ctx.saved_tensors
        dx = _pair_resize(g.contiguous(), (ay_hi.mT, ay_lo.mT),
                          (ax_hi.mT, ax_lo.mT))
        return dx, None, None, None, None


# ---------------------------------------------------------------------------
# The align_corners=True upsample kernel (csrc/upsample_aligned_nhwc.cu).
# ---------------------------------------------------------------------------

INDEX_LIMIT = 2 ** 31  # the kernels' tap arithmetic is in 32-bit ints


def _factor(factor):
    """factor as a Python int >= 1, or raise."""
    try:
        f = operator.index(factor)
    except TypeError:
        f = None
    if f is None or isinstance(factor, bool) or f < 1:
        raise ValueError(f"upsample_aligned_nhwc takes an integer factor "
                         f">= 1, got {factor!r}")
    return f


_LIB_HANDLE = None
_VP, _I32 = ctypes.c_void_p, ctypes.c_int


def _lib():
    """The kernels' library (built at first use) with its ctypes
    signatures declared."""
    global _LIB_HANDLE
    if _LIB_HANDLE is None:
        lib = _kernels.load("upsample_aligned_nhwc")
        for f in (lib.upsample_aligned_nhwc_forward,
                  lib.upsample_aligned_nhwc_backward):
            f.argtypes = [_VP] * 2 + [_I32] * 6 + [_VP]
            f.restype = _I32
        lib.upsample_aligned_nhwc_error_string.argtypes = [_I32]
        lib.upsample_aligned_nhwc_error_string.restype = ctypes.c_char_p
        _LIB_HANDLE = lib
    return _LIB_HANDLE


def _raise_on(err, what):
    if err:
        msg = _lib().upsample_aligned_nhwc_error_string(err).decode()
        raise RuntimeError(f"upsample_aligned_nhwc {what} failed: {msg} "
                           f"({err})")


def _check_cuda_arg(t, factor, what):
    """Raise unless t is a non-empty contiguous bf16 or f32 [B, H, W, C]
    that the kernels' 16-byte accesses take (C a multiple of 16 bytes'
    elements, the data 16-byte aligned) and whose axes their 32-bit tap
    arithmetic holds (o * (n - 1) for every output o of an axis of n
    inputs)."""
    if t.ndim != 4 or t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"upsample_aligned_nhwc takes bf16 or f32 "
                         f"[B, H, W, C], got {t.dtype} {tuple(t.shape)} "
                         f"as {what}")
    if not t.is_contiguous():
        raise ValueError(f"upsample_aligned_nhwc takes a contiguous NHWC "
                         f"{what}, got strides {t.stride()}")
    if not t.numel():
        raise ValueError(f"upsample_aligned_nhwc: empty {what} "
                         f"{tuple(t.shape)}")
    per16 = 16 // t.element_size()
    if t.shape[3] % per16 or t.data_ptr() % 16:
        raise ValueError(f"upsample_aligned_nhwc takes 16-byte vectors of "
                         f"channels: C a multiple of {per16} and 16-byte "
                         f"aligned data, got C = {t.shape[3]} at "
                         f"{t.data_ptr() % 16} bytes past 16 as {what}")
    big = max(t.shape[1:3]) * (factor if what == "input" else 1)
    if big * big >= INDEX_LIMIT:
        raise ValueError(f"upsample_aligned_nhwc: {tuple(t.shape)} by "
                         f"{factor} is too large for the kernels")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cuda(x, factor):
    _check_cuda_arg(x, factor, "input")
    b, h, w, c = x.shape
    y = x.new_empty((b, h * factor, w * factor, c))
    with torch.cuda.device(x.device):
        err = _lib().upsample_aligned_nhwc_forward(
            x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
            b, h, w, c, factor, _stream(x))
    _raise_on(err, "forward")
    _kernels.count(upsample_aligned_nhwc)
    return y


def _backward_cuda(grad, factor):
    _check_cuda_arg(grad, factor, "gradient")
    b, hf, wf, c = grad.shape
    if hf % factor or wf % factor:
        raise ValueError(f"upsample_aligned_nhwc_backward: a gradient of "
                         f"{tuple(grad.shape)} is no upsample by {factor}")
    h, w = hf // factor, wf // factor
    dx = grad.new_empty((b, h, w, c))
    with torch.cuda.device(grad.device):
        err = _lib().upsample_aligned_nhwc_backward(
            grad.data_ptr(), dx.data_ptr(),
            int(grad.dtype == torch.bfloat16), b, h, w, c, factor,
            _stream(grad))
    _raise_on(err, "backward")
    _kernels.count(upsample_aligned_nhwc_backward)
    return dx


def _fake_forward(x, factor):
    b, h, w, c = x.shape
    return x.new_empty((b, h * factor, w * factor, c))


def _fake_backward(grad, factor):
    b, h, w, c = grad.shape
    return grad.new_empty((b, h // factor, w // factor, c))


# The namespace is defined by ops/fused_preprocess.py; this module adds to
# it.
_LIB = torch.library.Library("ann3depth", "FRAGMENT")
_LIB.define("upsample_aligned_nhwc(Tensor x, int factor) -> Tensor")
_LIB.define("upsample_aligned_nhwc_backward(Tensor grad, int factor) "
            "-> Tensor")
for _name, _cuda, _fake in (
        ("upsample_aligned_nhwc", _forward_cuda, _fake_forward),
        ("upsample_aligned_nhwc_backward", _backward_cuda, _fake_backward)):
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"ann3depth::{_name}", _fake, lib=_LIB)
_UP_FWD = torch.ops.ann3depth.upsample_aligned_nhwc.default
_UP_BWD = torch.ops.ann3depth.upsample_aligned_nhwc_backward.default


class _AlignedUpsample(torch.autograd.Function):
    """The kernel, whose backward is the gather kernel: nothing is saved
    but the factor (the gradient's shape gives the input's)."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return _UP_FWD(x, factor)

    @staticmethod
    def backward(ctx, g):
        return upsample_aligned_nhwc_backward(g, ctx.factor), None


def upsample_aligned_nhwc(x, factor: int = 2):
    """Bilinear integer-factor upsample of NHWC `[B, H, W, C]` with
    align_corners=True (`F.interpolate(..., align_corners=True)`), in
    x.dtype, with a contiguous NHWC result and a backward without atomics
    (two runs agree bit for bit). A CUDA tensor (contiguous, bf16 or f32,
    C a multiple of 16 bytes' elements, 16-byte aligned: else ValueError)
    runs the kernels: weights from integers, exact to f32 rounding, a lerp
    in f32 rounded once, the backward a gather summed in f32 and rounded
    once; it never falls back. A CPU tensor runs `upsample_matmul_nhwc`'s
    two batched GEMMs by the (hi, lo) matrices of `_aligned_upsample_matrix`
    (weights held to about 16 bits in bf16, as F.interpolate holds them in
    f32). Either way a constant map stays constant in bf16."""
    factor = _factor(factor)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and x.requires_grad:
            return _AlignedUpsample.apply(x, factor)
        return _UP_FWD(x, factor)
    _, h, w, _ = x.shape
    ay = _aligned_upsample_matrix(h, factor, x.dtype, x.device)
    ax = _aligned_upsample_matrix(w, factor, x.dtype, x.device)
    if ay[1] is None:
        return _pair_resize(x, ay, ax)
    return _PairUpsample.apply(x, *ay, *ax)


def upsample_aligned_nhwc_backward(grad, factor: int = 2):
    """The gradient of `upsample_aligned_nhwc`'s input from its output's
    CUDA `grad` [B, H*factor, W*factor, C] (made contiguous if it is not):
    the gather kernel."""
    return _UP_BWD(grad.contiguous(), _factor(factor))


upsample_aligned_nhwc.launches = 0
upsample_aligned_nhwc_backward.launches = 0


def upsample2x_matmul(x):
    """Bilinear x2 upsample as two fixed matmuls (see upsample_matmul)."""
    return upsample_matmul(x, 2)


def resample_2d(x, out_hw, y_start=0.0, y_scale=None, x_start=0.0,
                x_scale=None):
    """Exact-f32 2-D resample of one `[H, W, C]` image via two einsums."""
    h_in, w_in, _ = x.shape
    h_out, w_out = out_hw
    if y_scale is None:
        y_scale = h_in / h_out
    if x_scale is None:
        x_scale = w_in / w_out
    ay = triangle_matrix(h_out, h_in, y_start, y_scale, device=x.device)
    ax = triangle_matrix(w_out, w_in, x_start, x_scale, device=x.device)
    y = torch.einsum("oh,hwc->owc", ay, x.to(torch.float32))
    return torch.einsum("pw,owc->opc", ax, y)
