"""GroupNorm + ReLU on NHWC bytes: the encoder stages' norm, forward and
backward.

`group_norm_relu(x, weight, bias, groups, eps)` computes the expression that
`models.encdec.Stage` ran before it, `plain_group_norm_relu`:

    relu(F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype))

statistics in f32 over each (image, group), the affine in f32, one rounding
to x's dtype, then the ReLU. x is [B, C, H, W] in channels_last memory (the
NHWC bytes the models keep), bf16 or f32; the output has x's dtype and is
channels_last. A CUDA tensor runs the hand-written kernel
(csrc/group_norm_nhwc.cu), which reads and writes NHWC: PyTorch's CUDA
group_norm copies a channels_last input to plain NCHW and returns NCHW, so
every conv after it got NCHW activations and cuDNN transposed them. A CPU
tensor runs the plain version's own aten calls (`torch.native_group_norm`,
which F.group_norm calls there, and its backward as autograd calls it), so
the CPU path equals the plain expression bit for bit and also yields the
statistics. Any other device raises. A CUDA tensor never falls back.

Both directions are registered torch ops, `torch.ops.ann3depth.
group_norm_relu` (-> y, mean, rstd) and `group_norm_relu_backward` (-> dx,
dweight, dbias), so that an exported program holds each as one node; the
gradient is a `torch.autograd.Function` over the two. A non-channels_last
input is made channels_last first, on any device, and counted in
`group_norm_relu.relayouts` (0 on the models' paths). `group_norm_relu.
launches` and `group_norm_relu_backward.launches` count the kernels' calls
outside CUDA graph capture, as the preprocess wrappers count theirs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ann3depth_tpu_torch.ops import _kernels

THREADS = 128       # a block's threads, where a pixel's lanes allow
MAX_THREADS = 512   # kMaxThreads of the kernels
MAX_ITERS = 16      # pixel rows a thread walks, at most
BLOCKS_PER_SM = 2   # the grid the plan aims for, per SM
MAX_SMEM = 48 * 1024  # dynamic shared memory a launch may take unasked
RED_ROWS = 16       # threads that share a channel of dgamma and dbeta


def plain_group_norm_relu(x, weight, bias, groups, eps):
    """The function in plain torch: the Stage expression the kernel
    replaced."""
    return F.relu(F.group_norm(x.float(), groups, weight, bias,
                               eps).to(x.dtype))


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """The kernels' launch plan (csrc/group_norm_nhwc.cu): elements a
    thread loads at once (16 bytes, or 1), threads across a pixel's
    channels, pixel rows of a block, a block's threads, pixels of a
    block's tile, tiles of an image, and the channels of each dgamma and
    dbeta block of the backward with the count of those blocks."""
    vec: int
    lanes: int
    prows: int
    threads: int
    tile_px: int
    tiles: int
    red_ch: int
    red_blocks: int


@functools.lru_cache(maxsize=256)
def launch_plan(shape, itemsize, aligned, sm_count):
    """The plan for x of `shape` [B, C, H, W] (elements of `itemsize`
    bytes; 16-byte accesses where `aligned` and C allow them) on a card of
    `sm_count` SMs. A thread covers `vec` channels of a pixel, a block
    `prows` pixels at once across all C channels; the rows a thread walks
    halve from MAX_ITERS until the grid holds BLOCKS_PER_SM blocks an SM.
    The backward's dgamma and dbeta blocks give RED_ROWS threads to a
    channel, each summing every RED_ROWS-th (image, tile) row. Raises
    where C is too wide for a block. Cached: a call costs host time."""
    b, c, h, w = shape
    hw = h * w
    per16 = 16 // itemsize
    vec = per16 if aligned and c % per16 == 0 else 1
    lanes = c // vec
    prows = max(1, THREADS // lanes)
    threads = lanes * prows
    if threads > MAX_THREADS or (2 * prows * c + prows) * 4 > MAX_SMEM:
        raise ValueError(f"group_norm_relu: {c} channels are too wide for "
                         f"one block")
    iters = MAX_ITERS
    while iters > 1 and b * -(-hw // (prows * iters)) < BLOCKS_PER_SM * \
            sm_count:
        iters //= 2
    tile_px = prows * iters
    red_ch = max(1, min(c, threads // RED_ROWS))
    return GroupNormPlan(vec, lanes, prows, threads, tile_px,
                         -(-hw // tile_px), red_ch, -(-c // red_ch))


@functools.lru_cache(maxsize=8)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(x, *tensors):
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    return launch_plan(tuple(x.shape), x.element_size(), aligned,
                       _sm_count(x.device))


_LIB_HANDLE = None
_VP, _I32 = ctypes.c_void_p, ctypes.c_int


def _lib():
    """The kernels' library (built at first use) with its ctypes
    signatures declared."""
    global _LIB_HANDLE
    if _LIB_HANDLE is None:
        lib = _kernels.load("group_norm_nhwc")
        lib.group_norm_nhwc_forward.argtypes = (
            [_VP] * 7 + [_I32] * 9 + [ctypes.c_float, _VP])
        lib.group_norm_nhwc_backward.argtypes = [_VP] * 11 + [_I32] * 11 + [
            _VP]
        lib.group_norm_nhwc_error_string.argtypes = [_I32]
        lib.group_norm_nhwc_error_string.restype = ctypes.c_char_p
        for f in (lib.group_norm_nhwc_forward, lib.group_norm_nhwc_backward):
            f.restype = _I32
        _LIB_HANDLE = lib
    return _LIB_HANDLE


def _raise_on(err, what):
    if err:
        msg = _lib().group_norm_nhwc_error_string(err).decode()
        raise RuntimeError(f"group_norm_nhwc {what} failed: {msg} ({err})")


def _check_cuda_args(x, groups, per_channel, like_x=(), stats=()):
    """Raise unless x is a bf16 or f32 channels_last [B, C, H, W] of
    `groups` groups, each of `like_x` matches it, and `per_channel` ([C])
    and `stats` ([B, groups]) are contiguous f32 on its device."""
    if x.ndim != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm_relu takes bf16 or f32 [B, C, H, W], "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, c, h, w = x.shape
    if not (x.numel() and groups > 0 and c % groups == 0):
        raise ValueError(f"group_norm_relu: bad shape {tuple(x.shape)} for "
                         f"{groups} groups")
    for t in (x, *like_x):
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("group_norm_relu's tensors must share x's "
                             "shape, dtype and device, channels_last")
    for shape, tensors in (((c,), per_channel), ((b, groups), stats)):
        for t in tensors:
            if (t.shape != shape or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(f"group_norm_relu's weight and bias must be "
                                 f"contiguous f32 [{c}], its mean and rstd "
                                 f"[{b}, {groups}], on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward_cuda(x, weight, bias, groups, eps):
    _check_cuda_args(x, groups, (weight, bias))
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = _plan(x, y)
    mean = x.new_empty((b, groups), dtype=torch.float32)
    rstd = torch.empty_like(mean)
    part = x.new_empty((b * plan.tiles, groups, 2), dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _lib().group_norm_nhwc_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
            int(x.dtype == torch.bfloat16), int(plan.vec > 1), b, h * w, c,
            groups, plan.threads, plan.tile_px, plan.tiles, eps, _stream(x))
    _raise_on(err, "forward")
    _kernels.count(group_norm_relu)
    return y, mean, rstd


def _backward_cuda(dy, x, y, mean, rstd, weight, groups):
    _check_cuda_args(x, groups, (weight,), (dy, y), (mean, rstd))
    b, c, h, w = x.shape
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    plan = _plan(x, dy, y, dx)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    cpart = x.new_empty((b * plan.tiles, c, 2), dtype=torch.float32)
    gpart = x.new_empty((b * plan.tiles, groups, 2), dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _lib().group_norm_nhwc_backward(
            dy.data_ptr(), x.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), weight.data_ptr(), dx.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr(), cpart.data_ptr(),
            gpart.data_ptr(), int(x.dtype == torch.bfloat16),
            int(plan.vec > 1), b, h * w, c, groups, plan.threads,
            plan.tile_px, plan.tiles, plan.red_ch, plan.red_blocks,
            _stream(x))
    _raise_on(err, "backward")
    _kernels.count(group_norm_relu_backward)
    return dx, dweight, dbias


def _forward_cpu(x, weight, bias, groups, eps):
    b, c, h, w = x.shape
    out, mean, rstd = torch.native_group_norm(x.float(), weight, bias, b, c,
                                              h * w, groups, eps)
    return F.relu(out.to(x.dtype)), mean, rstd


def _backward_cpu(dy, x, y, mean, rstd, weight, groups):
    """Autograd's own calls for the plain expression: the ReLU's
    threshold_backward, the cast back to f32, native_group_norm_backward
    (its inputs already in x's layout), the cast to x's dtype."""
    b, c, h, w = x.shape
    dz = torch.ops.aten.threshold_backward(dy, y, 0).float()
    dx, dweight, dbias = torch.ops.aten.native_group_norm_backward(
        dz, x.float(), mean, rstd, weight, b, c, h * w, groups,
        [True, True, True])
    return dx.to(x.dtype), dweight, dbias


def _fake_forward(x, weight, bias, groups, eps):
    stats = x.new_empty((x.shape[0], groups), dtype=torch.float32)
    return (torch.empty_like(x, memory_format=torch.channels_last), stats,
            torch.empty_like(stats))


def _fake_backward(dy, x, y, mean, rstd, weight, groups):
    return (torch.empty_like(x, memory_format=torch.channels_last),
            torch.empty_like(weight), torch.empty_like(weight))


# The namespace is defined by ops/fused_preprocess.py; this module adds to
# it.
_LIB = torch.library.Library("ann3depth", "FRAGMENT")
_LIB.define("group_norm_relu(Tensor x, Tensor weight, Tensor bias, "
            "int groups, float eps) -> (Tensor, Tensor, Tensor)")
_LIB.define("group_norm_relu_backward(Tensor dy, Tensor x, Tensor y, "
            "Tensor mean, Tensor rstd, Tensor weight, int groups) "
            "-> (Tensor, Tensor, Tensor)")
for _name, _cpu, _cuda, _fake in (
        ("group_norm_relu", _forward_cpu, _forward_cuda, _fake_forward),
        ("group_norm_relu_backward", _backward_cpu, _backward_cuda,
         _fake_backward)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"ann3depth::{_name}", _fake, lib=_LIB)
_FWD = torch.ops.ann3depth.group_norm_relu.default
_BWD = torch.ops.ann3depth.group_norm_relu_backward.default


def _channels_last(t):
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    group_norm_relu.relayouts += 1
    return t.contiguous(memory_format=torch.channels_last)


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y, mean, rstd = _FWD(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, y, mean, rstd, weight)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, mean, rstd, weight = ctx.saved_tensors
        dx, dweight, dbias = group_norm_relu_backward(dy, x, y, mean, rstd,
                                                      weight, ctx.groups)
        return dx, dweight, dbias, None, None


def group_norm_relu(x, weight, bias, groups, eps):
    """relu(group_norm(x) rounded to x's dtype) of channels_last x
    [B, C, H, W] (module docstring); weight and bias [C], taken in f32.
    Differentiable in x, weight and bias."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no group_norm_relu for device {x.device}")
    x = _channels_last(x)
    weight, bias = weight.float(), bias.float()
    groups, eps = int(groups), float(eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormReLU.apply(x, weight, bias, groups, eps)
    return _FWD(x, weight, bias, groups, eps)[0]


def group_norm_relu_backward(dy, x, y, mean, rstd, weight, groups):
    """(dx, dweight, dbias) of `group_norm_relu` from the upstream gradient
    dy, its input x and output y, and the forward's f32 mean and rstd
    [B, groups]. dy is made channels_last if it is not."""
    return _BWD(_channels_last(dy.to(x.dtype)), x, y, mean, rstd, weight,
                groups)


group_norm_relu.launches = 0
group_norm_relu.relayouts = 0
group_norm_relu_backward.launches = 0
