"""Fused preprocess: raw frames -> resized, normalized, augmented f32.

Counterpart of `ann3depth_tpu/ops/pallas_preprocess.py`. One function,
driven per frame by a packed `[B, 8]` f32 param row

    (y_start, y_scale, x_start, x_scale, out_scale, brightness, contrast,
     photo)

does a separable antialiased triangle resample with half-pixel centers
(crop-zoom and flip are start/scale values, ops/resize.py), then

- image mode: `(z/255 - mean_c)/std_c` (or `z/255` with norm=False) and,
  where `photo > 0.5`, `(n - m)*contrast + m + brightness` with `m` the mean
  over the whole output frame;
- depth mode (C=1): validity `v = (x > DEPTH_EPS) & (x <= MAKE3D_DEPTH_CAP)`
  on the raw grid, resample `d*v` and `v`, output
  `z/max(zv, 1e-6) * out_scale` where `zv >= 0.5`, else 0.

`fused_preprocess` is the wrapper around the hand-written CUDA kernel
(csrc/fused_preprocess.cu), registered as the torch op
`torch.ops.ann3depth.fused_preprocess`. It dispatches on the tensor's
device: a CPU tensor goes to `plain_preprocess`, the plain PyTorch version
in exact f32 (the port of `oracle_preprocess`); a CUDA tensor goes to the
kernel, or the wrapper raises; any other device raises.

`fused_preprocess_v2` (csrc/fused_preprocess_v2.cu, the port of the TPU
package's v2 kernel) computes the same function with v2's precision: the
row resample R = Ay . X in f32, R rounded to bf16, then the column resample
as a bf16 x bf16 product with f32 sums against T = kron(Ax^T, I_C) in bf16.
Its plain version is `plain_preprocess_v2`, which builds Ay and T as the
JAX wrapper does; the kernel builds each band's weights itself.

Both kernels are one banded shared-memory resample (csrc/band_resample.cuh)
with two precision policies. A block owns `tile_rows` output rows of one
frame; `band_plan` sizes its shared memory from the shapes and the largest
|scale| the param rows may have.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ann3depth_tpu_torch.compat import reference_spec as ref
from ann3depth_tpu_torch.ops import _kernels
from ann3depth_tpu_torch.ops.resize import (triangle_matrix,
                                            triangle_matrix_interleaved,
                                            window_params)

CROP_FRAC = 0.875  # crop-zoom window fraction

PARAM_FIELDS = ("y_start", "y_scale", "x_start", "x_scale", "out_scale",
                "brightness", "contrast", "photo")


# ---------------------------------------------------------------------------
# Parameter packing.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _identity_row(in_hw, out_hw, device):
    h_in, w_in = in_hw
    h_out, w_out = out_hw
    return torch.tensor(
        [0.0, h_in / h_out, 0.0, w_in / w_out, 1.0, 0.0, 1.0, 0.0],
        dtype=torch.float32).to(device)


def identity_params(batch, in_hw, out_hw, *, device=None):
    """[B, 8] params for plain resize + normalize (eval/serving path).

    The row is built once per (shapes, device) and repeated on the device,
    so a call copies nothing from the host (a CUDA graph can capture it)."""
    row = _identity_row(tuple(in_hw), tuple(out_hw),
                        torch.device(device or "cpu"))
    return row[None, :].repeat(batch, 1)


def draw_augment(generator, batch, *, device=None):
    """The random draws of one augmented batch: flip and crop at p=.5, the
    crop offsets U(0,1), brightness U(-.2,.2) and contrast U(.8,1.2).

    Kept apart from the geometry so that one draw can be mapped onto the
    image grid and the depth grid alike (`params_from_draw`)."""
    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)
    return dict(flip=u() < 0.5, crop=u() < 0.5, oy=u(), ox=u(),
                brightness=u(-0.2, 0.2), contrast=u(0.8, 1.2))


def params_from_draw(draw, in_hw, out_hw):
    """Map one `draw_augment` draw onto a source grid -> [B, 8] params."""
    h_in, w_in = in_hw
    h_out, w_out = out_hw
    frac = torch.where(draw["crop"], CROP_FRAC, 1.0).to(torch.float32)
    y_start, y_scale = window_params(h_in, h_out, crop_start=draw["oy"],
                                     crop_frac=frac)
    x_start, x_scale = window_params(w_in, w_out, crop_start=draw["ox"],
                                     crop_frac=frac, flip=draw["flip"])
    photo = torch.ones_like(frac)
    return torch.stack([y_start, y_scale, x_start, x_scale, frac,
                        draw["brightness"], draw["contrast"], photo],
                       dim=1).to(torch.float32)


def augment_params(generator, batch, in_hw, out_hw, device=None):
    """Sample per-example augmentation -> [B, 8] params, with the
    distributions of the JAX package's `augment_params` drawn from a
    `torch.Generator` (whose device must be `device`)."""
    return params_from_draw(draw_augment(generator, batch, device=device),
                            in_hw, out_hw)


def geometry_of(params):
    """Split the packed param rows into named [B] columns."""
    return {name: params[..., i] for i, name in enumerate(PARAM_FIELDS)}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (exact f32).
# ---------------------------------------------------------------------------

def _valid_depth(x):
    return ((x > ref.DEPTH_EPS) & (x <= ref.MAKE3D_DEPTH_CAP)).to(
        torch.float32)


@functools.lru_cache(maxsize=8)
def _rgb_stats(device):
    """(mean, std) f32 [3] of the normalization on `device`, built once
    for each device, so a call copies nothing from the host (a graph can
    capture it). Shared: do not write to them. Built outside any
    inference_mode, so that autograd may save them."""
    with torch.inference_mode(False):
        return (torch.tensor(ref.RGB_MEAN, dtype=torch.float32).to(device),
                torch.tensor(ref.RGB_STD, dtype=torch.float32).to(device))


def _photometric(n, g, dims):
    m = n.mean(dim=dims, keepdim=True)
    shape = (-1,) + (1,) * len(dims)
    jittered = ((n - m) * g["contrast"].reshape(shape) + m
                + g["brightness"].reshape(shape))
    return torch.where(g["photo"].reshape(shape) > 0.5, jittered, n)


def plain_preprocess(frames, params, *, out_hw, norm=True, depth_mode=False):
    """The function of the fused kernel in plain torch, in exact f32.

    frames: u8 or f32 [B, H, W, C]; params: [B, 8] -> f32 [B, h, w, C].
    """
    b, h_in, w_in, c = frames.shape
    h_out, w_out = out_hw
    g = geometry_of(params.to(device=frames.device, dtype=torch.float32))
    ay = triangle_matrix(h_out, h_in, g["y_start"], g["y_scale"])
    ax = triangle_matrix(w_out, w_in, g["x_start"], g["x_scale"])
    x = frames.to(torch.float32)
    if depth_mode:
        v = _valid_depth(x)
        x = x * v
    z = torch.einsum("boh,bhwc->bowc", ay, x)
    z = torch.einsum("bpw,bowc->bopc", ax, z)
    if depth_mode:
        zv = torch.einsum("boh,bhwc->bowc", ay, v)
        zv = torch.einsum("bpw,bowc->bopc", ax, zv)
        d = z / torch.clamp(zv, min=1e-6)
        out_scale = g["out_scale"].reshape(-1, 1, 1, 1)
        return torch.where(zv >= ref.DEPTH_VALID_RESAMPLE_THRESH,
                           d * out_scale, torch.zeros_like(d))
    if norm:
        mean, std = _rgb_stats(frames.device)
        n = (z / 255.0 - mean) / std
    else:
        n = z / 255.0
    return _photometric(n, g, (1, 2, 3))


def _norm_affine(wc, c, device):
    """Per-column (scale, bias) of the normalization on [.., w*C] rows:
    1/(255 sd_c) and -m_c/sd_c for channel c = column % C, rounded from f64
    to f32 as the TPU kernel folds them."""
    s = torch.tensor([1.0 / (255.0 * sd) for sd in ref.RGB_STD],
                     dtype=torch.float32, device=device)
    b = torch.tensor([-m / sd for m, sd in zip(ref.RGB_MEAN, ref.RGB_STD)],
                     dtype=torch.float32, device=device)
    ch = torch.arange(wc, device=device) % c
    return s[ch], b[ch]


def v2_operands(params, in_hw, out_hw, channels):
    """The resample matrices v2 takes as operands: Ay f32 [B, h, H] and
    T = kron(Ax^T, I_C) bf16 [B, W*C, w*C], from the [B, 8] param rows."""
    h_in, w_in = in_hw
    h_out, w_out = out_hw
    g = geometry_of(params.to(torch.float32))
    ay = triangle_matrix(h_out, h_in, g["y_start"], g["y_scale"])
    # With C = 1 the kron is a transposed view; the kernel wants rows.
    t = triangle_matrix_interleaved(w_in, w_out, channels, g["x_start"],
                                    g["x_scale"]).to(torch.bfloat16)
    return ay.contiguous(), t.contiguous()


def plain_preprocess_v2(frames, params, *, out_hw, norm=True,
                        depth_mode=False):
    """The function of the v2 kernel in plain torch.

    frames: u8 or f32 [B, H, W, C]; params: [B, 8] -> f32 [B, h, w, C].
    R = Ay . X in f32, rounded to bf16; Z = R . T with bf16 operands and f32
    sums (the bf16 products are exact in f32, so only the order of the sums
    differs from the kernel); then v1's epilogue.
    """
    params = params.to(device=frames.device, dtype=torch.float32)
    ay, t = v2_operands(params, frames.shape[1:3], out_hw, frames.shape[3])
    return v2_from_operands(frames, params, ay, t, out_hw=out_hw, norm=norm,
                            depth_mode=depth_mode)


def v2_from_operands(frames, params, ay, t, *, out_hw, norm=True,
                     depth_mode=False):
    """`plain_preprocess_v2`'s arithmetic on given operands Ay f32
    [B, h, H] and T bf16 [B, W*C, w*C] (`v2_operands`)."""
    b, h_in, w_in, c = frames.shape
    h_out, w_out = out_hw
    params = params.to(device=frames.device, dtype=torch.float32)
    t = t.to(torch.float32)
    x = frames.to(torch.float32).reshape(b, h_in, w_in * c)
    g = geometry_of(params)

    def resample(x):
        r = torch.bmm(ay, x).to(torch.bfloat16).to(torch.float32)
        return torch.bmm(r, t)

    if depth_mode:
        v = _valid_depth(x)
        z, zv = resample(x * v), resample(v)
        d = z / torch.clamp(zv, min=1e-6)
        out = torch.where(zv >= ref.DEPTH_VALID_RESAMPLE_THRESH,
                          d * g["out_scale"].reshape(-1, 1, 1),
                          torch.zeros_like(d))
    else:
        z = resample(x)
        if norm:
            scale, bias = _norm_affine(w_out * c, c, frames.device)
            n = z * scale + bias
        else:
            n = z / 255.0
        out = _photometric(n, g, (1, 2))
    return out.reshape(b, h_out, w_out, c)


def _bf16_ulps(w):
    """Elementwise bf16 spacing of w >= 0 (0 where w == 0)."""
    _, e = torch.frexp(w)
    return torch.where(w > 0, torch.ldexp(torch.ones_like(w), e - 8),
                       torch.zeros_like(w))


def v2_error_bound(t, *, depth_mode=False, weights_apart=False):
    """How far two correct implementations of the v2 function may differ.

    Two roundings to bf16 may land one ulp apart:

    - R. Both compute R = Ay . X in f32 and round it to bf16; summed in
      another order (or with Ay weights an f32 ulp apart), an R next to a
      bf16 rounding boundary may round one ulp apart. One such flip moves z
      by ulp(R) * max(T).
    - T, where the two build their weights apart (`weights_apart`: the CUDA
      kernel builds its own, `plain_preprocess_v2` takes triangle_matrix's).
      An f32 weight can then differ by a few f32 ulps (the kernel sums the
      band in another order and multiplies by reciprocals where
      triangle_matrix divides), and so round to the neighbouring bf16. Every
      weight of an output's band may flip at once, so z moves by up to
      u = sum over the band of ulp_bf16(weight), taken at the band where it
      is largest, times the largest row value (255 for images, 70 m for
      depth, 1 for Rv's validity band). A weight that is zero on one side
      is at most a few f32 ulps (< 2^-20) on the other: a band has two
      such ends, added to u.

    Everything else agrees to f32 rounding (bf16 products are exact in
    f32). So, with u as above where the weights are built apart and u = 0
    where they are not:

    - image: R < 256 (ulp <= 1), output max-abs <= (max(T) + 255 u) * 1.2
      (largest contrast) / (255 * min sd);
    - depth: R <= 70 (ulp <= 0.5) and Rv <= 1 (ulp <= 2^-8); where the
      validity decisions agree, |d - d'| <= ((0.5 + 70 * 2^-8) * max(T)
      + (70 + 70) u) / 0.5 m, and decisions may differ only where
      |zv - 0.5| <= 2^-8 * max(T) + u.

    t: bf16 [B, W*C, w*C] (`v2_operands`), one output's band per column.
    Returns dict(max_abs=..., decision_band=...).
    """
    w = t.float()
    w_max = float(w.max())
    u = (float(_bf16_ulps(w).sum(dim=-2).max()) + 2 * 2.0 ** -20
         if weights_apart else 0.0)
    if depth_mode:
        return dict(
            max_abs=((0.5 + 70.0 * 2.0 ** -8) * w_max + 140.0 * u) / 0.5
            + 1e-4,
            decision_band=2.0 ** -8 * w_max + u)
    return dict(max_abs=(w_max + 255.0 * u) * 1.2
                / (255.0 * min(ref.RGB_STD)) + 1e-5,
                decision_band=0.0)


def plain_preprocess_s2d(frames, params, *, out_hw, factor=4,
                         out_dtype=torch.bfloat16):
    """RGB preprocess emitting the space-to-depth layout directly.

    Counterpart of `oracle_preprocess_s2d`: the math of
    `plain_preprocess(norm=True)` followed by `space_to_depth(x, factor)`
    and a cast to `out_dtype`, with the (dy, dx) sub-pixel axes carried as
    einsum output dims. Output `[B, h/f, w/f, f*f*C]`, channel index
    `dy*(f*C) + dx*C + ch`.
    """
    b, h_in, w_in, c = frames.shape
    h_out, w_out = out_hw
    f = factor
    if h_out % f or w_out % f:
        raise ValueError(f"out_hw {out_hw} is not divisible by {f}")
    g = geometry_of(params.to(device=frames.device, dtype=torch.float32))
    ay = triangle_matrix(h_out, h_in, g["y_start"], g["y_scale"])
    ax = triangle_matrix(w_out, w_in, g["x_start"], g["x_scale"])
    x = frames.to(torch.float32)
    z = torch.einsum("bqdh,bhwc->bqdwc", ay.reshape(b, h_out // f, f, h_in),
                     x)
    z = torch.einsum("bpew,bqdwc->bqpdec",
                     ax.reshape(b, w_out // f, f, w_in), z)
    mean, std = _rgb_stats(frames.device)
    n = _photometric((z / 255.0 - mean) / std, g, (1, 2, 3, 4, 5))
    return n.reshape(b, h_out // f, w_out // f, f * f * c).to(out_dtype)


# ---------------------------------------------------------------------------
# The kernels' bands and tiling plan.
# ---------------------------------------------------------------------------

TILE_ROWS = 8           # output rows a block owns
SMEM_LIMIT = 232_448    # shared memory a block may use on an H100 (227 KB)


def band_bounds(n_out, n_in, start, scale):
    """The source band [lo, hi] of each output index on one axis, as the
    kernels compute it: src = start + (o + 0.5) * scale - 0.5 rounded step
    by step in f32, r = max(|scale|, 1), lo = max(ceil(src - r), 0), hi =
    min(floor(src + r), n_in - 1). start, scale: [...] -> int64 [..., n_out]
    each; hi < lo where the band is empty."""
    start = torch.as_tensor(start, dtype=torch.float32)[..., None]
    scale = torch.as_tensor(scale, dtype=torch.float32)[..., None]
    o = torch.arange(n_out, dtype=torch.float32, device=start.device)
    src = (start + (o + 0.5) * scale) - 0.5
    r = torch.clamp(scale.abs(), min=1.0)
    lo = torch.clamp(torch.ceil(src - r), min=0).to(torch.int64)
    hi = torch.clamp(torch.floor(src + r), max=n_in - 1).to(torch.int64)
    return lo, hi


def _margin(n_in, r):
    """Room for f32 rounding in a band's span: src and src +- r carry a
    few half-ulps of numbers up to n_in + 2r at each end."""
    return (n_in + 2.0 * r + 1.0) * 2.0 ** -20


def _align16(n):
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """The kernels' tiling (csrc/band_resample.cuh): output rows a block
    owns, source rows it stages, the most taps an output has on each axis,
    the dynamic shared memory of its layout, and blocks per frame."""
    tile_rows: int
    stage_rows: int
    taps_y: int
    taps_x: int
    smem_bytes: int
    tiles: int


def band_plan(shape, out_hw, *, tile_rows=TILE_ROWS, itemsize=1,
              depth_mode=False):
    """The tiling plan for frames of `shape` [B, H, W, C] (elements of
    `itemsize` bytes) resampled to out_hw, for param rows whose |y_scale|
    and |x_scale| are at most H/h and W/w: any window inside the frame,
    which is what identity_params and augment_params give.

    A band on an axis with radius r = max(|scale|, 1) spans at most
    2r + rounding, so it holds floor(2r + margin) + 1 taps; the bands of
    tile_rows consecutive rows start at most (tile_rows - 1) |scale| apart.
    The shared-memory bytes mirror band_layout in band_resample.cuh. A
    block whose bands exceed the plan (params outside those scales) takes
    the kernel's slower direct path, so the plan bounds speed, not results.
    """
    _, h_in, w_in, c = shape
    h_out, w_out = out_hw
    sy, sx = h_in / h_out, w_in / w_out
    ry, rx = max(abs(sy), 1.0), max(abs(sx), 1.0)
    tm = max(1, min(tile_rows, h_out))
    taps_y = min(h_in, math.floor(2 * ry + _margin(h_in, ry)) + 1)
    taps_x = min(w_in, math.floor(2 * rx + _margin(w_in, rx)) + 1)
    stage = min(h_in, math.floor((tm - 1) * abs(sy) + 2 * ry
                                 + _margin(h_in, ry)) + 1)
    n = w_in * c
    smem = (_align16(tm * taps_y * 4) + 2 * _align16(tm * 4)
            + _align16(w_out * taps_x * 4) + 2 * _align16(w_out * 4)
            + _align16((2 if depth_mode else 1) * tm * n * 4)
            + _align16(max(stage * n * itemsize + 16,
                           tm * w_out * c * 4 + 16)))
    return BandPlan(tm, stage, taps_y, taps_x, smem, -(-h_out // tm))


@functools.lru_cache(maxsize=64)
def launch_plan(shape, out_hw, *, itemsize, depth_mode,
                tile_rows=TILE_ROWS):
    """The plan the wrappers launch: `band_plan`, with tile_rows halved
    until the block's shared memory fits the card; raises if one output
    row does not fit. Cached: a wrapper call costs host time."""
    while True:
        plan = band_plan(shape, out_hw, tile_rows=tile_rows,
                         itemsize=itemsize, depth_mode=depth_mode)
        if plan.smem_bytes <= SMEM_LIMIT:
            return plan
        if tile_rows == 1:
            raise ValueError(
                f"frames {tuple(shape)} -> {tuple(out_hw)} need "
                f"{plan.smem_bytes} bytes of shared memory for one output "
                f"row; a block has {SMEM_LIMIT}")
        tile_rows //= 2


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------

_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_LAUNCH = {name: _kernels.bind(name, {
               "launch": [_VP, _I32, _VP, _VP, _VP] + [_I32] * 13})["launch"]
           for name in ("fused_preprocess", "fused_preprocess_v2")}


def _check_cuda_args(frames, params, out_hw, norm, depth_mode):
    if frames.ndim != 4:
        raise ValueError(f"frames must be [B,H,W,C], got {tuple(frames.shape)}")
    b, _, _, c = frames.shape
    if depth_mode:
        if c != 1 or frames.dtype != torch.float32:
            raise ValueError("depth mode takes f32 frames with C=1, got "
                             f"{frames.dtype} C={c}")
    elif frames.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"frames must be uint8 or float32, got {frames.dtype}")
    elif c not in (1, 3) or (norm and c != 3):
        raise ValueError(f"image mode takes C=3 (or C=1 without norm), "
                         f"got C={c}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if (params.shape != (b, 8) or params.dtype != torch.float32
            or params.device != frames.device or not params.is_contiguous()):
        raise ValueError(
            f"params must be contiguous f32 [{b}, 8] on {frames.device}, got "
            f"{params.dtype} {tuple(params.shape)} on {params.device}")
    h_out, w_out = out_hw
    if h_out < 1 or w_out < 1 or not 1 <= b <= 65535:
        raise ValueError(f"bad shapes: batch {b}, out_hw {out_hw}")


def _launch_band(name, frames, params, *, out_hw, norm=True,
                 depth_mode=False, plan=None):
    """One call of the kernel `name` ("fused_preprocess" or
    "fused_preprocess_v2") on CUDA tensors: 2 launches in image mode
    (resample, photometric pass), 1 in depth mode. `plan` defaults to
    `launch_plan`'s. Counts nothing; the wrappers below count their
    calls."""
    out_hw = tuple(int(s) for s in out_hw)
    _check_cuda_args(frames, params, out_hw, norm, depth_mode)
    b, h_in, w_in, c = frames.shape
    h_out, w_out = out_hw
    dev = frames.device
    if plan is None:
        plan = launch_plan(tuple(frames.shape), out_hw,
                           itemsize=frames.element_size(),
                           depth_mode=bool(depth_mode))
    out = torch.empty((b, h_out, w_out, c), dtype=torch.float32, device=dev)
    # One partial sum of each tile for the photometric pass (image mode).
    partials = None if depth_mode else torch.empty(
        (b, plan.tiles), dtype=torch.float32, device=dev)
    _LAUNCH[name](frames, int(frames.dtype == torch.uint8), params, out,
                  partials, b, h_in, w_in, c, h_out, w_out, plan.tile_rows,
                  plan.stage_rows, plan.taps_y, plan.taps_x, plan.smem_bytes,
                  int(norm), int(depth_mode))
    return out


# Both wrappers are registered torch ops (`torch.ops.ann3depth.<name>`,
# `_kernels.define`): the CPU implementation is the plain version, the CUDA
# one the kernel.
_SCHEMA = ("(Tensor frames, Tensor params, int[] out_hw, bool norm, "
           "bool depth_mode) -> Tensor")


def _check_device(frames, name):
    """The ops' fake implementation would answer a meta tensor with an
    empty one: only the CPU and a card run them."""
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {frames.device}")


def _register(name, plain, wrapper):
    def cpu(frames, params, out_hw, norm, depth_mode):
        return plain(frames, params, out_hw=tuple(out_hw), norm=norm,
                     depth_mode=depth_mode)

    def cuda(frames, params, out_hw, norm, depth_mode):
        return _launch_band(name, frames, params, out_hw=out_hw, norm=norm,
                            depth_mode=depth_mode)

    def fake(frames, params, out_hw, norm, depth_mode):
        b, _, _, c = frames.shape
        return frames.new_empty((b, *out_hw, c), dtype=torch.float32)

    return _kernels.define(name + _SCHEMA, wrapper, cuda=cuda, cpu=cpu,
                           fake=fake)


def fused_preprocess(frames, params, *, out_hw, norm=True, depth_mode=False):
    """frames: u8/f32 [B, H, W, C] -> f32 [B, h, w, C].

    params: [B, 8] rows from identity_params/augment_params. depth_mode
    takes C=1 f32 depth and applies out_scale instead of normalization.
    A CPU tensor runs `plain_preprocess`; a CUDA tensor runs the kernel.
    """
    _check_device(frames, "fused_preprocess")
    return _V1(frames, params, [int(s) for s in out_hw], bool(norm),
               bool(depth_mode))


def fused_preprocess_v2(frames, params, *, out_hw, norm=True,
                        depth_mode=False):
    """`fused_preprocess` with v2's precision (module docstring).

    A CPU tensor runs `plain_preprocess_v2`; a CUDA tensor runs the v2
    kernel, from frames and params alone (no Ay or T is built)."""
    _check_device(frames, "fused_preprocess_v2")
    return _V2(frames, params, [int(s) for s in out_hw], bool(norm),
               bool(depth_mode))


_V1 = _register("fused_preprocess", plain_preprocess, fused_preprocess)
_V2 = _register("fused_preprocess_v2", plain_preprocess_v2,
                fused_preprocess_v2)
