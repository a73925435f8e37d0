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
(csrc/fused_preprocess.cu). It dispatches on the tensor's device: a CPU
tensor goes to `plain_preprocess`, the plain PyTorch version in exact f32
(the port of `oracle_preprocess`); a CUDA tensor goes to the kernel, or the
wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from ann3depth_tpu_torch.compat import reference_spec as ref
from ann3depth_tpu_torch.ops import _kernels
from ann3depth_tpu_torch.ops.resize import triangle_matrix, window_params

CROP_FRAC = 0.875  # crop-zoom window fraction

PARAM_FIELDS = ("y_start", "y_scale", "x_start", "x_scale", "out_scale",
                "brightness", "contrast", "photo")


# ---------------------------------------------------------------------------
# Parameter packing.
# ---------------------------------------------------------------------------

def identity_params(batch, in_hw, out_hw, *, device=None):
    """[B, 8] params for plain resize + normalize (eval/serving path)."""
    h_in, w_in = in_hw
    h_out, w_out = out_hw
    row = torch.tensor(
        [0.0, h_in / h_out, 0.0, w_in / w_out, 1.0, 0.0, 1.0, 0.0],
        dtype=torch.float32, device=device)
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
        mean = torch.tensor(ref.RGB_MEAN, dtype=torch.float32,
                            device=frames.device)
        std = torch.tensor(ref.RGB_STD, dtype=torch.float32,
                           device=frames.device)
        n = (z / 255.0 - mean) / std
    else:
        n = z / 255.0
    return _photometric(n, g, (1, 2, 3))


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
    mean = torch.tensor(ref.RGB_MEAN, dtype=torch.float32,
                        device=frames.device)
    std = torch.tensor(ref.RGB_STD, dtype=torch.float32, device=frames.device)
    n = _photometric((z / 255.0 - mean) / std, g, (1, 2, 3, 4, 5))
    return n.reshape(b, h_out // f, w_out // f, f * f * c).to(out_dtype)


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _kernels.load("fused_preprocess")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_preprocess_launch.argtypes = [
            vp, i32, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
        lib.fused_preprocess_launch.restype = i32
        lib.fused_preprocess_num_partials.argtypes = [i32, i32]
        lib.fused_preprocess_num_partials.restype = i32
        lib.fused_preprocess_error_string.argtypes = [i32]
        lib.fused_preprocess_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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


def fused_preprocess(frames, params, *, out_hw, norm=True, depth_mode=False):
    """frames: u8/f32 [B, H, W, C] -> f32 [B, h, w, C].

    params: [B, 8] rows from identity_params/augment_params. depth_mode
    takes C=1 f32 depth and applies out_scale instead of normalization.
    A CPU tensor runs `plain_preprocess`; a CUDA tensor runs the kernel.
    """
    if frames.device.type == "cpu":
        return plain_preprocess(frames, params, out_hw=out_hw, norm=norm,
                                depth_mode=depth_mode)
    if frames.device.type != "cuda":
        raise ValueError(f"no fused_preprocess for device {frames.device}")
    out_hw = tuple(int(s) for s in out_hw)
    _check_cuda_args(frames, params, out_hw, norm, depth_mode)
    b, h_in, w_in, c = frames.shape
    h_out, w_out = out_hw
    lib = _lib()
    out = torch.empty((b, h_out, w_out, c), dtype=torch.float32,
                      device=frames.device)
    partials = torch.empty(
        (b, lib.fused_preprocess_num_partials(h_out, w_out)),
        dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = lib.fused_preprocess_launch(
            frames.data_ptr(), int(frames.dtype == torch.uint8),
            params.data_ptr(), out.data_ptr(), partials.data_ptr(),
            b, h_in, w_in, c, h_out, w_out, int(norm), int(depth_mode),
            stream)
    if err:
        raise RuntimeError(
            "fused_preprocess launch failed: "
            f"{lib.fused_preprocess_error_string(err).decode()} ({err})")
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0
