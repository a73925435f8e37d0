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
"""

from __future__ import annotations

import torch


def _f32(v, device=None):
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device or v.device)
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


def upsample_matmul(x, factor: int = 2):
    """Bilinear integer-factor upsample of NHWC `[B, H, W, C]` as two fixed
    matmuls (half-pixel centers, scale 1/f). Runs in x.dtype."""
    b, h, w, c = x.shape
    ay = triangle_matrix(h * factor, h, 0.0, 1.0 / factor,
                         device=x.device).to(x.dtype)
    ax = triangle_matrix(w * factor, w, 0.0, 1.0 / factor,
                         device=x.device).to(x.dtype)
    y = torch.einsum("oh,bhwc->bowc", ay, x)
    return torch.einsum("pw,bowc->bopc", ax, y)


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
