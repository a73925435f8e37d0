"""Preprocessing of raw frames and depth maps for the model.

Counterpart of `ann3depth_tpu/pipeline/preprocess.py`. Raw uint8 RGB
`[B,H,W,3]` is resized (antialiased triangle, half-pixel centers) to
input_hw, scaled to [0,1] and standardized per channel; the train path adds
flip, crop-zoom and brightness/contrast jitter. Raw f32 depth `[B,dh,dw]`
gets the same geometry with a mask-aware resample to target_hw.

Every function goes through `ops.fused_preprocess.fused_preprocess`, which
runs the CUDA kernel on a CUDA tensor (the JAX package's `use_pallas=True`
branch) and the plain f32 version on a CPU tensor.
"""

from __future__ import annotations

import torch

from ann3depth_tpu_torch.compat import reference_spec as ref
from ann3depth_tpu_torch.ops import fused_preprocess as fp


def _rgb_stats(x):
    mean = torch.tensor(ref.RGB_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(ref.RGB_STD, dtype=x.dtype, device=x.device)
    return mean, std


def normalize_rgb(img_f32):
    """[..., 3] float RGB in [0,1] -> standardized."""
    mean, std = _rgb_stats(img_f32)
    return (img_f32 - mean) / std


def denormalize_rgb(img):
    mean, std = _rgb_stats(img)
    return torch.clamp(img * std + mean, 0.0, 1.0)


def preprocess_image(img_u8, input_hw):
    """uint8 [B, H, W, 3] -> normalized f32 [B, h, w, 3] (no augment)."""
    b, h, w, _ = img_u8.shape
    params = fp.identity_params(b, (h, w), input_hw, device=img_u8.device)
    return fp.fused_preprocess(img_u8, params, out_hw=tuple(input_hw))


def preprocess_depth(depth, target_hw):
    """f32 [B, dh, dw] linear depth -> [B, th, tw] resized."""
    b, dh, dw = depth.shape
    params = fp.identity_params(b, (dh, dw), target_hw, device=depth.device)
    out = fp.fused_preprocess(depth[..., None].contiguous(), params,
                              out_hw=tuple(target_hw), depth_mode=True)
    return out[..., 0]


def preprocess_batch(img_u8, depth, input_hw, target_hw, generator=None):
    """Raw uint8 frames + raw depth -> model-ready (images, depths).

    generator=None -> eval path (plain resize + normalize); a
    `torch.Generator` -> train path with flip/crop/jitter. Image and depth
    share one draw, mapped onto each tensor's own grid, so they flip and
    crop together.
    """
    b, h, w, _ = img_u8.shape
    _, dh, dw = depth.shape
    input_hw, target_hw = tuple(input_hw), tuple(target_hw)
    if generator is None:
        img_params = fp.identity_params(b, (h, w), input_hw,
                                        device=img_u8.device)
        dep_params = fp.identity_params(b, (dh, dw), target_hw,
                                        device=depth.device)
    else:
        draw = fp.draw_augment(generator, b, device=img_u8.device)
        img_params = fp.params_from_draw(draw, (h, w), input_hw)
        dep_params = fp.params_from_draw(draw, (dh, dw), target_hw).to(
            depth.device)
    img = fp.fused_preprocess(img_u8, img_params, out_hw=input_hw)
    dep = fp.fused_preprocess(depth[..., None].contiguous(), dep_params,
                              out_hw=target_hw, depth_mode=True)[..., 0]
    return img, dep
