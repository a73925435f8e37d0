"""Visualization utilities: render (input RGB | ground-truth depth |
predicted depth) triple grids for training and eval observability.

Counterpart of `ann3depth_tpu/utils/viz.py`. Renders to uint8 arrays on the
host with the live path's colormaps (`live.infer.colormap_lut_np`, where
the anchors live); sinks are PNG files (PIL, imported when a PNG is
written).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ann3depth_tpu_torch.compat import reference_spec as ref
from ann3depth_tpu_torch.live.infer import colormap_lut_np


def colormap_depth(depth: np.ndarray, lo: Optional[float] = None,
                   hi: Optional[float] = None,
                   cmap: str = "turbo") -> np.ndarray:
    """f32 [H, W] linear depth -> uint8 [H, W, 3] colormapped rendering
    (cmap: turbo | viridis | magma | gray).

    Log-scaled normalization (depth perception is multiplicative); shared
    lo/hi let GT and prediction use one scale.
    """
    d = np.log(np.maximum(depth, ref.DEPTH_EPS))
    lo = np.log(max(lo, ref.DEPTH_EPS)) if lo is not None else d.min()
    hi = np.log(max(hi, ref.DEPTH_EPS)) if hi is not None else d.max()
    norm = (d - lo) / max(hi - lo, 1e-6)
    idx = np.clip((norm * 255).astype(np.int32), 0, 255)
    return colormap_lut_np(cmap)[idx].astype(np.uint8)


def denormalize_to_u8(img_norm: np.ndarray) -> np.ndarray:
    """Standardized f32 [H, W, 3] -> uint8 RGB."""
    mean = np.asarray(ref.RGB_MEAN, np.float32)
    std = np.asarray(ref.RGB_STD, np.float32)
    x = np.clip(img_norm * std + mean, 0, 1)
    return (x * 255).astype(np.uint8)


def _resize_nn(img: np.ndarray, hw) -> np.ndarray:
    h, w = img.shape[:2]
    yi = (np.arange(hw[0]) * h // hw[0]).clip(0, h - 1)
    xi = (np.arange(hw[1]) * w // hw[1]).clip(0, w - 1)
    return img[np.ix_(yi, xi)]


def triple_grid(images_norm: np.ndarray, depth_gt: np.ndarray,
                depth_pred: np.ndarray, max_rows: int = 4) -> np.ndarray:
    """[B,h,w,3] normalized imgs + [B,h',w'] GT/pred depth -> one grid
    image: rows are examples, columns are (rgb | gt | pred)."""
    b = min(images_norm.shape[0], max_rows)
    hw = images_norm.shape[1:3]
    rows = []
    for i in range(b):
        rgb = denormalize_to_u8(np.asarray(images_norm[i]))
        gt = np.asarray(depth_gt[i])
        pred = np.asarray(depth_pred[i])
        valid = gt[(gt > ref.DEPTH_EPS) & (gt <= ref.MAKE3D_DEPTH_CAP)]
        lo = float(valid.min()) if valid.size else float(pred.min())
        hi = float(valid.max()) if valid.size else float(pred.max())
        gt_img = _resize_nn(colormap_depth(gt, lo, hi), hw)
        pred_img = _resize_nn(colormap_depth(pred, lo, hi), hw)
        rows.append(np.concatenate([rgb, gt_img, pred_img], axis=1))
    return np.concatenate(rows, axis=0)


def save_png(path: str, img_u8: np.ndarray) -> str:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img_u8).save(path)
    return path


def write_triple_summary(workdir: str, step: int, images_norm, depth_gt,
                         depth_pred, tb_writer=None) -> str:
    """Render + persist a triple grid (and write it to `tb_writer`, a
    utils.tb_writer.TensorBoardWriter, when given); returns the PNG path."""
    grid = triple_grid(np.asarray(images_norm), np.asarray(depth_gt),
                       np.asarray(depth_pred))
    path = save_png(os.path.join(workdir, f"triples_step{step:07d}.png"),
                    grid)
    if tb_writer is not None:
        tb_writer.write_image(step, "triples", grid)
    return path
