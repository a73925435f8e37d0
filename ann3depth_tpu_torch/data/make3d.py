"""Make3D dataset loader (SURVEY §2.1 "Make3D loader", [B:5,7,8]).

Pairs `img-<id>.jpg` images with `depth_sph_corr-<id>.mat` laser depth files
by id stem, decodes the 55x305 `Position3DGrid` depth (channel 3 = depth in
meters), and serves raw uint8 RGB + f32 depth batches.

TPU-first split of work (SURVEY §1 L2): the host does *only* decode and a
cheap integer-factor downscale of the 2272x1704 JPEGs to a bounded raw feed
size (PIL `draft` decodes at 1/2^k during JPEG decode — nearly free); all
precise resizing, normalization, and augmentation happen on device inside
the jitted step (pipeline/preprocess.py, ops/pallas_preprocess.py). Shipping
uint8 at ~2x model resolution keeps H2D bytes small while preserving
downsample quality.

Expected on-disk layout: see data/download.py.

A copy of `ann3depth_tpu/data/make3d.py`, so that the port imports nothing of
the JAX package; tests/test_torch_train_loop.py compares it with the original on a fixture tree.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import List, Tuple

import numpy as np

log = logging.getLogger(__name__)

# Raw frame size the host ships to device (2x the canonical 240x320 input).
DEFAULT_RAW_HW = (480, 640)

_ID_RE = re.compile(r"(?:img|depth_sph_corr)-(.+)\.(?:jpg|mat)$")


def _index_by_id(paths):
    out = {}
    for p in paths:
        m = _ID_RE.search(os.path.basename(p))
        if m:
            out[m.group(1)] = p
    return out


def load_depth_mat(path: str) -> np.ndarray:
    """Decode one Make3D depth .mat -> f32 [305, 55] depth in meters.

    Make3D ships `Position3DGrid` of shape (55, 305, 4) or (305, 55, 4)
    depending on the archive half; channel 3 is depth. We canonicalize to
    (H=305, W=55) — taller than wide, matching image orientation.
    """
    import scipy.io

    mat = scipy.io.loadmat(path)
    grid = mat["Position3DGrid"]
    depth = grid[..., 3].astype(np.float32)
    if depth.shape[0] < depth.shape[1]:  # (55, 305) -> transpose
        depth = depth.T
    return depth


def load_image(path: str, raw_hw=DEFAULT_RAW_HW) -> np.ndarray:
    """Decode a JPEG to uint8 [raw_h, raw_w, 3].

    Uses PIL `draft` to decode at reduced scale inside the JPEG decoder
    (integer factors), then one cheap host resize to the exact raw feed
    shape. The device path does the final model-resolution resize.
    """
    from PIL import Image

    with Image.open(path) as im:
        im.draft("RGB", (raw_hw[1], raw_hw[0]))
        im = im.convert("RGB").resize((raw_hw[1], raw_hw[0]), Image.BILINEAR)
        return np.asarray(im, np.uint8)


class Make3DDataset:
    """Paired Make3D (image, laser depth) examples.

    split="train": Train400Img + Train400Depth
    split="test":  Test134 + Gridlaserdata
    """

    name = "make3d"

    def __init__(self, data_dir: str, split: str = "train",
                 raw_hw=DEFAULT_RAW_HW, depth_hw=None, root: str = None):
        self.raw_hw = tuple(raw_hw)
        # Depth ships at its native laser grid resolution by default; the
        # device resizes to the target. (305, 55) canonical.
        self.depth_hw = depth_hw
        base = root or os.path.join(data_dir, "make3d")
        if split == "train":
            img_glob = os.path.join(base, "Train400Img", "*.jpg")
            dep_glob = os.path.join(base, "Train400Depth", "*.mat")
        elif split == "test":
            img_glob = os.path.join(base, "Test134", "*.jpg")
            dep_glob = os.path.join(base, "Gridlaserdata", "*.mat")
        else:
            raise ValueError(f"split must be train|test, got {split!r}")

        imgs = _index_by_id(glob.glob(img_glob))
        deps = _index_by_id(glob.glob(dep_glob))
        ids = sorted(imgs.keys() & deps.keys())
        if not ids:
            raise FileNotFoundError(
                f"no paired Make3D examples under {base} (split={split}); "
                f"run `python -m ann3depth_tpu download --dataset make3d` "
                f"or stage archives manually (data/download.py)")
        dropped = (len(imgs) - len(ids), len(deps) - len(ids))
        if any(dropped):
            log.warning("make3d %s: dropped %d unpaired images, %d unpaired "
                        "depths", split, *dropped)
        self.pairs: List[Tuple[str, str]] = [(imgs[i], deps[i]) for i in ids]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        img_path, dep_path = self.pairs[i]
        img = load_image(img_path, self.raw_hw)
        depth = load_depth_mat(dep_path)
        if self.depth_hw is not None and depth.shape != tuple(self.depth_hw):
            depth = _resize_depth_np(depth, self.depth_hw)
        return img, depth

    def batches(self, batch_size, *, steps=None, shuffle=True, seed=0,
                drop_remainder=True):
        """Yield stacked raw batches via the shared epoch iterator
        (data/batching.py — one implementation, shared semantics)."""
        from ann3depth_tpu_torch.data.batching import iter_batches

        return iter_batches(self, batch_size, steps=steps, shuffle=shuffle,
                            seed=seed, drop_remainder=drop_remainder)


def _resize_depth_np(depth: np.ndarray, hw) -> np.ndarray:
    """Host-side bilinear depth resize (numpy, half-pixel centers)."""
    h, w = depth.shape
    th, tw = hw
    ys = (np.arange(th) + 0.5) * h / th - 0.5
    xs = (np.arange(tw) + 0.5) * w / tw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    a = depth[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
    b = depth[np.ix_(y0, x1)] * (1 - wy) * wx
    c = depth[np.ix_(y1, x0)] * wy * (1 - wx)
    d = depth[np.ix_(y1, x1)] * wy * wx
    return (a + b + c + d).astype(np.float32)
