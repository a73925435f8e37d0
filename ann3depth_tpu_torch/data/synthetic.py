"""Synthetic Make3D-shaped dataset for tests, smoke runs, and benchmarks.

Generates deterministic (seeded) RGB/depth pairs with actual image->depth
structure — depth is a smooth function of rendered geometry, so a depth net
can genuinely fit it and integration tests can assert "loss decreases"
(SURVEY.md §4 item 4) rather than just "runs".

Shapes mirror raw Make3D-ish inputs so the full preprocess path is
exercised: RGB uint8 [H, W, 3] at an arbitrary source size, depth f32
[dh, dw] in meters on a different (coarser) grid.

A copy of `ann3depth_tpu/data/synthetic.py`, so that the port imports nothing of
the JAX package; tests/test_torch_train_loop.py compares its scenes with the original's.
"""

from __future__ import annotations

import numpy as np


def make_scene(rng: np.random.Generator, img_hw=(96, 128), depth_hw=(48, 64)):
    """One synthetic scene: vertical-gradient 'ground plane' + boxes.

    Returns (rgb_u8 [H,W,3], depth_f32 [dh,dw] meters in (1, 60]).
    """
    h, w = img_hw
    dh, dw = depth_hw
    # Ground plane: depth grows with distance from the bottom of the image.
    yy = np.linspace(1.0, 0.0, dh, dtype=np.float32)[:, None]
    depth = 2.0 + 50.0 * yy * np.ones((dh, dw), np.float32)

    # A few fronto-parallel boxes at random depths.
    n_boxes = rng.integers(1, 4)
    boxes = []
    for _ in range(n_boxes):
        bd = float(rng.uniform(2.0, 30.0))
        y0, x0 = rng.integers(0, dh // 2), rng.integers(0, dw // 2)
        bh, bw = rng.integers(dh // 6, dh // 2), rng.integers(dw // 6, dw // 2)
        depth[y0:y0 + bh, x0:x0 + bw] = np.minimum(depth[y0:y0 + bh, x0:x0 + bw], bd)
        boxes.append((y0 / dh, x0 / dw, bh / dh, bw / dw, bd))

    # RGB renders the same geometry: brightness encodes inverse depth, boxes
    # get random colors -> the image is genuinely predictive of depth.
    yy_img = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None]
    rgb = 0.2 + 0.5 * yy_img * np.ones((h, w, 3), np.float32)
    for (fy, fx, fh, fw, bd) in boxes:
        y0, x0 = int(fy * h), int(fx * w)
        bh, bw = int(fh * h), int(fw * w)
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32) * (1.0 - bd / 60.0)
        rgb[y0:y0 + bh, x0:x0 + bw] = color
    rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
    rgb_u8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    return rgb_u8, depth


class SyntheticDepthDataset:
    """Iterable of raw (rgb_u8, depth) pairs; API-compatible with the real
    Make3D/NYU dataset classes (data/make3d.py)."""

    name = "synthetic"

    def __init__(self, n=64, img_hw=(96, 128), depth_hw=(48, 64), seed=0):
        self.n = n
        self.img_hw = img_hw
        self.depth_hw = depth_hw
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        rng = np.random.default_rng(self.seed * 100003 + i)
        return make_scene(rng, self.img_hw, self.depth_hw)

    def batches(self, batch_size, *, steps=None, shuffle=True, seed=0,
                drop_remainder=True):
        """Yield stacked raw batches via the shared epoch iterator
        (data/batching.py — one implementation, shared semantics)."""
        from ann3depth_tpu_torch.data.batching import iter_batches

        return iter_batches(self, batch_size, steps=steps, shuffle=shuffle,
                            seed=seed, drop_remainder=drop_remainder)

