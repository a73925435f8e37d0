"""NYU Depth v2 loader (SURVEY §2.1 "NYU loader", [B:9]).

Reads the labeled subset `nyu_depth_v2_labeled.mat` — a MATLAB v7.3 (HDF5)
file with datasets `images` (N,3,W,H uint8) and `depths` (N,W,H f32 meters)
— via h5py, lazily per index so the 2.8 GB file is never materialized.

Canonical orientation: HDF5 stores W-major; we transpose to [H=480, W=640].

Split resolution (best available evidence first):
  1. Official `splits.mat` next to the labeled file (the standard 795/654
     split: `trainNdxs`/`testNdxs`, 1-based MATLAB indices).
  2. Scene-based alternation parsed from the labeled file's own `scenes`
     dataset (unique scenes in order of first appearance; even -> train,
     odd -> test). NYU labeled images are consecutive frames grouped by
     scene, so any image-level split leaks near-duplicate frames across
     splits — scene granularity is the minimum sound unit.
  3. Every-other-IMAGE fallback (deterministic but leaky) with a loud
     warning; only hit on synthetic fixtures lacking scene metadata.

A copy of `ann3depth_tpu/data/nyu.py`, so that the port imports nothing of
the JAX package; tests/test_torch_train_loop.py compares it with the original and tests/test_torch_data.py reads fixtures with both.
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

import numpy as np

log = logging.getLogger(__name__)

MAT_NAME = "nyu_depth_v2_labeled.mat"
SPLITS_NAME = "splits.mat"


def _decode_matlab_string(f, ref) -> str:
    """Dereference a MATLAB-v7.3 char-array object ref to a Python str."""
    return "".join(map(chr, np.asarray(f[ref]).ravel().astype(np.uint32)))


class NYUDataset:
    name = "nyu"

    def __init__(self, data_dir: str, split: str = "train", path: str = None):
        self.path = path or os.path.join(data_dir, "nyu", MAT_NAME)
        if not os.path.exists(self.path):
            raise FileNotFoundError(
                f"{self.path} not found; run `python -m ann3depth_tpu "
                f"download --dataset nyu` or stage the file manually")
        import h5py

        self._f = h5py.File(self.path, "r")
        if split not in ("train", "test"):
            raise ValueError(f"split must be train|test, got {split!r}")
        self.indices = self._split_indices(split)

    def _split_indices(self, split: str) -> np.ndarray:
        n = self._f["images"].shape[0]
        want_train = split == "train"

        # Tier 1: the official split file (795 train / 654 test).
        splits_path = os.path.join(os.path.dirname(self.path), SPLITS_NAME)
        if os.path.exists(splits_path):
            import scipy.io

            m = scipy.io.loadmat(splits_path)
            key = "trainNdxs" if want_train else "testNdxs"
            idx = np.asarray(m[key]).ravel().astype(np.int64) - 1  # 1-based
            if len(idx) == 0 or idx.min() < 0 or idx.max() >= n:
                raise ValueError(
                    f"{splits_path}:{key} indices out of range for {n} images")
            return idx

        # Tier 2: alternate whole scenes (no frame leakage across splits).
        if "scenes" in self._f:
            refs = np.asarray(self._f["scenes"]).ravel()
            names = [_decode_matlab_string(self._f, r) for r in refs]
            order = {}
            for s in names:
                order.setdefault(s, len(order))
            keep = 0 if want_train else 1
            return np.asarray(
                [i for i, s in enumerate(names) if order[s] % 2 == keep],
                np.int64)

        # Tier 3: leaky image-level fallback.
        log.warning(
            "NYU: no %s and no 'scenes' dataset in %s — falling back to an "
            "every-other-IMAGE split. Consecutive same-scene frames leak "
            "across train/test; stage the official splits.mat for any "
            "comparable eval.", SPLITS_NAME, self.path)
        idx = np.arange(n)
        return idx[idx % 2 == (0 if want_train else 1)]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        j = int(self.indices[i])
        # images: (N, 3, W, H) -> (H, W, 3); depths: (N, W, H) -> (H, W)
        img = np.asarray(self._f["images"][j]).transpose(2, 1, 0)
        depth = np.asarray(self._f["depths"][j]).T.astype(np.float32)
        return np.ascontiguousarray(img, dtype=np.uint8), depth

    def batches(self, batch_size, *, steps=None, shuffle=True, seed=0,
                drop_remainder=True):
        """Yield stacked raw batches via the shared epoch iterator
        (data/batching.py — one implementation, shared semantics)."""
        from ann3depth_tpu_torch.data.batching import iter_batches

        return iter_batches(self, batch_size, steps=steps, shuffle=shuffle,
                            seed=seed, drop_remainder=drop_remainder)

    def close(self):
        self._f.close()
