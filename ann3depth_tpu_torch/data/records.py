"""Packed on-disk records (SURVEY §2.1 downloader row: "pre-convert
to paired arrays on disk"; §3.4).

Raw Make3D/NYU decode (JPEG + .mat per example) costs ~10s of ms of host CPU
per image — fine for one epoch, wasteful for many. `pack()` pre-converts any
dataset with the loader protocol into contiguous uint8 image / f32 depth
arrays on disk; `RecordDataset` then serves batches with zero decode work,
keeping the host side of the input pipeline far below the device step time.

Two on-disk formats, both described by <name>-<split>-index.json:

- "npy" (default, r4): ONE memmap'd .npy pair per split
  (<name>-<split>-images.npy / -depths.npy, written incrementally via
  np.lib.format.open_memmap). Random access under a globally-shuffled
  epoch reads only the touched pages; the OS page cache manages
  residency. This is the host-feed-friendly layout: a shuffled batch of
  B examples costs exactly B row reads, independent of dataset size.
- "npz" (legacy r2 shards, still readable): 64-example .npz shards with
  a 3-shard LRU. A globally-shuffled batch touches ~B distinct shards
  and reloads ~B × shard_bytes from disk — measured 25-80x slower than
  npy under shuffle at Make3D raw shapes (benchmarks/bench_feed.py);
  kept only so pre-r4 packed datasets keep working.

A copy of `ann3depth_tpu/data/records.py`, so that the port imports nothing of
the JAX package; tests/test_torch_train_loop.py compares it with the original and tests/test_torch_data.py reads packs across the two.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Tuple

import numpy as np


def pack(dataset, out_dir: str, split: str, shard_size: int = 64,
         format: str = "npy") -> str:
    """Pre-convert `dataset` (loader protocol) into packed records.

    format="npy" (default): one memmap'd .npy pair per split, written
    incrementally (peak host RAM = one example, not the dataset).
    format="npz": the legacy sharded layout.
    """
    os.makedirs(out_dir, exist_ok=True)
    name = getattr(dataset, "name", "dataset")
    n = len(dataset)
    if n == 0:
        raise ValueError(
            f"cannot pack empty dataset {name!r} (split={split!r})")
    if format == "npy":
        index = _pack_npy(dataset, out_dir, name, split, n)
    elif format == "npz":
        index = _pack_npz(dataset, out_dir, name, split, n, shard_size)
    else:
        raise ValueError(f"format must be npy|npz, got {format!r}")
    index_path = os.path.join(out_dir, f"{name}-{split}-index.json")
    # Write the index LAST (and atomically): its presence marks a complete
    # pack, so an interrupted run never leaves a readable-looking dataset.
    tmp = index_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1)
    os.replace(tmp, index_path)
    return index_path


def _pack_npy(dataset, out_dir, name, split, n):
    img0, dep0 = dataset[0]
    img_path = os.path.join(out_dir, f"{name}-{split}-images.npy")
    dep_path = os.path.join(out_dir, f"{name}-{split}-depths.npy")
    imgs = np.lib.format.open_memmap(
        img_path, mode="w+", dtype=np.uint8, shape=(n, *img0.shape))
    deps = np.lib.format.open_memmap(
        dep_path, mode="w+", dtype=np.float32, shape=(n, *dep0.shape))
    imgs[0], deps[0] = img0, dep0
    for i in range(1, n):
        imgs[i], deps[i] = dataset[i]
    # Flush before the index write commits the pack.
    imgs.flush()
    deps.flush()
    del imgs, deps
    return {
        "name": name, "split": split, "total": n, "format": "npy",
        "image_shape": list(img0.shape), "depth_shape": list(dep0.shape),
        "images": os.path.basename(img_path),
        "depths": os.path.basename(dep_path),
    }


def _pack_npz(dataset, out_dir, name, split, n, shard_size):
    shards = []
    for s0 in range(0, n, shard_size):
        idx = range(s0, min(s0 + shard_size, n))
        imgs, deps = zip(*(dataset[i] for i in idx))
        imgs, deps = np.stack(imgs), np.stack(deps)
        path = os.path.join(out_dir, f"{name}-{split}-{s0 // shard_size:05d}.npz")
        np.savez(path, images=imgs, depths=deps)
        shards.append({"path": os.path.basename(path), "n": int(imgs.shape[0])})
    return {
        "name": name, "split": split, "total": n, "format": "npz",
        "image_shape": list(imgs.shape[1:]), "depth_shape": list(deps.shape[1:]),
        "shards": shards,
    }


class RecordDataset:
    """Serve batches from packed records; loader-protocol compatible.

    npy format: the .npy pair is opened memmap'd once; `gather` fancy-
    indexes it directly (one row read per example — shuffle-friendly).
    npz format (legacy): 3-shard LRU over the shard files.
    """

    def __init__(self, index_path: str):
        self._index_path = index_path
        with open(index_path) as f:
            self.index = json.load(f)
        self.name = self.index["name"]
        base = os.path.dirname(index_path)
        self._fmt = self.index.get("format", "npz")
        if self._fmt == "npy":
            self._imgs = np.load(os.path.join(base, self.index["images"]),
                                 mmap_mode="r")
            self._deps = np.load(os.path.join(base, self.index["depths"]),
                                 mmap_mode="r")
            for field, arr in (("images", self._imgs),
                               ("depths", self._deps)):
                if len(arr) != self.index["total"]:
                    raise ValueError(
                        f"{index_path}: {field} row count {len(arr)} != "
                        f"index total {self.index['total']} — incomplete "
                        "pack?")
        else:
            self._shards = [os.path.join(base, s["path"])
                            for s in self.index["shards"]]
            self._sizes = [s["n"] for s in self.index["shards"]]
            self._offsets = np.cumsum([0] + self._sizes)
            self._cache = {}
            # Shadow the class method: iter_batches probes
            # getattr(ds, "gather", None) and must see "absent" for npz.
            self.gather = None

    def __len__(self):
        return self.index["total"]

    # A pickled np.memmap serializes the FULL underlying buffer as an
    # ndarray (measured: a 1 MB mmap_mode="r" load pickles to ~1 MB), so
    # shipping this object to grain worker processes (--use-grain
    # --num-workers N) would copy the whole packed dataset into every
    # worker. Pickle only the index path; workers reopen their own memmaps
    # (row reads then share the OS page cache across processes).
    def __getstate__(self):
        return {"index_path": self._index_path}

    def __setstate__(self, state):
        self.__init__(state["index_path"])

    def _shard(self, si):
        if si not in self._cache:
            if len(self._cache) > 2:  # keep at most 3 shards resident
                self._cache.pop(next(iter(self._cache)))
            with np.load(self._shards[si]) as z:
                self._cache[si] = (z["images"], z["depths"])
        return self._cache[si]

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        if self._fmt == "npy":
            return self._imgs[i], self._deps[i]
        si = int(np.searchsorted(self._offsets, i, side="right") - 1)
        imgs, deps = self._shard(si)
        j = i - self._offsets[si]
        return imgs[j], deps[j]

    def gather(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked batch for an index array in one vectorized read
        (npy format; data/batching.iter_batches uses this when present —
        npz instances shadow this with None in __init__)."""
        # Fancy indexing a memmap materializes exactly the touched rows.
        return np.asarray(self._imgs[idx]), np.asarray(self._deps[idx])

    def batches(self, batch_size, *, steps=None, shuffle=True, seed=0,
                drop_remainder=True):
        """Yield stacked raw batches via the shared epoch iterator
        (data/batching.py — one implementation, shared semantics)."""
        from ann3depth_tpu_torch.data.batching import iter_batches

        return iter_batches(self, batch_size, steps=steps, shuffle=shuffle,
                            seed=seed, drop_remainder=drop_remainder)


def find_index(out_dir: str, name: str, split: str):
    matches = glob.glob(os.path.join(out_dir, f"{name}-{split}-index.json"))
    return matches[0] if matches else None
