"""Shared epoch/shuffle/stack batch iterator for all loader-protocol
datasets (make3d, nyu, records, synthetic) — one implementation so epoch
semantics can't diverge.

Semantics:
- steps=None: exactly one (re)shuffled epoch.
- steps=N: repeat reshuffled epochs until N batches have been yielded;
  the step bound is checked BEFORE yielding, so steps=0 yields nothing
  (resume-of-a-finished-run must not run extra steps).
- drop_remainder=True drops the trailing partial batch.
- batch_size > len(dataset) with drop_remainder is a hard error (it would
  otherwise spin forever yielding nothing inside the feed thread).

A copy of `ann3depth_tpu/data/batching.py`, so that the port imports nothing of
the JAX package; tests/test_torch_train_loop.py compares its batches with the original's.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def interleave_batches(datasets, batch_size: int, *,
                       steps: Optional[int] = None, shuffle: bool = True,
                       seed: int = 0) -> Iterator:
    """Round-robin whole batches from several datasets (multi-dataset
    training, the reference CLI's dataset-list surface, SURVEY §2.1 CLI
    row / [B:5]).

    Interleaving at BATCH granularity keeps every yielded batch
    shape-uniform even when the sources have different raw image/depth
    grids (Make3D's 2272x1704+305x55 vs NYU's 640x480) — the jitted train
    step simply compiles one program per source shape, the TPU-friendly
    alternative to host-side re-decoding everything to one raw size.
    Each source repeats reshuffled epochs independently; iteration stops
    after `steps` total batches (steps=None -> run until the shortest
    source finishes one epoch)."""
    its = [iter_batches(d, batch_size,
                        steps=None if steps is None else steps,
                        shuffle=shuffle, seed=seed + 17 * k)
           for k, d in enumerate(datasets)]
    yield from round_robin(its, steps=steps)


def round_robin(iterators, *, steps: Optional[int] = None) -> Iterator:
    """Yield from each iterator in turn, dropping exhausted ones; stop
    after `steps` total yields (None = until every source is exhausted).
    Shared by interleave_batches and the grain multi-dataset path
    (train/loop.py) so the source-rotation contract can't diverge."""
    its = list(iterators)
    step = 0
    while its:
        for it in list(its):
            if steps is not None and step >= steps:
                return
            try:
                yield next(it)
                step += 1
            except StopIteration:
                its.remove(it)
                if not its:
                    return


class ProcessShardView:
    """Process p's deterministic strided slice [p::n] of a dataset — the
    multi-host data partition (parallel/multihost.py). Striding (not
    contiguous blocks) keeps per-process example counts within 1 of each
    other for any dataset size; each process shuffles its own shard
    (shard-local shuffle, the same trade recorded for the HBM-resident
    cache in docs/design.md §4c)."""

    def __init__(self, dataset, process_index: int, process_count: int):
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})")
        self._ds = dataset
        self._p = process_index
        self._n = process_count

    def __len__(self):
        return (len(self._ds) - self._p + self._n - 1) // self._n

    def __getitem__(self, i):
        return self._ds[self._p + i * self._n]

    def batches(self, batch_size, *, steps=None, shuffle=True, seed=0,
                drop_remainder=True):
        return iter_batches(self, batch_size, steps=steps, shuffle=shuffle,
                            seed=seed, drop_remainder=drop_remainder)


def iter_batches(dataset, batch_size: int, *, steps: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True) -> Iterator:
    n = len(dataset)
    if drop_remainder and batch_size > n:
        raise ValueError(
            f"batch_size {batch_size} > dataset size {n} with "
            f"drop_remainder: no full batch can ever be formed")
    rng = np.random.default_rng(seed)
    # Vectorized batch read when the dataset offers one (records.py npy
    # format): one fancy-indexed memmap gather instead of batch_size
    # __getitem__ calls + a Python-level stack. Same examples, same order.
    gather = getattr(dataset, "gather", None)
    step = 0
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        last = n - (batch_size - 1 if drop_remainder else 0)
        for s in range(0, last, batch_size):
            if steps is not None and step >= steps:
                return
            idx = order[s:s + batch_size]
            if gather is not None:
                yield gather(idx)
            else:
                imgs, deps = zip(*(dataset[int(i)] for i in idx))
                yield np.stack(imgs), np.stack(deps)
            step += 1
        if steps is None:
            return
        if steps is not None and step >= steps:
            return
