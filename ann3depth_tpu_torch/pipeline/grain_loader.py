"""Worker-process input pipeline (`--use-grain` / `--num-workers N`).

Counterpart of `ann3depth_tpu/pipeline/grain_loader.py`, which wraps a
dataset into a `grain` pipeline. The card's machine has no `grain`, so the
port's counterpart is PyTorch's own `torch.utils.data.DataLoader` over the
dataset: `num_workers` worker processes decode examples, a seeded shuffle
is drawn per epoch (epochs repeat when `steps` is given), incomplete
batches are dropped, and batches are collated as numpy arrays. The
batches then go to the same DeviceFeed as every host pipeline.

The shuffle order is this module's own (an epoch-`e` permutation from
`np.random.default_rng((seed, e))`), not grain's: the JAX package's grain
path and its `batches()` path do not share an order either, so there is no
order to hold it to.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class _BatchOrder:
    """The batches' example indices: `steps` batches (None: one epoch) of
    `batch_size` from per-epoch permutations, incomplete batches dropped."""

    def __init__(self, n, batch_size, steps, shuffle, seed):
        self.n, self.batch_size = n, batch_size
        self.steps, self.shuffle, self.seed = steps, shuffle, seed

    def __iter__(self):
        per_epoch = self.n // self.batch_size
        if per_epoch == 0:
            raise ValueError(f"batch_size={self.batch_size} exceeds the "
                             f"dataset (n={self.n})")
        total = per_epoch if self.steps is None else self.steps
        done, epoch = 0, 0
        while done < total:
            order = (np.random.default_rng((self.seed, epoch)).permutation(
                self.n) if self.shuffle else np.arange(self.n))
            for b in range(per_epoch):
                if done >= total:
                    return
                yield order[b * self.batch_size:(b + 1) * self.batch_size
                            ].tolist()
                done += 1
            epoch += 1


class _Examples:
    """Map-style view of a loader-protocol dataset (picklable to workers
    when the dataset is)."""

    def __init__(self, dataset):
        self._ds = dataset

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        img, depth = self._ds[int(i)]
        return np.asarray(img), np.asarray(depth)


def _collate(examples):
    return (np.stack([e[0] for e in examples]),
            np.stack([e[1] for e in examples]))


def grain_batches(dataset, batch_size: int, *, steps: Optional[int] = None,
                  shuffle: bool = True, seed: int = 0,
                  num_workers: int = 0) -> Iterator:
    """Yield (img_u8 [B,...], depth [B,...]) numpy batches through a
    DataLoader with `num_workers` worker processes (0: in this process).

    dataset: anything with __len__/__getitem__ returning (img, depth).
    steps: stop after N batches (repeats epochs, reshuffled); None = 1 epoch.
    """
    from torch.utils.data import DataLoader

    loader = DataLoader(
        _Examples(dataset),
        batch_sampler=_BatchOrder(len(dataset), batch_size, steps, shuffle,
                                  seed),
        num_workers=num_workers, collate_fn=_collate)
    yield from loader
