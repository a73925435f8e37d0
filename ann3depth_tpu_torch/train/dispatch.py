"""K train steps a dispatch (`steps_per_dispatch`), as a CUDA graph.

Counterpart of the JAX loop's K-step driver (`ann3depth_tpu/train/
loop.py`, steps_per_dispatch > 1), which folds K steps over a
device-resident pool into one `lax.scan` program: each step gathers its
batch from the pool by an index row, and the block returns the last
step's metrics. The port captures ONE train step in a CUDA graph and
replays it K times a block, with no host synchronisation in between:

- Before each block the host fills device buffers: the block's index rows
  `idx_block [K, B]`, its learning rates `lr_block [K]` (the schedule at
  each step), and, with augmentation, its draws `[K, grad_accum, B /
  grad_accum]` of each `draw_augment` field, drawn as the eager loop draws
  them (the generator seeded with `step_seed(seed, step)` before each
  step), so the block's steps get the eager steps' draws. A slot counter
  on the device is set to 0.
- The captured step reads slot `s` of those buffers, gathers
  `pool_img[idx_block[s]]` and `pool_dep[...]`, runs the train step (the
  v1 preprocess kernel, forward, backward, clip, update, EMA), copies its
  metrics into static outputs and adds one to `s`.
- The first block of a run runs its K steps eagerly through the same slot
  step, on the capture stream: they are real steps, and they create what
  a capture cannot (the kernel library and its shared-memory attribute,
  the optimizer state, the cached resize and identity rows, cuBLAS's
  workspace for the stream). Then, when another block follows, it
  captures the step (a capture runs no kernel, so it costs no step), and
  every later block replays it. The block's metrics are cloned off the
  static outputs.

One step is captured rather than K: the graph and its capture time do not
grow with K, and a replay costs one graph launch where the eager step
costs several hundred kernel launches. The graph holds the addresses of
the pool, the params, the optimizer state and the EMA; everything that
touches them between blocks (checkpoints, evals, an early-stop restore)
reads them or writes them in place. On the CPU there is no graph: every
block runs the slot step K times eagerly, the same logic the card
captures.

A capture or replay error raises; nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.parallel import multihost
from ann3depth_tpu_torch.train import step as steplib


class BlockRunner:
    """Runs K-step blocks of train (or distill) steps over a pool sampler
    (`pipeline.device_cache.DevicePoolSampler` or
    `pipeline.streaming_pool.StreamingPoolSampler`).

    step_kwargs: the train step's keyword arguments (as the eager loop
    passes them); draw_seed(step): the generator seed of a step's
    augmentation draws."""

    def __init__(self, state, sampler, k: int, *, step_kwargs: dict,
                 draw_seed: Callable[[int], int], teacher=None):
        mesh = state.mesh
        if (mesh is not None and mesh.distributed and sampler.device.type
                == "cuda" and multihost.backend() == "gloo"):
            raise ValueError(
                f"steps_per_dispatch={k} captures the step in a CUDA graph, "
                "and the gloo backend's collectives cannot be captured; "
                "run nccl (one process per card) or steps_per_dispatch 1")
        self.mesh = mesh if mesh is not None and mesh.active() else None
        self.state, self.sampler, self.k = state, sampler, k
        self.teacher = teacher
        self.kw = dict(step_kwargs)
        self.draw_seed = draw_seed
        self.device = sampler.device
        self.cuda = self.device.type == "cuda"
        self.accum = self.kw.get("grad_accum", 1)
        dev = self.device
        self.idx_block = torch.zeros((k, sampler.per_dev), dtype=torch.int64,
                                     device=dev)
        self.lr_block = torch.zeros(k, dtype=torch.float64, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.draws: Optional[dict] = None
        self.out: Optional[dict] = None
        self._generator = torch.Generator(device=dev)
        self.graph = None
        self.stream = torch.cuda.Stream(dev) if self.cuda else None

    def _fill(self, block):
        """Set the block's index rows, learning rates and draws, and the
        slot counter, on the current stream."""
        first = self.state.step
        self.idx_block.copy_(block)
        sched = self.state.tx.schedule
        self.lr_block.copy_(torch.from_numpy(np.array(
            [float(sched(first + j)) for j in range(self.k)], np.float64)))
        if self.kw.get("augment"):
            micro = self.sampler.per_dev // self.accum
            gen = self._generator
            for j in range(self.k):
                gen.manual_seed(self.draw_seed(first + j))
                if self.mesh is not None:
                    block = steplib.shard_draws(
                        gen, self.sampler.batch_size, self.accum, self.mesh,
                        device=self.device)
                else:
                    block = [fp.draw_augment(gen, micro, device=self.device)
                             for _ in range(self.accum)]
                for a, draw in enumerate(block):
                    if self.draws is None:
                        self.draws = {
                            n: torch.zeros((self.k, self.accum, micro),
                                           dtype=v.dtype, device=self.device)
                            for n, v in draw.items()}
                    for n, v in draw.items():
                        self.draws[n][j, a].copy_(v)
        self.slot.zero_()

    def _slot_step(self):
        """One train step on slot `s` of the block's buffers."""
        s = self.slot
        idx = self.idx_block.index_select(0, s)[0]
        img = self.sampler.pool_img[idx]
        dep = self.sampler.pool_dep[idx]
        lr = self.lr_block.index_select(0, s)
        draws = None
        if self.draws is not None:
            picked = {n: v.index_select(0, s)[0]
                      for n, v in self.draws.items()}
            draws = [{n: v[a] for n, v in picked.items()}
                     for a in range(self.accum)]
        if self.teacher is None:
            _, metrics = steplib.train_step(self.state, img, dep,
                                            draws=draws, lr=lr, **self.kw)
        else:
            _, metrics = steplib.distill_train_step(
                self.state, self.teacher, img, dep, draws=draws, lr=lr,
                **self.kw)
        if self.out is None:
            self.out = {n: torch.zeros((), dtype=torch.float32,
                                       device=self.device) for n in metrics}
        for n, v in metrics.items():
            self.out[n].copy_(v)
        self.slot.add_(1)

    def _capture(self):
        first = self.state.step
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the window pool's staging thread may copy the next
        # window on its own stream while this thread captures.
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self._slot_step()
        # The capture ran no kernel: the step counter did not advance.
        self.state.step = first

    def run(self, block, more=True):
        """Run one block of K steps with index rows `block` ([K, B] int64
        on the device); returns the last step's metrics (device scalars).
        more: whether another block follows (the eager first block then
        captures the step for it)."""
        self._fill(block)
        if not self.cuda:
            for _ in range(self.k):
                self._slot_step()
        elif self.graph is None:
            main = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                for _ in range(self.k):
                    self._slot_step()
            main.wait_stream(self.stream)
            if more:
                self._capture()
        else:
            for _ in range(self.k):
                self.graph.replay()
            self.state.step += self.k
        return {n: v.clone() for n, v in self.out.items()}
