"""The train step as replays of a CUDA graph: the counterpart of the JAX
loop's compiled step.

The JAX loop runs every train step as one compiled program: `train_step`
(or `distill_train_step`) under `jax.jit` at steps_per_dispatch 1, and at
K > 1 a `lax.scan` of K steps over a device-resident pool, each step
gathering its batch by an index row. The port captures ONE train step in a
CUDA graph and replays it, with no host synchronisation in between:

- From a pool sampler (`pipeline.device_cache.DevicePoolSampler`,
  `pipeline.streaming_pool.StreamingPoolSampler`) a call runs a block of K
  steps (K = steps_per_dispatch, 1 included) from index rows `[K, B]`:
  the captured step reads slot `s` of the block, gathers `pool_img[idx[s]]`
  and `pool_dep[...]`, and the block replays it K times.
- From fed batches (`pipeline.feed.DeviceFeed`, the worker loader,
  batch-interleaved datasets) a call runs one step: the batch is copied
  into static input buffers, which the captured step reads. One graph is
  captured for each key of batch shapes and dtypes (two datasets of
  different raw shapes get two), all of a runner's graphs in one memory
  pool; they replay one after another on one stream.

Before each call the host fills the call's device buffers: the index rows
or the batch, the learning rate of each step (`schedule(step)`, written by
a fill kernel, which takes the value as an argument: no copy from the host
and so no stream sync), and, with augmentation, the draws `[K, grad_accum,
B / grad_accum]` of each `draw_augment` field, drawn as the eager loop
draws them (the generator seeded with `step_seed(seed, step)` before each
step), so that replays equal eager steps. A slot counter on the device is
set to 0; the step adds one to it. The step copies its metrics into one
static output, which each call clones (the next replay overwrites it).

The first call of a key runs eagerly, on the capture stream: its steps are
real steps, and they create what a capture cannot (the kernel library and
its shared-memory attribute, the optimizer state, the cached resize and
identity rows, cuBLAS's workspace for the stream). Then, when another call
follows, the key's step is captured (a capture runs no kernel, so it costs
no step), and every later call of the key replays it. The graphs hold the
addresses of the pool or the input buffers, the params, the optimizer
state and the EMA; everything that touches them between calls
(checkpoints, evals, a best-weights restore, a resume) reads them or
writes them in place.

On the CPU there is no graph: without a capture hook (`capture_hook`, for
tests: a capture that runs nothing and a replay that reruns what it
recorded on the same tensors) every call runs its steps eagerly, the same
logic the card captures. A run over gloo on the card cannot be captured
(its collectives run on the host): `eager_reason` says so before the
first step, and the train loop then runs the eager step at K=1 and
refuses K > 1. A capture or replay error raises; nothing falls back to
eager steps.

A runner counts what it ran: `captures` (graphs recorded), `replays`
(steps replayed) and `eager_steps` (steps run outside a replay: a key's
first call, or every call where nothing is captured). While a profiler
window is open (`utils.tracing.active()`), each call records the span
`a3d.dispatch.run` and inside it `a3d.dispatch.fill` (the inputs, rates,
draws and slot), `.eager` (the eager steps), `.capture`, `.replay` (the K
replays) and `.out` (the metrics' copy); the captured step records none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.parallel import multihost
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.utils import graphs, tracing


def _over_gloo(state, device) -> bool:
    """A step on the card whose collectives run over gloo (on the host)."""
    mesh = state.mesh
    return (torch.device(device).type == "cuda" and mesh is not None
            and mesh.distributed and multihost.backend() == "gloo")


def eager_reason(state, device) -> Optional[str]:
    """Why the train loop runs a K=1 step of `state` on `device` eagerly,
    or None when it replays the `BlockRunner`'s graph of it."""
    if _over_gloo(state, device):
        return ("the gloo backend's collectives run on the host and cannot "
                "be captured in a CUDA graph")
    if (torch.device(device).type != "cuda"
            and BlockRunner.capture_hook is None):
        return f"no CUDA graph on {torch.device(device).type}"
    return None


@dataclasses.dataclass
class _Entry:
    """One key's static inputs (the index block, or the fed batch), its
    draw buffers and, once captured, its replay."""

    inputs: tuple
    draws: Optional[dict] = None
    replay: Optional[Callable] = None


class BlockRunner:
    """Runs train (or distill) steps as CUDA graph replays: blocks of K
    steps from a pool `sampler` (index rows [K, B] a call), or, with
    `sampler` None, one step a call from fed batches (img_u8, depth) on
    `device`.

    step_kwargs: the train step's keyword arguments (as the eager loop
    passes them); draw_seed(step): the generator seed of a step's
    augmentation draws. `captures`, `replays` and `eager_steps` count
    what the runner did (a replay is one step)."""

    # A capture hook `capture(run) -> (out, replay)` used in place of the
    # CUDA capture on every device (tests/test_torch_train_graph.py): it
    # must leave every tensor as it was, and `replay()` must rerun what
    # `run()` did on the tensors it touched. The runner ignores `out`.
    capture_hook = None

    def __init__(self, state, sampler, k: int, *, step_kwargs: dict,
                 draw_seed: Callable[[int], int], teacher=None, device=None):
        self.device = torch.device(sampler.device if sampler is not None
                                   else device)
        if _over_gloo(state, self.device):
            raise ValueError(
                f"steps_per_dispatch={k} captures the step in a CUDA graph, "
                "and the gloo backend's collectives cannot be captured; "
                "run nccl (one process per card) or steps_per_dispatch 1")
        if sampler is None and k != 1:
            raise ValueError(f"a fed batch is one step: k={k}")
        mesh = state.mesh
        self.mesh = mesh if mesh is not None and mesh.active() else None
        self.state, self.sampler, self.k = state, sampler, k
        self.teacher = teacher
        self.kw = dict(step_kwargs)
        self.draw_seed = draw_seed
        self.graphed = (self.device.type == "cuda"
                        or self.capture_hook is not None)
        self.accum = self.kw.get("grad_accum", 1)
        self.lr_block = torch.zeros(k, dtype=torch.float64,
                                    device=self.device)
        self.slot = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.names: Optional[list] = None
        self.out: Optional[torch.Tensor] = None
        self._entries: dict = {}
        self._generator = torch.Generator(device=self.device)
        self._pool = None
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.captures = self.replays = self.eager_steps = 0

    def _entry(self, item):
        """The entry of a call's key (made at its first call)."""
        tensors = (item,) if self.sampler is not None else tuple(item)
        key = tuple((tuple(t.shape), t.dtype) for t in tensors)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(tuple(
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in tensors))
        return entry

    def _fill(self, entry, item):
        """Set the call's inputs, learning rates and draws, and the slot
        counter, on the current stream."""
        first = self.state.step
        if self.sampler is not None:
            entry.inputs[0].copy_(item)
            rows, batch = self.sampler.per_dev, self.sampler.batch_size
        else:
            for buf, x in zip(entry.inputs, item):
                buf.copy_(x)
            rows = entry.inputs[0].shape[0]
            batch = rows * (self.mesh.n_data if self.mesh is not None else 1)
        sched = self.state.tx.schedule
        for j in range(self.k):
            self.lr_block[j].fill_(float(sched(first + j)))
        if self.kw.get("augment"):
            micro = rows // self.accum
            gen = self._generator
            for j in range(self.k):
                gen.manual_seed(self.draw_seed(first + j))
                if self.mesh is not None:
                    block = steplib.shard_draws(gen, batch, self.accum,
                                                self.mesh, device=self.device)
                else:
                    block = [fp.draw_augment(gen, micro, device=self.device)
                             for _ in range(self.accum)]
                for a, draw in enumerate(block):
                    if entry.draws is None:
                        entry.draws = {
                            n: torch.zeros((self.k, self.accum, v.shape[0]),
                                           dtype=v.dtype, device=self.device)
                            for n, v in draw.items()}
                    for n, v in draw.items():
                        entry.draws[n][j, a].copy_(v)
        self.slot.zero_()

    def _slot_step(self, entry):
        """One train step on slot `s` of the call's buffers."""
        s = self.slot
        if self.sampler is not None:
            idx = entry.inputs[0].index_select(0, s)[0]
            img = self.sampler.pool_img[idx]
            dep = self.sampler.pool_dep[idx]
        else:
            img, dep = entry.inputs
        lr = self.lr_block.index_select(0, s)
        draws = None
        if entry.draws is not None:
            picked = {n: v.index_select(0, s)[0]
                      for n, v in entry.draws.items()}
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
            self.names = list(metrics)
            self.out = torch.zeros(len(self.names), dtype=torch.float32,
                                   device=self.device)
        self.out.copy_(torch.stack([metrics[n].float() for n in self.names]))
        self.slot.add_(1)

    def _capture(self, entry):
        """Record the key's step into a graph (a capture runs no kernel:
        the step counter is put back)."""
        first = self.state.step
        self.slot.zero_()  # a hook's capture may run the step on slot 0
        if self.capture_hook is not None:
            _, entry.replay = self.capture_hook(
                lambda: self._slot_step(entry))
        else:
            graph = torch.cuda.CUDAGraph()
            # thread_local: the window pool's staging thread may copy the
            # next window on its own stream while this thread captures.
            graphs._capture(graph, lambda: self._slot_step(entry),
                            self.device, self._pool, self.stream,
                            "the train step")
            if self._pool is None:
                self._pool = graph.pool()
            entry.replay = graph.replay
        self.state.step = first
        self.captures += 1

    def _eager(self, entry):
        """The call's K steps run eagerly, on the capture stream on the
        card."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(self.k):
                self._slot_step(entry)
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.eager_steps += self.k

    def run(self, item, more=True):
        """Run one call: a block of K steps from index rows `item` ([K, B]
        int64 on the device), or one step from a fed batch `item`
        (img_u8, depth); returns the last step's metrics (device scalars,
        a copy of the static output). more: whether another call follows
        (the eager first call of a key then captures its step)."""
        with tracing.span("dispatch.run"):
            entry = self._entry(item)
            with tracing.span("dispatch.fill"):
                self._fill(entry, item)
            if entry.replay is None:
                with tracing.span("dispatch.eager"):
                    self._eager(entry)
                if more and self.graphed:
                    with tracing.span("dispatch.capture"):
                        self._capture(entry)
            else:
                with tracing.span("dispatch.replay"):
                    for _ in range(self.k):
                        entry.replay()
                self.state.step += self.k
                self.replays += self.k
            with tracing.span("dispatch.out"):
                out = self.out.clone()
                return dict(zip(self.names, out.unbind()))
