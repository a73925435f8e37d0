"""Rotating-window device pool: device-cache training for datasets LARGER
than the device budget (`--cache-window-mb`), with optional data echoing
(`--window-epochs`).

Counterpart of `ann3depth_tpu/pipeline/streaming_pool.py`.
The train step consumes raw input bytes at `img/s x bytes/img`, more than a
host link sustains once the step is fast; the full device pool
(`pipeline/device_cache.py`) sidesteps the link but needs `dataset <= byte
budget`. This module covers the gap:

- The dataset is visited through fixed-size device **windows**. Two
  window buffers are resident: the active one, which the steps gather
  from, and a staging one, which a background thread fills with the next
  window through the link on its own CUDA stream (recording an event when
  the window has landed). At a window boundary the consumer's stream waits
  on that event and copies the staged window into the active buffer, a
  device-to-device copy of the window. The active buffer never moves, so a
  CUDA graph of the train step (train/dispatch.py), which holds its
  address, stays valid across windows; the stager's next window waits (on
  its stream) for that copy to finish before it overwrites the staging
  buffer.
- **Data echoing** (Choi et al. 2019, "Faster Neural Network Training with
  Data Echoing"): `window_epochs=E` trains E passes over each window
  before rotating, dividing the link bandwidth demand by E. With `t_stage`
  the window staging time and `t_train` one pass over it, the sustained
  rate is `device_rate * min(1, E*t_train / max(E*t_train, t_stage))`.

Sampling: each pass draws ONE permutation of the dataset and partitions it
into windows; within a window, every echo epoch is a fresh permutation of
the window. The permutations are the JAX sampler's, bit for bit
(`np.random.default_rng(seed)` for the windows and `seed + 1000003 * pid`
for the echo epochs). Under data parallelism rank r of n stages block r of
each window (win/n rows) and samples it with pid r, as the JAX sampler
stages process r's shards. The per-pass tail (`n mod window`) is
dropped, but a fresh permutation re-draws it every pass.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time

import numpy as np
import torch

from ann3depth_tpu_torch.pipeline.device_cache import (
    DEFAULT_BYTE_BUDGET, STAGE_CHUNK_BYTES, RowView, bind_thread,
    pool_buffers, stage_rows, to_index)

log = logging.getLogger(__name__)


def pick_window_epochs(t_stage, t_train, batches_per_window,
                       steps_per_dispatch=1, max_epochs=64):
    """The echo factor that hides window staging behind training.

    With `t_stage` = one window's staging wall time and `t_train` = one
    pass over it, the rotating pool sustains the device rate iff `E *
    t_train >= t_stage` (module docstring). Returns the smallest such E,
    rounded UP so the window's step count (batches_per_window * E) stays a
    multiple of the dispatch block (a K-step block must not span windows
    — `index_blocks`), clamped to `max_epochs`.

    The clamp default is the JAX package's measured quality boundary
    (its benchmarks/exp_echo_quality.py: E<=16 quality-free, E=32/64 a few
    percent of eval RMSE, E=128 +12%); a larger factor needs an explicit
    --window-epochs."""
    if t_stage < 0 or t_train < 0:
        raise ValueError(f"negative times: {t_stage=}, {t_train=}")
    e = max(1, -(-int(t_stage * 1e6) // max(int(t_train * 1e6), 1)))
    # (batches * e) % spd == 0  <=>  e is a multiple of spd/gcd(batches,spd)
    quantum = (steps_per_dispatch
               // math.gcd(batches_per_window, steps_per_dispatch)
               if steps_per_dispatch > 1 else 1)
    e = -(-e // quantum) * quantum
    if e > max_epochs:
        clamped = max(max_epochs // quantum * quantum, quantum)
        if clamped > max_epochs:
            raise ValueError(
                f"no echo factor <= {max_epochs} makes {batches_per_window}"
                f" batches/window divisible by steps_per_dispatch="
                f"{steps_per_dispatch}; align --cache-window-mb or K")
        log.warning(
            "auto window-epochs clamped to %d (staging %.1fs vs pass "
            "%.2fs wants x%d) — the link stays the binding term; raise "
            "--cache-window-mb or accept the stall", clamped, t_stage,
            t_train, e)
        e = clamped
    return e


def calibrate_window_epochs(dataset, batch_size, device=None, *,
                            window_bytes, run_pass, steps_per_dispatch=1,
                            max_epochs=64, seed=0,
                            byte_budget=DEFAULT_BYTE_BUDGET):
    """Measure one window's staging time and one training pass over it,
    return `pick_window_epochs` of the two (the `--window-epochs auto`
    implementation; train/loop.py wires it).

    `run_pass(probe, blocks)` must drain one pass over the probe's active
    window, the iterable of [1, per_dev] int64 device index blocks
    `blocks` (`probe.gather(block[0])` is a block's batch), through the
    step program the run will replay (train/loop.py: the run's
    `BlockRunner` on the probe, or the eager step where the run steps
    eagerly) and SYNC before returning. It runs twice: once to warm up
    (and capture), once timed. The probe stages
    two windows (the first measured, the second overlapping the passes as
    steady state does) and drops them; the real sampler restages from
    scratch. close() waits out the second window's staging.

    The chosen E is logged, and the train loop persists it next to the
    checkpoints (<ckpt_dir>/window_epochs.json) and reuses it on resume:
    the index stream depends on E, and calibration timing is not
    deterministic."""
    probe = StreamingPoolSampler(dataset, batch_size, device,
                                 window_bytes=window_bytes, window_epochs=1,
                                 steps=None, seed=seed,
                                 byte_budget=byte_budget)
    try:
        windows = probe._windows(2)
        t0 = time.perf_counter()
        next(windows)
        # A consuming read is the barrier: gather one batch and bring a
        # row-slice per example to the host, which waits for the window.
        g_img, g_dep = probe.gather(to_index(
            np.zeros(probe.per_dev, np.int32), probe.device))
        (g_img.reshape(g_img.shape[0], -1)[:, 0].cpu(),
         g_dep.reshape(g_dep.shape[0], -1)[:, 0].cpu())
        t_stage = time.perf_counter() - t0

        def blocks():
            for idx in probe._window_local_indices():
                yield to_index(idx[None], probe.device)

        run_pass(probe, blocks())  # warm-up
        t0 = time.perf_counter()
        run_pass(probe, blocks())  # timed
        t_train = time.perf_counter() - t0
    finally:
        probe.close()
    batches_per_window = probe.win_shard // probe.per_dev
    e = pick_window_epochs(t_stage, t_train, batches_per_window,
                           steps_per_dispatch, max_epochs=max_epochs)
    log.info(
        "auto window-epochs: staging %.2fs vs %.3fs/pass (%d batches) "
        "-> echo x%d (pin with --window-epochs %d for reproducible "
        "resumes)", t_stage, t_train, batches_per_window, e, e)
    return e


class StreamingPoolSampler:
    """Iterable of (img_u8, depth) device batches gathered from a rotating
    device window pool, with DevicePoolSampler's loop contract
    (`__iter__`, `index_blocks`, `pool_img`/`pool_dep`/`gather`, `nbytes`,
    `close`). `pool_img`/`pool_dep` are the active window's buffers; they
    hold the current window once `__iter__` or `index_blocks` has reached
    it."""

    def __init__(self, dataset, batch_size, device=None, *, window_bytes,
                 window_epochs=1, steps=None, seed=0,
                 byte_budget=DEFAULT_BYTE_BUDGET,
                 stage_chunk_bytes=STAGE_CHUNK_BYTES, rank=0, nproc=1):
        # The JAX sampler on a data axis of `nproc` ranks, one device each:
        # every rank walks the same window permutations and stages its
        # block of each window; rank r is process index r.
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if batch_size % nproc:
            raise ValueError(
                f"batch_size={batch_size} not divisible by data axis "
                f"{nproc}")
        if window_epochs < 1:
            raise ValueError(
                f"window_epochs must be >= 1, got {window_epochs}")
        self.per_dev = batch_size // nproc
        self.batch_size = batch_size
        self.window_epochs = window_epochs

        img0, dep0 = dataset[0]
        img0, dep0 = np.asarray(img0), np.asarray(dep0)
        ex_bytes = img0.nbytes + dep0.nbytes
        # Window rows: a multiple of batch_size so every window splits into
        # whole batches (no silent within-window drops), derived from the
        # requested byte size.
        win = (int(window_bytes) // ex_bytes) // batch_size * batch_size
        if win < batch_size:
            raise ValueError(
                f"cache window of {window_bytes / 1e6:.0f} MB holds "
                f"{int(window_bytes) // ex_bytes} examples "
                f"({ex_bytes / 1e6:.2f} MB each) — smaller than one "
                f"batch_size={batch_size}; raise --cache-window-mb")
        n = len(dataset)
        if win >= n:
            raise ValueError(
                f"cache window ({win} examples) >= dataset (n={n}): "
                "windowing would re-stage the whole set every pass — drop "
                "--cache-window-mb and use plain --cache-device")
        # Two windows resident (active + staging) is the design's device
        # footprint; each rank holds win/nproc rows of each.
        win_proc_bytes = (win // nproc) * ex_bytes
        if 2 * win_proc_bytes > byte_budget:
            raise ValueError(
                f"double-buffered window needs 2 x {win_proc_bytes / 1e9:.1f}"
                f" GB per process — over the {byte_budget / 1e9:.1f} GB "
                "device-cache budget; lower --cache-window-mb")
        self.n = n
        self.win = win
        self.win_shard = win // nproc
        self._rank = rank
        self.nbytes = 2 * win_proc_bytes  # budget accounting (eval pool)
        self.steps = steps
        self.steps_per_window = (self.win_shard // self.per_dev
                                 ) * window_epochs
        self.windows_per_pass = n // win
        self.device = torch.device(device or "cpu")
        self._chunk_bytes = stage_chunk_bytes
        self._dataset = dataset
        # The window permutations (shared by the ranks) and the echo
        # epochs' permutations (shard-local, decorrelated across ranks).
        self._window_rng = np.random.default_rng(seed)
        self._rng = np.random.default_rng(seed + 1000003 * rank)

        self.pool_img, self.pool_dep = pool_buffers(self.win_shard, img0,
                                                    dep0, self.device)
        self._staged = pool_buffers(self.win_shard, img0, dep0, self.device)
        self._cuda = self.device.type == "cuda"
        # The event after which the staging buffer may be overwritten: its
        # window was copied into the active buffer (nothing yet).
        self._free = None
        if self._cuda:
            self._free = torch.cuda.Event()
            self._free.record(torch.cuda.current_stream(self.device))

        # Staging worker: strict request/response handshake — the worker
        # stages exactly one window per request, so at most two windows
        # are ever resident (the active one + the one being staged).
        self._req = queue.Queue()
        self._res = queue.Queue()
        self._worker = threading.Thread(
            target=self._stage_worker, daemon=True,
            name="streaming-pool-stager")
        self._worker.start()
        self._pending = 0  # requests issued minus results consumed
        log.info(
            "streaming pool: %d windows of %d examples per pass "
            "(%.0f MB x2 resident), %d steps/window (echo x%d), dataset "
            "n=%d", self.windows_per_pass, win, win_proc_bytes / 1e6,
            self.steps_per_window, window_epochs, n)

    # -- staging -----------------------------------------------------------

    def _stage_worker(self):
        stream = None
        while True:
            req = self._req.get()
            if req is None:
                return
            perm, free = req
            try:
                if self._cuda and stream is None:
                    bind_thread(self.device)
                    stream = torch.cuda.Stream(self.device)
                if free is not None:
                    stream.wait_event(free)
                lo = self._rank * self.win_shard
                self._res.put(stage_rows(
                    RowView(self._dataset, perm[lo:lo + self.win_shard]),
                    self.win_shard, *self._staged, self._chunk_bytes,
                    stream=stream))
            except BaseException as e:  # surface in the train loop
                self._res.put(e)
                return

    def _window_perms(self):
        """Infinite stream of per-window permutation slices: each pass is
        one fresh permutation partitioned into full windows."""
        while True:
            pass_perm = self._window_rng.permutation(self.n)
            for w in range(self.windows_per_pass):
                yield pass_perm[w * self.win:(w + 1) * self.win]

    def _activate(self, staged_event):
        """Make the staged window the active one: the consumer's stream
        waits for its staging, copies it into the active buffers and
        records when the staging buffer is free again."""
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(staged_event)
        self.pool_img.copy_(self._staged[0])
        self.pool_dep.copy_(self._staged[1])
        if self._cuda:
            self._free = torch.cuda.Event()
            self._free.record(torch.cuda.current_stream(self.device))

    def _windows(self, count):
        """Make `count` staged windows active in turn (yielding the active
        buffers at each), keeping one staging request in flight so the
        next window uploads while the current one trains — and never
        requesting a window that won't be consumed (a run would otherwise
        end by staging one full window nobody reads, and close() would sit
        out that transfer)."""
        if count < 1:
            return
        perms = self._window_perms()
        self._req.put((next(perms), self._free))
        self._pending += 1
        issued = 1
        for _ in range(count):
            res = self._res.get()
            self._pending -= 1
            if isinstance(res, BaseException):
                raise RuntimeError(
                    "streaming pool staging worker failed") from res
            self._activate(res)
            if issued < count:
                self._req.put((next(perms), self._free))
                self._pending += 1
                issued += 1
            yield self.pool_img, self.pool_dep

    # -- sampling ----------------------------------------------------------

    def gather(self, idx):
        """(pool_img[idx], pool_dep[idx]) from the active window."""
        return self.pool_img[idx], self.pool_dep[idx]

    def _total_steps(self):
        # steps=None -> exactly one pass over the windowed dataset.
        return (self.windows_per_pass * self.steps_per_window
                if self.steps is None else self.steps)

    def _window_local_indices(self):
        """steps_per_window window-local index rows [per_dev] i32 for ONE
        window visit: window_epochs fresh permutations of the window."""
        batches = self.win_shard // self.per_dev
        for _ in range(self.window_epochs):
            perm = self._rng.permutation(self.win_shard)
            for b in range(batches):
                yield perm[b * self.per_dev:(b + 1) * self.per_dev].astype(
                    np.int32)

    def _windows_needed(self, total_steps):
        return -(-total_steps // self.steps_per_window)

    def __iter__(self):
        step, total = 0, self._total_steps()
        windows = self._windows(self._windows_needed(total))
        while step < total:
            next(windows)
            for idx in self._window_local_indices():
                if step >= total:
                    break
                yield self.gather(to_index(idx, self.device))
                step += 1

    def index_blocks(self, k: int):
        """[k, per_dev] int64 device index blocks for the K-step driver —
        the same stream __iter__ walks. The active window changes at window
        boundaries BEFORE the window's first block is yielded, so k must
        divide steps_per_window: a block gathers from ONE window."""
        if k < 1:
            raise ValueError(f"index_blocks needs k >= 1, got {k}")
        if self.steps_per_window % k:
            batches = self.win_shard // self.per_dev
            raise ValueError(
                f"steps_per_dispatch={k} must divide the window's "
                f"{self.steps_per_window} steps ({batches}"
                f" batches x {self.window_epochs} echo epochs): a K-step "
                "block gathers from ONE resident window — align the window "
                "size (--cache-window-mb) or K")
        total = self._total_steps()
        if total % k:
            raise ValueError(
                f"steps={total} is not divisible by the {k}-step dispatch "
                "block (validated upstream; this is a hard shape "
                "constraint of the K-step dispatch)")
        step, windows = 0, self._windows(self._windows_needed(total))
        while step < total:
            next(windows)
            stream = self._window_local_indices()
            for _ in range(self.steps_per_window // k):
                if step >= total:
                    break
                yield to_index(np.stack([next(stream) for _ in range(k)]),
                               self.device)
                step += k

    def close(self):
        """Stop the staging worker and drop the resident windows."""
        self._req.put(None)
        # Unblock a worker that already finished a request nobody will
        # consume, then drop the buffers. The timeout only bites when close
        # lands mid-staging on a slow link; the worker is a daemon thread,
        # so a timed-out join leaks the window until process exit, no hang.
        while self._pending > 0:
            try:
                self._res.get(timeout=600.0)
            except queue.Empty:
                break
            self._pending -= 1
        self._worker.join(timeout=60.0)
        self.pool_img = self.pool_dep = self._staged = None
