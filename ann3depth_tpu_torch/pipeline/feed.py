"""Prefetching host->device feed.

Counterpart of `ann3depth_tpu/pipeline/feed.py` (`DeviceFeed`). Under
data parallelism each rank's feed hands out its own rows (its shard's
batches, parallel/multihost.py): one process per device has no global
batch to assemble from the processes' rows. A background thread pulls host batches (tuples of numpy arrays,
as the loaders' `batches` yield them) from an iterator and issues their
transfers ahead of the step that consumes them:

- each batch is copied into a pinned host buffer, one of a ring of
  `prefetch + 1` (a buffer per shape and dtype in each slot, so
  interleaved datasets of different shapes keep theirs);
- the pinned buffer goes to the device with `copy_(non_blocking=True)` on
  a side CUDA stream, and an event is recorded after it; the thread waits
  for a slot's previous event before it writes into that slot again;
- a bounded queue of depth `prefetch` (default 2, double buffering) holds
  the device batches, so at most `prefetch` batches wait on the device.

While a profiler window is open (`utils.tracing.active()`) the thread
records the spans `a3d.feed.read` (the host iterator's next batch),
`a3d.feed.slot_wait` (the wait for a slot's last copy), `a3d.feed.copy`
(the pinned copy and the transfer's issue) and `a3d.feed.put` (the queue
put), and the consumer `a3d.feed.get` (the queue get).

`__next__` makes the consumer's current stream wait on the batch's event
and marks each tensor as used on that stream (`record_stream`), so neither
its device memory nor its pinned buffer is reused before the consumer's
work on it is done. The host ships uint8 frames, not f32: the normalization
runs on the device (ops/fused_preprocess.py).

On the CPU the same thread hands out CPU tensors (`torch.from_numpy`) in
the same order, with no pinning. The contract of the JAX feed holds on
both: batches in order, an error of the host iterator re-raised in the
consumer, and `close()` ends a producer blocked on a full queue.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ann3depth_tpu_torch.pipeline.device_cache import bind_thread, torch_dtype
from ann3depth_tpu_torch.utils import tracing

_SENTINEL = object()


class DeviceFeed:
    """Wrap a host batch iterator into a prefetcher of device batches."""

    def __init__(self, host_iter: Iterator, device=None, prefetch: int = 2):
        self._host_iter = host_iter
        self._device = torch.device(device or "cpu")
        self._cuda = self._device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            # slot -> {(shape, dtype): pinned buffer}; slot -> last copy
            self._pinned = [{} for _ in range(max(1, prefetch) + 1)]
            self._copied = [None] * len(self._pinned)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-feed")
        self._thread.start()

    def _put_device(self, batch, slot):
        if not self._cuda:
            return tuple(torch.from_numpy(np.asarray(x)) for x in batch)
        if self._copied[slot] is not None:
            with tracing.span("feed.slot_wait"):
                self._copied[slot].synchronize()  # the slot's last copy
        bufs = self._pinned[slot]
        out = []
        with tracing.span("feed.copy"), torch.cuda.stream(self._stream):
            for x in batch:
                x = np.asarray(x)
                key = (x.shape, x.dtype.str)
                if key not in bufs:
                    bufs[key] = torch.empty(x.shape,
                                            dtype=torch_dtype(x.dtype),
                                            pin_memory=True)
                host = bufs[key]
                host.copy_(torch.from_numpy(x))
                dev = torch.empty(x.shape, dtype=host.dtype,
                                  device=self._device)
                dev.copy_(host, non_blocking=True)
                out.append(dev)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._copied[slot] = event
        return tuple(out), event

    def _worker(self):
        try:
            bind_thread(self._device)
            host_iter = iter(self._host_iter)
            for i in itertools.count():
                with tracing.span("feed.read"):
                    batch = next(host_iter, _SENTINEL)
                if batch is _SENTINEL or self._stop.is_set():
                    return
                item = self._put_device(
                    batch, i % len(self._pinned) if self._cuda else 0)
                # stop-aware put: close() may have drained and gone away
                with tracing.span("feed.put"):
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except BaseException as e:  # surface in the consumer thread
            self._err = e
        finally:
            # deliver the sentinel without deadlocking if the consumer is
            # gone (queue full + nobody draining after close()).
            while True:
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def __iter__(self):
        return self

    def __next__(self):
        with tracing.span("feed.get"):
            item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        if not self._cuda:
            return item
        batch, event = item
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)
        for t in batch:
            t.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        # Drain so the worker can exit if blocked on put().
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
