"""Tracing and profiling of the port's loops.

Counterpart of `ann3depth_tpu/utils/tracing.py`, on torch.profiler:

- `start_trace(device)` / `stop_trace(prof, logdir)`: a window of
  host (CPU) and, on the card, CUDA activity, written as a Chrome trace
  (`trace_<pid>_<n>.json`, viewable in Perfetto or chrome://tracing) into
  logdir.
- `trace(logdir, device)`: the same window as a context manager around a
  block.
- `device_sync(device)`: wait for the device's queued work
  (`torch.cuda.synchronize`; nothing to wait for on the CPU).
- `StepTimer`: a host-side ring of recent step wall times -> p50/p99/mean.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time

import numpy as np
import torch

_TRACE_IDS = itertools.count()


def device_sync(device) -> None:
    """Block until every kernel queued on `device` has finished."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start_trace(device):
    """Start a torch.profiler window of CPU activity, and CUDA activity
    when `device` is a card; returns the running profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, logdir: str) -> str:
    """Stop the window and write its Chrome trace into logdir; returns the
    trace file's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """torch.profiler window around a block, written into logdir:
    with trace('/tmp/tb'): ... (device="cpu" traces host activity only)."""
    prof = start_trace(device)
    try:
        yield
    finally:
        device_sync(device)
        stop_trace(prof, logdir)


class StepTimer:
    """Rolling wall-time stats for loop steps."""

    def __init__(self, window: int = 200):
        self._times = collections.deque(maxlen=window)
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def stats(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p99": float(np.percentile(arr, 99) * 1e3),
            "step_ms_mean": float(arr.mean() * 1e3),
        }
