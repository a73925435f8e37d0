"""Tracing and profiling of the port's loops.

Counterpart of `ann3depth_tpu/utils/tracing.py`, on torch.profiler:

- `start_trace(device)` / `stop_trace(prof, logdir)`: a window of
  host (CPU) and, on the card, CUDA activity, written as a Chrome trace
  (`trace_<pid>_<n>.json`, viewable in Perfetto or chrome://tracing) into
  logdir.
- `device_sync(device)`: wait for the device's queued work
  (`torch.cuda.synchronize`; nothing to wait for on the CPU).
"""

from __future__ import annotations

import itertools
import os

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
