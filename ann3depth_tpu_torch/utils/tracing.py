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
- `span(name)`: the program's own spans, `a3d.<name>` ranges in the same
  trace as the CUDA activity and on its clock, recorded only while a
  profiler window is open (`active()`): `train --profile`'s window, or
  any `torch.profiler.profile` around the program. Outside a window a
  span is one read of a global and a shared no-op context.

The spans the program records:

- `a3d.pool.index_copy`: a pool sampler's index row or block to the
  device (`pipeline/device_cache.to_index`);
- `a3d.dispatch.run`, and inside it `a3d.dispatch.fill`, `.eager`,
  `.capture`, `.replay` and `.out`: a call of the train step's
  `BlockRunner` (`train/dispatch.py`), whose `captures`, `replays` and
  `eager_steps` count what it ran;
- `a3d.feed.read`, `.slot_wait`, `.copy`, `.put` on the host feed's
  thread, and `a3d.feed.get` on the consumer's (`pipeline/feed.py`).
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_TRACE_IDS = itertools.count()
_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether a torch.profiler window is open, on any thread (the
    profiler sets this module global while it runs; the thread-local
    `torch.autograd._profiler_enabled()` reads False on other threads)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """The context of the program's span `a3d.<name>`: a
    `record_function` range while a profiler window is open, a shared
    no-op context otherwise."""
    if active():
        return torch.profiler.record_function("a3d." + name)
    return _OFF


def device_sync(device) -> None:
    """Block until every kernel queued on `device` has finished."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start_trace(device):
    """Start a torch.profiler window of CPU activity, every thread's (the
    host feed's spans too), and CUDA activity when `device` is a card;
    returns the running profiler."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
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
