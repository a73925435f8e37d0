"""Reduction of a torch.profiler window to device time, busy share and idle
gaps.

The arithmetic follows the program's own probes (device time by kernel
summed over the window; the device busy time as the union of the device
operations' intervals; the window from its first to its last instant),
rewritten here over plain tuples so that it can be tested on synthetic
events:

- device ops: (name, start_us, end_us), kernels, copies and sets;
- host spans: (name, start_us, end_us), the harness's own spans
  ("portbench.*") and the host operations the profiler saw.
"""

from __future__ import annotations

import dataclasses

HARNESS = "portbench."
# Idle gaps shorter than this sit between two kernels of one launch
# sequence (a graph replay or a burst of launches): the device's own
# turnaround, not a wait on the host.
SHORT_GAP_US = 20.0


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_name: dict          # device op name -> seconds in the window
    gaps: list             # [(label, seconds)] idle intervals, longest first

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of the ops whose name holds `pattern`."""
        return sum(s for n, s in self.by_name.items() if pattern in n)


def events_of(prof):
    """(device ops, host spans) of a stopped torch.profiler.profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            device.append((e.name, start, end))
        else:
            host.append((e.name, start, end))
    return device, host


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def idle_intervals(intervals, lo, hi):
    """The intervals of [lo, hi] that no (start, end) covers."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def _label(gap, host):
    """What the host was doing in an idle gap: the harness span that covers
    its middle, and the host operation inside the gap that overlaps it
    most."""
    mid = 0.5 * (gap[0] + gap[1])
    spans = [h for h in host if h[0].startswith(HARNESS)
             and h[1] <= mid <= h[2]]
    span = (min(spans, key=lambda h: h[2] - h[1])[0][len(HARNESS):]
            if spans else "outside")
    best, best_overlap = None, 0.0
    for name, start, end in host:
        if name.startswith(HARNESS):
            continue
        overlap = min(end, gap[1]) - max(start, gap[0])
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return f"{span}/{best}" if best else span


def summarize(device, host, window):
    """TraceSummary of the device ops inside `window` (start_us, end_us),
    each clipped to it."""
    lo, hi = window
    clipped = [(n, max(s, lo), min(e, hi)) for n, s, e in device
               if e > lo and s < hi]
    by_name = {}
    for n, s, e in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    spans = [(s, e) for _, s, e in clipped]
    gaps = {}
    for gap in idle_intervals(spans, lo, hi):
        label = ("kernel_to_kernel" if gap[1] - gap[0] < SHORT_GAP_US
                 else _label(gap, host))
        gaps[label] = gaps.get(label, 0.0) + (gap[1] - gap[0]) / 1e6
    return TraceSummary(window_s=(hi - lo) / 1e6,
                        busy_s=union_us(spans) / 1e6, by_name=by_name,
                        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def window_of(host, name):
    """(start, end) of the harness span `name` (the last one)."""
    spans = [(s, e) for n, s, e in host if n == HARNESS + name]
    if not spans:
        raise ValueError(f"the trace holds no span {HARNESS + name}")
    return spans[-1]


def breakdown(summary: TraceSummary, top=10):
    ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in summary.gaps[:top]]}
