"""The program's own spans (`a3d.*`) and its runner's counters in a traced
run of a training cell.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once as `python3 -m portbench ... --trace 1` does (its result
line first), keeps the traced window's profiler events and the train
step runner's counters, and prints one more JSON line:

- `spans`: each program span's count and host seconds in the traced window;
- `idle_in`: the device's idle seconds in the window by the innermost
  program span that covers them (the covering span that began last),
  from the exact intersection of the idle intervals with the spans;
  "outside" where none covers them;
- `gaps`: the idle gaps (trace.py's, 20 us and longer) labelled
  `<harness span>/<innermost program span>/<host op>`, the middle part
  left out where no program span covers the gap's middle;
- `counters`: the runner's `captures`, `replays` and `eager_steps` added
  in the timed window and in the traced run (None where the program has
  no such counter);
- `clocks`: how many `cudaGraphLaunch` host events lie inside an
  `a3d.dispatch.replay` span, and how many host-to-device copies on the
  device start inside an `a3d.pool.index_copy` span, each of how many;
- `readings`: mean host ms of `a3d.pool.index_copy` and host us of
  `a3d.dispatch.run` a traced step, the share of the window (%) in which
  the device idled inside an `a3d.dispatch.*` span, and the captures and
  eager steps added over both windows.

The harness's own files are read, not changed: the events and counters
are taken by wrapping `trace.events_of` and `TrainRun.window`/`traced`.
"""

from __future__ import annotations

import json
import sys

from portbench import run, trace

PROGRAM = "a3d."
COUNTERS = ("captures", "replays", "eager_steps")


def program_spans(host, window):
    """The program's spans that overlap `window`, clipped to it."""
    lo, hi = window
    return [(n, max(s, lo), min(e, hi)) for n, s, e in host
            if n.startswith(PROGRAM) and e > lo and s < hi]


def span_seconds(spans):
    """{name: [count, host seconds]} of (name, start_us, end_us) spans."""
    out = {}
    for n, s, e in spans:
        count, seconds = out.get(n, (0, 0.0))
        out[n] = [count + 1, seconds + (e - s) / 1e6]
    return out


def _innermost(covering):
    return max(covering, key=lambda sp: (sp[1], -sp[2]))[0]


def idle_in_spans(idle, spans):
    """{span name or "outside": idle seconds}: every stretch of the sorted,
    disjoint `idle` intervals goes to the innermost span covering it."""
    points = sorted({p for a, b in idle for p in (a, b)}
                    | {p for _, s, e in spans for p in (s, e)})
    by_start = sorted(spans, key=lambda sp: sp[1])
    by_end = sorted(range(len(by_start)), key=lambda i: by_start[i][2])
    covering, si, ei, gi = set(), 0, 0, 0
    out = {}
    for a, b in zip(points, points[1:]):
        while si < len(by_start) and by_start[si][1] <= a:
            covering.add(si)
            si += 1
        while ei < len(by_end) and by_start[by_end[ei]][2] <= a:
            covering.discard(by_end[ei])
            ei += 1
        while gi < len(idle) and idle[gi][1] <= a:
            gi += 1
        if gi < len(idle) and idle[gi][0] <= a:
            name = (_innermost([by_start[i] for i in covering])
                    if covering else "outside")
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def label(gap, host):
    """`<harness span>/<innermost program span>/<host op>` of an idle gap:
    the spans that cover its middle, and the host operation (neither a
    harness nor a program span) that overlaps it most."""
    mid = 0.5 * (gap[0] + gap[1])
    covering = [h for h in host if h[1] <= mid <= h[2]]
    harness = [h for h in covering if h[0].startswith(trace.HARNESS)]
    parts = [min(harness, key=lambda h: h[2] - h[1])[0][len(trace.HARNESS):]
             if harness else "outside"]
    program = [h for h in covering if h[0].startswith(PROGRAM)]
    if program:
        parts.append(_innermost(program))
    best, best_overlap = None, 0.0
    for name, start, end in host:
        if name.startswith((trace.HARNESS, PROGRAM)):
            continue
        overlap = min(end, gap[1]) - max(start, gap[0])
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    if best:
        parts.append(best)
    return "/".join(parts)


def gaps(idle, host):
    """[(label, seconds)] of the idle intervals, longest first."""
    out = {}
    for gap in idle:
        name = ("kernel_to_kernel" if gap[1] - gap[0] < trace.SHORT_GAP_US
                else label(gap, host))
        out[name] = out.get(name, 0.0) + (gap[1] - gap[0]) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def counters(runner):
    """The runner's counters (None where it has no such counter)."""
    return {k: getattr(runner, k, None) for k in COUNTERS}


def added(before, after):
    return {k: (None if before[k] is None else after[k] - before[k])
            for k in COUNTERS}


def _inside(t, spans):
    return any(s <= t <= e for _, s, e in spans)


def clocks(device, host, window):
    """[inside, of] for the replays' graph launches and the index copies."""
    lo, hi = window
    replay = [sp for sp in host if sp[0] == PROGRAM + "dispatch.replay"]
    index = [sp for sp in host if sp[0] == PROGRAM + "pool.index_copy"]
    launches = [s for n, s, _ in host
                if n.startswith("cudaGraphLaunch") and lo <= s <= hi]
    copies = [s for n, s, _ in device
              if "HtoD" in n and lo <= s <= hi]
    return {"graph_launch_in_replay": [sum(_inside(t, replay)
                                           for t in launches),
                                       len(launches)],
            "htod_in_index_copy": [sum(_inside(t, index) for t in copies),
                                   len(copies)]}


def summary(device, host, counts, traced_steps):
    """The line this module prints, from the events of the traced run."""
    window = trace.window_of(host, "traced_window")
    lo, hi = window
    busy = [(max(s, lo), min(e, hi)) for _, s, e in device
            if e > lo and s < hi]
    idle = trace.idle_intervals(busy, lo, hi)
    spans = program_spans(host, window)
    seconds = span_seconds(spans)
    idle_in = idle_in_spans(idle, spans)
    window_s = (hi - lo) / 1e6

    def host_s(name):
        return seconds.get(PROGRAM + name, [0, 0.0])[1]

    both = [counts[w] for w in ("window", "traced") if w in counts]
    recaptures = (None if not both or any(c["eager_steps"] is None
                                          for c in both)
                  else sum(c["captures"] + c["eager_steps"] for c in both))
    return {
        "spans": seconds, "idle_in": idle_in,
        "gaps": [[n[:160], s] for n, s in gaps(idle, host)[:16]],
        "counters": counts, "clocks": clocks(device, host, window),
        "readings": {
            "index_copy_ms.train":
                1e3 * host_s("pool.index_copy") / traced_steps,
            "dispatch_host_us.train":
                1e6 * host_s("dispatch.run") / traced_steps,
            "idle_in_dispatch.train": 100.0 * sum(
                s for n, s in idle_in.items()
                if n.startswith(PROGRAM + "dispatch.")) / window_s,
            "recaptures.train": recaptures}}


def main(argv=None):
    from portbench.modes import train

    kept, counts = {}, {}
    events_of, window, traced = (trace.events_of, train.TrainRun.window,
                                 train.TrainRun.traced)

    def keep_events(prof):
        kept["events"] = events_of(prof)
        return kept["events"]

    def counted(name, method):
        def wrapped(self, *a, **kw):
            before = counters(self.runner)
            out = method(self, *a, **kw)
            counts[name] = added(before, counters(self.runner))
            kept["traced_steps"] = int(self.traffic["trace_steps"])
            return out
        return wrapped

    trace.events_of = keep_events
    train.TrainRun.window = counted("window", window)
    train.TrainRun.traced = counted("traced", traced)
    try:
        rc = run.main(list(argv if argv is not None else sys.argv[1:])
                      + ["--trace", "1"])
    finally:
        trace.events_of = events_of
        train.TrainRun.window, train.TrainRun.traced = window, traced
    if rc or "events" not in kept:
        return rc or 1
    device, host = kept["events"]
    print(json.dumps(summary(device, host, counts, kept["traced_steps"])),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
