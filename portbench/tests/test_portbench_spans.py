"""The program's spans in a traced window (spans.py), on synthetic profiler
events, and the whole tool on a CPU stand-in of the pool cell."""

import json

import pytest

from portbench import spans, trace

DEVICE = [("k1", 0, 100), ("Memcpy HtoD (Pageable -> Device)", 112, 113),
          ("k1", 160, 300), ("k1", 305, 400), ("k2", 500, 600)]
HARNESS = [("portbench.traced_window", 50, 550),
           ("portbench.feed_wait", 90, 155), ("aten::copy_", 95, 150),
           ("portbench.step", 160, 520), ("cudaGraphLaunch", 410, 500)]
PROGRAM = [("a3d.pool.index_copy", 100, 150),
           ("a3d.dispatch.run", 400, 515),
           ("a3d.dispatch.replay", 405, 505),
           ("a3d.dispatch.out", 505, 512)]


def _idle(window=(50, 550)):
    busy = [(max(s, window[0]), min(e, window[1])) for _, s, e in DEVICE]
    return trace.idle_intervals(sorted(busy), *window)


def test_idle_goes_to_the_innermost_span():
    idle = _idle()
    assert idle == [(100, 112), (113, 160), (300, 305), (400, 500)]
    got = spans.idle_in_spans(idle, spans.program_spans(PROGRAM,
                                                        (50, 550)))
    assert got == pytest.approx({
        "outside": (10 + 5) * 1e-6, "a3d.pool.index_copy": (12 + 37) * 1e-6,
        "a3d.dispatch.run": 5e-6, "a3d.dispatch.replay": 95e-6})
    # every idle microsecond counted once
    assert sum(got.values()) == pytest.approx(
        sum(b - a for a, b in idle) * 1e-6)


def test_nested_and_overlapping_spans():
    idle = [(0, 100)]
    nest = [("a3d.outer", 0, 100), ("a3d.inner", 20, 40),
            ("a3d.other_thread", 30, 60)]
    got = spans.idle_in_spans(idle, nest)
    # the covering span that began last takes the stretch
    assert got == pytest.approx({"a3d.outer": 60e-6, "a3d.inner": 10e-6,
                                 "a3d.other_thread": 30e-6})
    assert spans.span_seconds(nest)["a3d.outer"] == [1, pytest.approx(1e-4)]


def test_labels_name_the_program_span():
    host = HARNESS + PROGRAM
    assert spans.label((400, 500), host) == (
        "step/a3d.dispatch.replay/cudaGraphLaunch")
    assert spans.label((113, 160), host) == (
        "feed_wait/a3d.pool.index_copy/aten::copy_")
    # no program span at the middle: the middle part is left out
    assert spans.label((300, 320), host) == "step"
    assert spans.label((300, 320), HARNESS) == trace._label((300, 320),
                                                           HARNESS)
    assert dict(spans.gaps(_idle(), host)) == pytest.approx({
        "kernel_to_kernel": 17e-6,
        "feed_wait/a3d.pool.index_copy/aten::copy_": 47e-6,
        "step/a3d.dispatch.replay/cudaGraphLaunch": 100e-6})


def test_summarize_is_blind_to_the_program_spans():
    window = trace.window_of(HARNESS, "traced_window")
    a = trace.summarize(DEVICE, HARNESS, window)
    b = trace.summarize(DEVICE, HARNESS + PROGRAM, window)
    assert (a.window_s, a.busy_s, a.by_name) == (b.window_s, b.busy_s,
                                                 b.by_name)


def test_clocks_and_readings():
    counts = {"window": {"captures": 0, "replays": 9, "eager_steps": 0},
              "traced": {"captures": 0, "replays": 4, "eager_steps": 1}}
    out = spans.summary(DEVICE, HARNESS + PROGRAM, counts, traced_steps=1)
    assert out["clocks"] == {"graph_launch_in_replay": [1, 1],
                             "htod_in_index_copy": [1, 1]}
    r = out["readings"]
    assert r["index_copy_ms.train"] == pytest.approx(0.05)
    assert r["dispatch_host_us.train"] == pytest.approx(115.0)
    assert r["idle_in_dispatch.train"] == pytest.approx(100 * 100 / 500)
    assert r["recaptures.train"] == 1
    # a program without the eager step counter reads nothing
    counts["window"]["eager_steps"] = None
    out = spans.summary(DEVICE, HARNESS, counts, traced_steps=1)
    assert out["readings"]["recaptures.train"] is None
    assert out["readings"]["index_copy_ms.train"] == 0.0


def test_the_tool_on_the_cpu(cpu_cells, capsys, monkeypatch):
    from portbench import spec

    monkeypatch.setattr(spec, "limits", lambda name: {"limits": {}})
    assert spans.main(["--workload", "encdec.train.pool", "--seed",
                       str(2 ** 31 + 9), "--seconds", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result, out = json.loads(lines[-2]), json.loads(lines[-1])
    assert "device_idle.train" in result["metrics"]
    steps = 3  # conftest's trace_steps
    assert out["spans"]["a3d.pool.index_copy"][0] == steps
    assert out["spans"]["a3d.dispatch.run"][0] == steps
    # on the CPU nothing is captured: every step runs eagerly
    assert out["counters"]["window"]["captures"] == 0
    assert out["counters"]["traced"]["eager_steps"] == steps + 3
    assert out["readings"]["recaptures.train"] > 0
