"""The program's own spans and counters (utils/tracing.py), on the CPU.

A span is recorded only while a profiler window is open, on the thread
that opens it and, under `tracing.start_trace`, on the host feed's thread
too. The train step's runner (train/dispatch.py) records a span for each
part of a call and counts the steps it ran eagerly, captured and
replayed; here it runs a stand-in step (a sum of the gathered batch) and
a capture hook whose replay reruns the step's Python.
"""

import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ann3depth_tpu_torch.pipeline import device_cache
from ann3depth_tpu_torch.pipeline.feed import DeviceFeed
from ann3depth_tpu_torch.train import dispatch
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.utils import tracing


def _spans(prof):
    """The program's spans of a stopped profiler, in order of start."""
    events = sorted((e for e in prof.events() if e.name.startswith("a3d.")),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.start, e.time_range.end) for e in events]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_no_window_no_span():
    assert not tracing.active()
    assert tracing.span("dispatch.run") is tracing.span("pool.index_copy")
    with tracing.span("dispatch.run") as ctx:
        assert ctx is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
    assert not tracing.active()
    with tracing.span("dispatch.run"):
        torch.ones(2).sum()
    assert _spans(prof) == []


@pytest.fixture
def runner(monkeypatch):
    """A pool runner (K=1, b2) over a stand-in step and a capture hook."""

    def train_step(state, img, dep, draws=None, lr=None, **kw):
        state.step += 1
        return state, {"loss": img.float().sum() + dep.sum() + lr.sum()}

    state = types.SimpleNamespace(
        mesh=None, step=0,
        tx=types.SimpleNamespace(schedule=lambda s: 1e-3 * (s + 1)))

    def capture(run):
        def replay():  # a replay runs no Python: the step count stays
            step = state.step
            run()
            state.step = step
        return None, replay

    monkeypatch.setattr(steplib, "train_step", train_step)
    monkeypatch.setattr(dispatch.BlockRunner, "capture_hook",
                        staticmethod(capture))
    sampler = types.SimpleNamespace(
        device="cpu", per_dev=2, batch_size=2,
        pool_img=torch.arange(12, dtype=torch.uint8).reshape(6, 2),
        pool_dep=torch.ones(6, 3))
    return dispatch.BlockRunner(state, sampler, 1, step_kwargs={},
                                draw_seed=lambda s: s)


def _names(spans, parent):
    return [n for n, s, e in spans
            if n != parent[0] and _inside((n, s, e), parent)]


def test_runner_spans_and_counters(runner):
    idx = torch.tensor([[0, 3]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = runner.run(idx, more=True)
        second = runner.run(idx, more=True)
    spans = _spans(prof)
    runs = [s for s in spans if s[0] == "a3d.dispatch.run"]
    assert len(runs) == 2
    assert _names(spans, runs[0]) == [
        "a3d.dispatch.fill", "a3d.dispatch.eager", "a3d.dispatch.capture",
        "a3d.dispatch.out"]
    assert _names(spans, runs[1]) == [
        "a3d.dispatch.fill", "a3d.dispatch.replay", "a3d.dispatch.out"]
    assert (runner.eager_steps, runner.captures, runner.replays) == (1, 1, 1)
    assert runner.state.step == 2
    # the replay reran the step on the second step's learning rate
    assert float(second["loss"]) == pytest.approx(float(first["loss"])
                                                  + 1e-3)


def test_runner_counts_without_a_window(runner):
    idx = torch.tensor([[1, 2]])
    runner.run(idx, more=False)  # the last call: nothing captured
    assert (runner.eager_steps, runner.captures, runner.replays) == (1, 0, 0)
    for _ in range(3):
        runner.run(idx, more=True)
    assert (runner.eager_steps, runner.captures, runner.replays) == (2, 1, 2)


def test_index_copy_span_a_call():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        row = device_cache.to_index(np.arange(4, dtype=np.int32), "cpu")
        block = device_cache.to_index(np.zeros((3, 2), np.int32), "cpu")
    assert [n for n, _, _ in _spans(prof)] == ["a3d.pool.index_copy"] * 2
    assert row.dtype == block.dtype == torch.int64
    assert block.shape == (3, 2)


def test_active_on_a_worker_thread():
    seen = []
    worker = threading.Thread(target=lambda: seen.append(tracing.active()))
    with profile(activities=[ProfilerActivity.CPU]):
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    assert seen == [True]


def test_start_trace_records_the_feed_thread(tmp_path):
    batches = [(np.full((2, 3), i, np.uint8), np.ones(2, np.float32))
               for i in range(3)]
    prof = tracing.start_trace("cpu")
    try:
        feed = DeviceFeed(iter(batches), device="cpu")
        got = [int(img[0, 0]) for img, _ in feed]
        feed.close()
    finally:
        tracing.stop_trace(prof, str(tmp_path))
    assert got == [0, 1, 2]
    names = [n for n, _, _ in _spans(prof)]
    # three batches and the end of the iterator
    assert names.count("a3d.feed.read") == 4
    assert names.count("a3d.feed.put") == 3
    assert names.count("a3d.feed.get") == 4
    threads = {e.thread for e in prof.events()
               if e.name in ("a3d.feed.read", "a3d.feed.get")}
    assert len(threads) == 2


DPT_SPANS = ["a3d.dpt.embed", "a3d.dpt.blocks", "a3d.dpt.reassemble",
             "a3d.dpt.fusion", "a3d.dpt.head"]


def test_dpt_large_forward_spans():
    """DPT-Large's forward records its five spans, once each and in order,
    inside a CPU profiler window of one eager pass, and none outside it."""
    from ann3depth_tpu_torch.models.dpt_large import DPTLargeDepthNet

    model = DPTLargeDepthNet(dim=64, depth=4, heads=4, tap_layers=(0, 1, 2, 3),
                             widths=(16, 32, 64, 64), features=32)
    model.init_weights(torch.Generator().manual_seed(0), (64, 64))
    x = torch.randn(1, 64, 64, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    spans = _spans(prof)
    assert [s[0] for s in spans] == DPT_SPANS
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    model(x)
    assert _spans(prof) == []
