"""The benchmark's own counts, trace arithmetic and metric readers, on
synthetic profiler events."""

import pytest

from portbench import spec, trace
from portbench.counts import flops, preprocess


def test_byte_bound_at_the_train_shape():
    # b16: 480x640 uint8 frames -> 240x320 f32, and the 305x55 grid ->
    # 120x160: 8.8 us and 0.69 us at 3.35 TB/s.
    img = preprocess.bound_s(preprocess.call_bytes(16, (480, 640),
                                                   (240, 320), 3, 1))
    dep = preprocess.bound_s(preprocess.call_bytes(16, (305, 55),
                                                   (120, 160), 1, 4))
    assert img * 1e6 == pytest.approx(8.80, abs=0.01)
    assert dep * 1e6 == pytest.approx(0.69, abs=0.01)
    assert preprocess.train_step_bound_s(16, (480, 640), (305, 55),
                                         (240, 320), (120, 160)) == \
        pytest.approx(img + dep)


def test_step_flops_on_the_reference():
    enc = flops.model_flops("encdec", {"width_mult": 1.0}, (240, 320), 16,
                            backward=True)
    assert enc / 1e12 == pytest.approx(0.1178, rel=1e-3)
    fwd = flops.model_flops("encdec", {"width_mult": 1.0}, (240, 320), 16,
                            backward=False)
    # backward is about twice the forward; no gradient of the input itself
    assert 2.8 < enc / fwd < 3.0
    assert flops.model_flops("encdec", {}, (240, 320), 1, False) * 16 == fwd


def test_union_and_idle_intervals():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert trace.union_us(spans) == 30
    assert trace.idle_intervals(spans, 0, 50) == [(20, 30), (40, 50)]
    assert trace.idle_intervals(spans, -5, 25) == [(-5, 0), (20, 25)]


def test_summary_clips_to_the_window_and_labels_gaps():
    device = [("k1", 0, 100), ("band_resample_kernel", 150, 160),
              ("k1", 160, 300), ("k1", 305, 400), ("k2", 500, 600)]
    host = [("portbench.traced_window", 50, 550),
            ("portbench.feed_wait", 90, 155), ("aten::copy_", 95, 150),
            ("portbench.step", 400, 520), ("cudaGraphLaunch", 410, 500)]
    window = trace.window_of(host, "traced_window")
    s = trace.summarize(device, host, window)
    assert s.window_s == pytest.approx(500e-6)
    assert s.busy_s == pytest.approx((50 + 10 + 140 + 95 + 50) * 1e-6)
    assert s.device_seconds("band_resample") == pytest.approx(10e-6)
    assert dict(s.gaps) == pytest.approx({
        "feed_wait/aten::copy_": 50e-6, "kernel_to_kernel": 5e-6,
        "step/cudaGraphLaunch": 100e-6})
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k1"
    assert b["idle_gaps"][0] == ["step/cudaGraphLaunch", pytest.approx(1e-4)]


def _summary():
    return trace.TraceSummary(window_s=0.5, busy_s=0.4,
                              by_name={"band_resample_kernel": 0.001,
                                       "photometric_kernel": 0.0002,
                                       "gemm": 0.3}, gaps=[])


def test_train_readers():
    ctx = {"kind": "train", "steps": 100, "window_s": 2.0, "batch": 16,
           "feed_wait_s": 0.3, "step_flops": 1e12, "trace": _summary(),
           "traced_steps": 40, "preprocess_bound_s": 9.5e-6}
    read = {m: spec.reader(m)(ctx) for m in (
        "mfu.train", "feed_wait_ms.train", "preprocess_roofline.train",
        "device_idle.train")}
    assert read["mfu.train"] == pytest.approx(100 * 50e12 / 989e12)
    assert read["feed_wait_ms.train"] == pytest.approx(3.0)
    assert read["preprocess_roofline.train"] == pytest.approx(
        100 * 9.5e-6 * 40 / 0.0012)
    assert read["device_idle.train"] == pytest.approx(20.0)


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = {"kind": "train", "steps": 10, "window_s": 1.0, "batch": 16,
           "feed_wait_s": 0.0, "step_flops": 1.0, "traced_steps": 3,
           "preprocess_bound_s": 1e-6,
           "trace": trace.TraceSummary(0.1, 0.05, {"gemm": 0.05}, [])}
    assert spec.reader("preprocess_roofline.train")(ctx) is None
