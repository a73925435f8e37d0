"""The port's live path (ann3depth_tpu_torch/live/*.py) against the JAX
package's, on the CPU.

Sizes: encdec at width 0.25 with a 32x48 input (the encdec input must be
divisible by 16, so not tests/test_live.py's 24x32), 16x24 depth, frames
48x64 (display resize at a non-integer factor, `resample_2d`) or 64x96
(exact x4, `upsample_matmul`). Flax params go through `convert.py`; frames
come from a numpy seed.

Tolerances:
- f32 compute, the JAX side with emit_s2d=0 (an f32 input, as the port
  feeds): log-depth within 1e-4 (f32 on both sides, summation order only).
- Rendered frames are compared by LUT index: a last-ulp difference in the
  normalized depth may move `int(norm * 255)` by one. Every pixel's index
  differs by at most 1, on at most 1% of the pixels.
- The JAX default (emit_s2d=4, a bf16 space-to-depth input, bf16 compute)
  against the port's bf16 model: linear depth within 3e-2 relative, the
  serving tolerance (tests/test_torch_serving.py); rendered indices within
  4 of each other and 1 apart on average (the bf16 models' log-depths
  differ by ~1e-2, up to ~2 steps of the 255-step display range here).
"""

import dataclasses
import functools
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.live import infer as jinfer
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.live import infer as tinfer
from ann3depth_tpu_torch.live.ring_buffer import FrameRingBuffer
from ann3depth_tpu_torch.models import encdec as tenc

ROOT = Path(__file__).resolve().parent.parent
IN_HW = (32, 48)
LOG_TOL = 1e-4
BF16_RTOL = 3e-2
MAX_INDEX_SHARE = 0.01


# ---------------------------------------------------------------------------
# The ring buffer and the capture thread (as tests/test_live.py:14-113).
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "python"])
def ring_kind(request):
    return request.param


def _mk_ring(kind, capacity=4, shape=(8, 8, 3)):
    rb = FrameRingBuffer(capacity, shape, force_python=(kind == "python"))
    assert rb.native == (kind == "native")  # g++ is on this machine
    return rb


def test_ringbuffer_source_is_the_packages():
    assert (ROOT / "ann3depth_tpu_torch/native/ringbuffer.cpp").read_bytes() \
        == (ROOT / "native/ringbuffer.cpp").read_bytes()


def test_ring_empty(ring_kind):
    rb = _mk_ring(ring_kind)
    frame, fid, drops = rb.pop_latest()
    assert frame is None and fid == -1 and drops == 0
    rb.close()


def test_ring_push_pop_roundtrip(ring_kind):
    rb = _mk_ring(ring_kind)
    f = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3) % 255
    rb.push(f)
    out, fid, drops = rb.pop_latest()
    np.testing.assert_array_equal(out, f)
    assert fid == 0 and drops == 0
    rb.close()


def test_ring_latest_semantics_and_drop_count(ring_kind):
    rb = _mk_ring(ring_kind)
    for i in range(3):
        rb.push(np.full((8, 8, 3), i, np.uint8))
    out, fid, _ = rb.pop_latest()
    assert fid == 2 and out[0, 0, 0] == 2
    for i in range(3, 6):
        rb.push(np.full((8, 8, 3), i, np.uint8))
    out, fid, drops = rb.pop_latest()
    assert fid == 5 and drops == 2  # frames 3,4 skipped
    stats = rb.stats()
    assert stats == {"pushed": 6, "popped": 2, "dropped": 2}
    rb.close()


def test_ring_overwrite_wraps(ring_kind):
    rb = _mk_ring(ring_kind, capacity=2)
    for i in range(10):
        rb.push(np.full((8, 8, 3), i * 20, np.uint8))
    out, fid, _ = rb.pop_latest()
    assert fid == 9 and out[0, 0, 0] == 180
    rb.close()


def test_ring_no_torn_frames_under_a_concurrent_producer(ring_kind):
    """A producer pushes while the consumer pops: every popped frame is
    whole (all bytes equal) and carries its own id."""
    rb = _mk_ring(ring_kind, capacity=3, shape=(32, 32, 3))
    n_frames, errors = 500, []

    def producer():
        for i in range(n_frames):
            rb.push(np.full((32, 32, 3), i % 251, np.uint8))

    stop = threading.Event()

    def consumer():
        while not stop.is_set():
            frame, fid, _ = rb.pop_latest()
            if frame is None:
                continue
            lo, hi = int(frame.min()), int(frame.max())
            if lo != hi or fid % 251 != lo:
                errors.append((fid, lo, hi))

    c, p = threading.Thread(target=consumer), threading.Thread(target=producer)
    c.start()
    p.start()
    p.join(timeout=60)
    stop.set()
    c.join(timeout=10)
    assert not errors, errors[:5]
    assert rb.stats()["pushed"] == n_frames
    rb.close()


def test_capture_thread_synthetic():
    from ann3depth_tpu_torch.live.capture import CaptureThread, SyntheticSource

    ring = FrameRingBuffer(4, (24, 32, 3))
    src = SyntheticSource((24, 32), fps=200.0)
    cap = CaptureThread(src, ring, target_fps=200.0).start()
    time.sleep(0.2)
    cap.stop()
    assert ring.stats()["pushed"] >= 5
    frame, fid, _ = ring.pop_latest()
    assert frame is not None and frame.shape == (24, 32, 3)
    ring.close()


def test_synthetic_source_matches_jax():
    from ann3depth_tpu.live.capture import SyntheticSource as J
    from ann3depth_tpu_torch.live.capture import SyntheticSource as T

    j, t = J((48, 64), seed=3), T((48, 64), seed=3)
    for _ in range(4):
        np.testing.assert_array_equal(t.read(), j.read())


# ---------------------------------------------------------------------------
# Colormaps, live_step and LiveEngine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["turbo", "viridis", "magma", "gray"])
def test_colormap_lut_matches_jax(name):
    got = tinfer.colormap_lut(name)
    assert got.dtype == torch.float32 and got.shape == (256, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jinfer.colormap_lut(name)))


def test_colormap_unknown_raises():
    assert tinfer.COLORMAPS == jinfer.COLORMAPS
    with pytest.raises(ValueError, match="unknown colormap"):
        tinfer.colormap_lut("jet")


@functools.lru_cache(maxsize=None)
def _params():
    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=0)
    return jax.tree.map(np.asarray, params)


def _models(compute="f32"):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jm = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jdt)
    tm = tenc.EncDecDepthNet(width_mult=0.25, compute_dtype=tdt)
    tm.load_state_dict(convert.to_state_dict(_params()), strict=True)
    return jm, tm.eval()


def _frames(n, hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _assert_rendered_close(got, want, colormap="turbo"):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = tinfer.lut_index_distance(got, want, colormap)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= MAX_INDEX_SHARE, (d > 0).mean()


def _jax_step(jm, frame, **kw):
    return jinfer.live_step(jm.apply, _params(), jnp.asarray(frame),
                            input_hw=IN_HW, **kw)


@pytest.mark.parametrize("frame_hw", [(48, 64), (64, 96)],
                         ids=["resample", "integer_x4"])
def test_live_step_matches_jax(frame_hw):
    jm, tm = _models()
    frame = _frames(1, frame_hw, seed=1)
    jd, jr = _jax_step(jm, frame, display_hw=frame_hw)
    td, tr = tinfer.live_step(tm, torch.from_numpy(frame), input_hw=IN_HW,
                              display_hw=frame_hw)
    assert td.shape == (1, 16, 24) and tr.shape == (1, *frame_hw, 3)
    np.testing.assert_allclose(np.log(td.numpy()), np.log(np.asarray(jd)),
                               rtol=0, atol=LOG_TOL)
    _assert_rendered_close(tr.numpy(), np.asarray(jr))


def test_live_step_tta_flip_matches_jax():
    jm, tm = _models()
    frames = _frames(2, (48, 64), seed=2)
    jd, jr = _jax_step(jm, frames, display_hw=(48, 64), tta="flip",
                       colormap="magma")
    td, tr = tinfer.live_step(tm, torch.from_numpy(frames), input_hw=IN_HW,
                              display_hw=(48, 64), tta="flip",
                              colormap="magma")
    np.testing.assert_allclose(np.log(td.numpy()), np.log(np.asarray(jd)),
                               rtol=0, atol=LOG_TOL)
    _assert_rendered_close(tr.numpy(), np.asarray(jr), "magma")
    with pytest.raises(ValueError, match="outside the turbo map"):
        tinfer.lut_index_distance(tr.numpy(), np.asarray(jr))
    with pytest.raises(ValueError, match="tta"):
        tinfer.live_step(tm, torch.from_numpy(frames), input_hw=IN_HW,
                         display_hw=(48, 64), tta="rotate")


def test_live_step_smoothing_over_three_frames_matches_jax():
    jm, tm = _models()
    frames = _frames(3, (64, 96), seed=3)
    jcarry = jnp.zeros((1, 16, 24), jnp.float32)
    tcarry = torch.zeros((1, 16, 24))
    for i in range(3):
        has_prev = float(i > 0)
        jd, jr, jcarry = _jax_step(
            jm, frames[i:i + 1], display_hw=(64, 96), smooth=0.7,
            prev_log=jcarry, has_prev=jnp.asarray(has_prev, jnp.float32))
        td, tr, tcarry = tinfer.live_step(
            tm, torch.from_numpy(frames[i:i + 1]), input_hw=IN_HW,
            display_hw=(64, 96), smooth=0.7, prev_log=tcarry,
            has_prev=torch.tensor(has_prev))
        np.testing.assert_allclose(tcarry.numpy(), np.asarray(jcarry),
                                   rtol=0, atol=LOG_TOL)
        np.testing.assert_allclose(np.log(td.numpy()),
                                   np.log(np.asarray(jd)), rtol=0,
                                   atol=LOG_TOL)
        _assert_rendered_close(tr.numpy(), np.asarray(jr))


def test_live_step_against_the_jax_default_bf16_s2d_input():
    """The JAX engine's default program (emit_s2d=4: a bf16 input) with the
    bf16 model, against the port's bf16 model fed f32."""
    jm, tm = _models("bf16")
    frame = _frames(1, (64, 96), seed=4)
    jd, jr = _jax_step(jm, frame, display_hw=(64, 96), emit_s2d=4)
    td, tr = tinfer.live_step(tm, torch.from_numpy(frame), input_hw=IN_HW,
                              display_hw=(64, 96))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=BF16_RTOL)
    d = tinfer.lut_index_distance(tr.numpy(), np.asarray(jr))
    assert d.max() <= 4 and d.mean() <= 1.0, (d.max(), d.mean())


def _engines(smooth=0.0, frame_hw=(48, 64)):
    jm, tm = _models()
    jeng = jinfer.LiveEngine(jm.apply, _params(), frame_hw, IN_HW,
                             smooth=smooth)
    teng = tinfer.LiveEngine(tm, frame_hw, IN_HW, smooth=smooth)
    return jeng, teng


def test_live_engine_submit_retrieve_matches_jax():
    """The one-deep pipeline: submit k+1 before retrieving k, as the viewer
    does; each retrieved frame is its own, and a third submit before a
    retrieve loses the oldest frame's buffers."""
    jeng, teng = _engines()
    frames = _frames(3, (48, 64), seed=5)
    want = [jeng.infer(f, fetch_depth=True) for f in frames]
    tokens = [teng.submit(frames[0]), teng.submit(frames[1])]
    got = [teng.retrieve(tokens[0], fetch_depth=True)]
    tokens.append(teng.submit(frames[2]))
    got += [teng.retrieve(t, fetch_depth=True) for t in tokens[1:]]
    for (gd, gr, dt), (wd, wr, _) in zip(got, want):
        assert dt > 0 and gd.shape == (16, 24) and gr.shape == (48, 64, 3)
        np.testing.assert_allclose(np.log(gd), np.log(np.asarray(wd)),
                                   rtol=0, atol=LOG_TOL)
        _assert_rendered_close(gr, wr)
    stale = teng.submit(frames[0])
    teng.submit(frames[1])
    teng.submit(frames[2])
    with pytest.raises(RuntimeError, match="reused"):
        teng.retrieve(stale)


def test_live_engine_smoothing_matches_jax_and_resets():
    jeng, teng = _engines(smooth=0.6)
    frames = _frames(3, (48, 64), seed=6)
    for f in frames:
        wd, wr, _ = jeng.infer(f, fetch_depth=True)
        gd, gr, _ = teng.infer(f, fetch_depth=True)
        np.testing.assert_allclose(np.log(gd), np.log(np.asarray(wd)),
                                   rtol=0, atol=LOG_TOL)
        _assert_rendered_close(gr, wr)
    teng.reset_smoothing()
    plain = tinfer.LiveEngine(teng.model, (48, 64), IN_HW)
    np.testing.assert_array_equal(teng.infer(frames[0], True)[0],
                                  plain.infer(frames[0], True)[0])
    with pytest.raises(ValueError, match="smooth"):
        tinfer.LiveEngine(teng.model, (48, 64), IN_HW, smooth=1.0)


def test_latency_decomposition_fields():
    _, teng = _engines()
    d = teng.latency_decomposition(n=2)
    assert d["frame_bytes"] == d["rendered_bytes"] == 48 * 64 * 3
    for k in ("h2d_ms_here", "program_ms", "d2h_ms_here", "e2e_ms_here"):
        assert d[k] >= 0
    assert d["program_ms"] > 0
    transport_ms = (d["frame_bytes"] + d["rendered_bytes"]) / (
        d["local_link_gbps_assumed"] * 1e9) * 1e3
    assert d["projected_local_chip_e2e_ms"] == pytest.approx(
        d["program_ms"] + transport_ms, abs=0.01)
    assert teng.device_step_latency(2) > 0


# ---------------------------------------------------------------------------
# The viewer.
# ---------------------------------------------------------------------------

def _live_cfg(tmp_path, **live):
    from ann3depth_tpu_torch.config import get_config

    cfg = get_config("live")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=IN_HW),
        model=dataclasses.replace(cfg.model, width_mult=0.25),
        live=dataclasses.replace(cfg.live, frame_hw=(48, 64),
                                 target_fps=100, **live),
        train=dataclasses.replace(cfg.train,
                                  ckpt_dir=str(tmp_path / "none")))


def test_viewer_headless_records_every_frame(tmp_path):
    from ann3depth_tpu_torch.live import viewer
    from ann3depth_tpu_torch.live.capture import SyntheticSource

    cv2 = pytest.importorskip("cv2")
    record = str(tmp_path / "session.avi")
    stats = viewer.run(_live_cfg(tmp_path, smooth=0.5), display=False,
                       max_frames=6, source=SyntheticSource((48, 64),
                                                            fps=100),
                       record=record, device="cpu")
    assert stats["frames"] == 6 and stats["ring_native"] is True
    assert np.isfinite(stats["latency_p50_ms"]) and stats["fps"] > 0
    assert stats["ring_pushed"] >= 6 and stats["ring_dropped"] >= 0
    cap = cv2.VideoCapture(record)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert stats["record"] == record and n == 6


def test_viewer_without_a_camera_reads_the_synthetic_source(tmp_path,
                                                            caplog):
    from ann3depth_tpu_torch.live import viewer

    stats = viewer.run(_live_cfg(tmp_path), display=False, max_frames=3,
                       video=str(tmp_path / "missing.avi"), device="cpu")
    assert stats["frames"] == 3
    assert "synthetic source" in caplog.text
    assert "random weights" in caplog.text
