"""Continuous live depth view.

Counterpart of `ann3depth_tpu/live/viewer.py`: capture thread -> native
SPSC frame ring buffer -> LiveEngine (preprocess kernel + forward +
colormap on the device) -> display / stats.

Headless mode (display=False, CLI --no-display) runs the same pipeline
without cv2.imshow and reports latency percentiles. Without cv2 or a
camera the loop reads a SyntheticSource.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from ann3depth_tpu_torch.config import Config
from ann3depth_tpu_torch.live.capture import (CaptureThread, OpenCVSource,
                                              SyntheticSource)
from ann3depth_tpu_torch.live.infer import LiveEngine
from ann3depth_tpu_torch.live.ring_buffer import FrameRingBuffer

log = logging.getLogger(__name__)


def _percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else float("nan")


def run(cfg: Config, camera: int = 0, video: Optional[str] = None,
        display: bool = True, max_frames: Optional[int] = None,
        source=None, model=None, record: Optional[str] = None,
        ckpt_step: Optional[int] = None, device=None) -> dict:
    """Run the live loop; returns latency/fps stats dict.

    model: a prepared model (serving.prepare_model); default: the
    checkpoint in cfg.train.ckpt_dir on `device`, or random weights (with
    a warning) when there is none.
    record: optional output video path — every displayed (rendered
    depth) frame is also appended there, at the session's achieved rate."""
    frame_hw = cfg.live.frame_hw
    if model is None:
        from ann3depth_tpu_torch.serving import model_from_checkpoint

        model = model_from_checkpoint(cfg, ckpt_step=ckpt_step,
                                      device=device, require=False)
    engine = LiveEngine(model, frame_hw, cfg.data.input_hw,
                        display_hw=frame_hw, smooth=cfg.live.smooth,
                        colormap=cfg.live.colormap)

    if source is None:
        try:
            source = OpenCVSource(frame_hw, camera=camera, video=video)
        except (RuntimeError, ImportError) as e:
            log.warning("camera/video unavailable (%s); synthetic source", e)
            source = SyntheticSource(frame_hw, fps=cfg.live.target_fps)

    ring = FrameRingBuffer(cfg.live.ring_capacity, (*frame_hw, 3))
    cap = CaptureThread(source, ring, target_fps=cfg.live.target_fps).start()

    cv2 = None
    if display:
        try:
            import cv2 as _cv2
            cv2 = _cv2
        except ImportError:
            log.warning("cv2 missing; headless")

    writer = None
    if record is not None:
        import cv2 as _cv2r

        from ann3depth_tpu_torch.live.transcode import _open_writer
        writer = _open_writer(_cv2r, record,
                              cfg.live.target_fps, (frame_hw[1], frame_hw[0]))
        _record_cv2 = _cv2r

    latencies, shown = [], 0
    in_flight = None  # one-deep pipeline: overlap frame k+1 with k's D2H
    last_fid = -1     # pop_latest re-returns the newest frame; dedup by id
    t_start = time.perf_counter()
    try:
        while max_frames is None or shown < max_frames:
            frame, fid, _ = ring.pop_latest()
            if fid == last_fid:
                frame = None  # no NEW frame yet
            if frame is None:
                if cap.ended.is_set() and in_flight is None:
                    break
                if in_flight is None:
                    time.sleep(0.001)
                    continue
            else:
                last_fid = fid
            token = engine.submit(frame) if frame is not None else None
            if in_flight is not None:
                _, rendered, dt = engine.retrieve(in_flight)
                latencies.append(dt)
                shown += 1
                if writer is not None:
                    writer.write(_record_cv2.cvtColor(
                        rendered, _record_cv2.COLOR_RGB2BGR))
                if cv2 is not None:
                    bgr = cv2.cvtColor(rendered, cv2.COLOR_RGB2BGR)
                    cv2.imshow("ann3depth_tpu_torch live", bgr)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break
            in_flight = token
    finally:
        cap.stop()
        rb_stats = ring.stats()
        ring_native = ring.native
        ring.close()
        if writer is not None:
            writer.release()
        if cv2 is not None:
            cv2.destroyAllWindows()

    wall = time.perf_counter() - t_start
    stats = {
        "frames": shown,
        "fps": shown / wall if wall > 0 else 0.0,
        "latency_p50_ms": _percentile(latencies, 50) * 1e3,
        "latency_p99_ms": _percentile(latencies, 99) * 1e3,
        "ring_native": ring_native,
        **{f"ring_{k}": v for k, v in rb_stats.items()},
    }
    if record is not None:
        stats["record"] = record
    log.info("live: %s", stats)
    return stats
