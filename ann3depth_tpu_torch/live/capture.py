"""Frame sources for the live path: OpenCV camera/video capture running in
a producer thread, plus a synthetic source for machines without a camera.

Counterpart of `ann3depth_tpu/live/capture.py`, the same code on the
port's ring buffer. Host code only: cv2 is imported when an OpenCVSource is
opened.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ann3depth_tpu_torch.live.ring_buffer import FrameRingBuffer

log = logging.getLogger(__name__)


class SyntheticSource:
    """Moving synthetic scene at a fixed resolution/frame rate."""

    def __init__(self, frame_hw: Tuple[int, int], fps: float = 30.0, seed=0):
        self.frame_hw = tuple(frame_hw)
        self.fps = fps
        self._t = 0
        h, w = frame_hw
        yy = np.linspace(0.2, 0.9, h, dtype=np.float32)[:, None, None]
        self._bg = np.clip(yy * np.ones((h, w, 3), np.float32) * 255, 0,
                           255).astype(np.uint8)
        self._rng = np.random.default_rng(seed)

    def read(self) -> Optional[np.ndarray]:
        h, w = self.frame_hw
        frame = self._bg.copy()
        # a moving bright box simulates a foreground object
        x0 = int((0.5 + 0.4 * np.sin(self._t / 15.0)) * (w - w // 4))
        y0 = h // 3
        frame[y0:y0 + h // 4, x0:x0 + w // 4] = (220, 180, 60)
        self._t += 1
        return frame

    def release(self):
        pass


class OpenCVSource:
    """cv2.VideoCapture wrapper (camera index or video file)."""

    def __init__(self, frame_hw, camera: int = 0, video: Optional[str] = None):
        import cv2

        self.frame_hw = tuple(frame_hw)
        self._cap = cv2.VideoCapture(video if video is not None else camera)
        if not self._cap.isOpened():
            raise RuntimeError(
                f"cannot open {'video ' + video if video else f'camera {camera}'}")
        self._cv2 = cv2

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self._cap.read()
        if not ok:
            return None
        h, w = self.frame_hw
        if frame.shape[:2] != (h, w):
            frame = self._cv2.resize(frame, (w, h))
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)

    def release(self):
        self._cap.release()


class CaptureThread:
    """Producer thread: source.read() -> ring buffer at ~target fps."""

    def __init__(self, source, ring: FrameRingBuffer,
                 target_fps: Optional[float] = None):
        self.source = source
        self.ring = ring
        self.target_fps = target_fps
        self._stop = threading.Event()
        self.ended = threading.Event()  # source exhausted (video EOF)
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        interval = 1.0 / self.target_fps if self.target_fps else 0.0
        next_t = time.perf_counter()
        while not self._stop.is_set():
            frame = self.source.read()
            if frame is None:
                break
            self.ring.push(frame)
            if interval:
                next_t += interval
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_t = time.perf_counter()
        self.ended.set()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.source.release()
