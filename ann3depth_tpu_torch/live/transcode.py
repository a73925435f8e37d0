"""Offline video -> depth-video transcoding (throughput twin of the live path).

Counterpart of `ann3depth_tpu/live/transcode.py`. The live viewer optimizes
latency: one frame in flight. This module optimizes throughput for files:
frames go to the device in batches through the same per-frame program
(`live.infer.live_step`: preprocess kernel + forward + colormap; the batch
widens the leading dim), double-buffered so the host decodes and encodes
video while the device computes the previous batch.

It has two halves. `render_batches` is the device loop: numpy frame
batches in, rendered frames and depths out, with no cv2. `transcode` is
the cv2 half: it reads a video, feeds the loop (the last batch padded to
the static size) and writes the depth video and, optionally, the raw
depth stack.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

# Container -> codec. MJPG/avi is the safest OpenCV build-independent pair;
# mp4v needs an mp4-capable build and falls back loudly if absent.
_FOURCC = {".avi": "MJPG", ".mp4": "mp4v", ".mov": "mp4v", ".mkv": "MJPG"}


def _open_writer(cv2, path, fps, wh):
    ext = os.path.splitext(path)[1].lower()
    code = _FOURCC.get(ext, "MJPG")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*code), fps, wh)
    if not w.isOpened():
        raise RuntimeError(
            f"cv2.VideoWriter cannot open {path!r} (codec {code}); "
            "use an .avi output path (MJPG) if this build lacks mp4 codecs")
    return w


def render_batches(model, batches, *, input_hw, colormap="turbo", tta="",
                   with_depth=True):
    """The device loop: for each (frames u8 numpy [B,H,W,3], n) of
    `batches`, yield (frames, rendered u8 [n,H,W,3], depth f32 [n,h,w] or
    None), rendered at the frames' own resolution.

    One batch stays in flight: batch k+1 is dispatched before batch k's
    results are read. Results leave the device by non-blocking copies into
    pinned host buffers, each followed by an event that the read waits on,
    so reading batch k does not wait for batch k+1's compute.

    `live_step` runs through a `GraphCache`: on the card one CUDA graph
    for each batch shape (the full batch, and a short tail batch where
    the caller gives one), each batch's frames copied from the host into
    its static input; on the CPU eagerly. The results' copies are queued
    before the next batch's replay, which then cannot overwrite them
    first."""
    from ann3depth_tpu_torch.live.infer import live_step
    from ann3depth_tpu_torch.utils import graphs

    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    host = {}  # (slot, name) -> pinned host buffer
    step = graphs.GraphCache(
        lambda frames, **kw: live_step(model, frames, **kw), device=dev)

    def to_host(slot, name, t):
        key = (slot, name)
        if key not in host or host[key].shape != t.shape:
            host[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        return host[key].copy_(t, non_blocking=True)

    def submit(slot, frames, n):
        x = torch.from_numpy(np.ascontiguousarray(frames))
        depth, rendered = step(x, input_hw=tuple(input_hw),
                               display_hw=frames.shape[1:3], tta=tta,
                               colormap=colormap)
        out = (to_host(slot, "rendered", rendered),
               to_host(slot, "depth", depth) if with_depth else None)
        event = torch.cuda.Event() if cuda else None
        if event is not None:
            event.record()
        return frames, n, out, event

    def drain(entry):
        frames, n, (rendered, depth), event = entry
        if event is not None:
            event.synchronize()
        return (frames, rendered.numpy()[:n].copy(),
                None if depth is None else depth.numpy()[:n].copy())

    in_flight, slot = None, 0
    for frames, n in batches:
        token = submit(slot, frames, n)
        slot ^= 1
        if in_flight is not None:
            yield drain(in_flight)
        in_flight = token
    if in_flight is not None:
        yield drain(in_flight)


def transcode(cfg, video: str, out_path: str, *, batch: int = 8,
              side_by_side: bool = False, depth_npy: Optional[str] = None,
              max_frames: Optional[int] = None, model=None,
              use_ema: bool = False, ckpt_step: Optional[int] = None,
              tta: str = "", device=None) -> dict:
    """Transcode a video file into a depth-rendered video.

    Args:
      cfg: resolved Config (model/checkpoint/input_hw).
      video: input video path (anything cv2.VideoCapture opens).
      out_path: output video path; frames are the colormapped depth at the
        input resolution, or input|depth side by side.
      batch: device batch (static shape; the last batch is padded).
      depth_npy: optional path for the raw linear-depth stack
        [N, h, w] float32 at the model's output resolution.
      max_frames: stop after this many frames.
      model: a prepared model (tests); default: the checkpoint in
        cfg.train.ckpt_dir on `device`, like the live viewer.
      tta: "flip" averages each prediction with the mirrored-frame
        prediction (~2x forward FLOPs).

    Returns a stats dict (frames, fps throughput, output paths).
    """
    import cv2

    from ann3depth_tpu_torch.models import registry

    if model is None:
        from ann3depth_tpu_torch.serving import model_from_checkpoint

        model = model_from_checkpoint(cfg, use_ema=use_ema,
                                      ckpt_step=ckpt_step, device=device,
                                      require=False)

    cap = cv2.VideoCapture(video)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {video!r}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    if not (h and w):
        cap.release()
        raise RuntimeError(f"video {video!r} reports no frame size")

    out_wh = (w * 2 if side_by_side else w, h)
    writer = _open_writer(cv2, out_path, src_fps, out_wh)

    def _read_batch():
        """-> (frames [batch,h,w,3] u8 RGB, n_valid)."""
        frames = np.zeros((batch, h, w, 3), np.uint8)
        n = 0
        while n < batch:
            ok, bgr = cap.read()
            if not ok:
                break
            frames[n] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            n += 1
        return frames, n

    def _batches():
        submitted = 0
        while max_frames is None or submitted < max_frames:
            frames, n = _read_batch()
            if max_frames is not None:
                n = min(n, max(max_frames - submitted, 0))
            if not n:
                return
            submitted += n
            yield frames, n

    depths = [] if depth_npy is not None else None
    frames_done = 0
    t0 = time.perf_counter()
    try:
        for inputs, rendered, depth in render_batches(
                model, _batches(), input_hw=tuple(cfg.data.input_hw),
                colormap=cfg.live.colormap, tta=tta,
                with_depth=depths is not None):
            if depths is not None:
                depths.append(depth)
            for i in range(rendered.shape[0]):
                frame = rendered[i]
                if side_by_side:
                    frame = np.concatenate([inputs[i], frame], axis=1)
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            frames_done += rendered.shape[0]
    finally:
        cap.release()
        writer.release()

    wall = time.perf_counter() - t0
    stats = {
        "video": video,
        "out": out_path,
        "frames": frames_done,
        "frame_hw": [h, w],
        "batch": batch,
        "wall_s": round(wall, 3),
        "frames_per_sec": round(frames_done / wall, 2) if wall > 0 else 0.0,
        "source_fps": round(src_fps, 3),
    }
    if depths is not None:
        # zero-frame placeholder shape = the model's OUTPUT resolution,
        # matching what non-empty transcodes write
        out_hw = registry.output_hw(cfg.model.name, tuple(cfg.data.input_hw))
        stack = (np.concatenate(depths, axis=0) if depths
                 else np.zeros((0, *out_hw), np.float32))
        np.save(depth_npy, stack)
        stats["depth_npy"] = depth_npy
        stats["depth_hw"] = list(stack.shape[1:])
    return stats
