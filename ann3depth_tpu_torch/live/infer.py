"""Live inference engine: preprocess + forward + colormap on the device.

Counterpart of `ann3depth_tpu/live/infer.py`. The per-frame device program
(`live_step`) is

  uint8 frame -> the fused preprocess (the CUDA kernel on the card,
                 pipeline/preprocess.preprocess_image)
              -> the registry model's forward
              -> linear depth
              -> colormapped uint8 RGB at display resolution (LUT gather)

so the host does nothing between capture and display but one H2D of the
raw uint8 frame and one D2H of the rendered frame. The JAX engine feeds
the model by default a bf16 space-to-depth layout straight from the
preprocess (`emit_s2d`) when the model takes it; the port feeds f32 NHWC,
which a bf16 model rounds to bf16 at its first op, so the two differ by
where that one rounding falls. `LiveEngine` keeps one frame in flight: the frame goes H2D from a
pinned host buffer, the rendered frame comes back D2H into another with
`non_blocking=True`, and an event recorded after it is what `retrieve`
waits on. On the card the engine's step is one CUDA graph, replayed for
each frame. Everything runs on the current stream, so the copies and the
step run in the order they were issued.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from ann3depth_tpu_torch.ops.resize import resample_2d, upsample_matmul
from ann3depth_tpu_torch.pipeline import preprocess
from ann3depth_tpu_torch.utils import graphs

# Colormaps as 16 anchor points each, interpolated to 256 LUT entries (the
# per-frame render is one gather whatever the map). Anchors sampled from the
# canonical tables (turbo: Google AI; viridis/magma: matplotlib) at 16
# evenly spaced positions.
_CMAP_ANCHORS = {
    "turbo": np.array([
        [48, 18, 59], [65, 69, 171], [70, 117, 237], [57, 162, 252],
        [27, 207, 212], [36, 236, 166], [97, 252, 108], [164, 252, 59],
        [215, 232, 36], [246, 193, 31], [252, 147, 26], [239, 93, 17],
        [213, 51, 7], [173, 22, 2], [121, 7, 1], [122, 4, 3]], np.float32),
    "viridis": np.array([
        [68, 1, 84], [72, 26, 108], [71, 47, 125], [65, 68, 135],
        [57, 86, 140], [49, 104, 142], [42, 120, 142], [35, 136, 142],
        [31, 152, 139], [34, 168, 132], [53, 183, 121], [84, 197, 104],
        [122, 209, 81], [165, 219, 54], [210, 226, 27], [253, 231, 37]],
        np.float32),
    "magma": np.array([
        [0, 0, 4], [11, 9, 36], [28, 16, 68], [53, 15, 106],
        [80, 18, 123], [105, 28, 128], [130, 37, 129], [156, 46, 127],
        [182, 54, 121], [208, 65, 111], [230, 81, 98], [245, 107, 92],
        [251, 136, 97], [254, 166, 113], [254, 196, 136], [252, 253, 191]],
        np.float32),
    "gray": np.stack([np.linspace(0, 255, 16)] * 3, axis=1).astype(
        np.float32),
}
COLORMAPS = tuple(sorted(_CMAP_ANCHORS))


def colormap_lut_np(name: str = "turbo") -> np.ndarray:
    """[256, 3] f32 numpy LUT for a named colormap."""
    try:
        anchors = _CMAP_ANCHORS[name]
    except KeyError:
        raise ValueError(f"unknown colormap {name!r}; have {COLORMAPS}")
    xs = np.linspace(0, 15, 256)
    i0 = np.clip(xs.astype(int), 0, 14)
    t = (xs - i0)[:, None]
    return (anchors[i0] * (1 - t) + anchors[i0 + 1] * t).astype(np.float32)


@functools.lru_cache(maxsize=None)
def colormap_lut(name: str = "turbo", device=None) -> torch.Tensor:
    """[256, 3] f32 LUT for a named colormap, on `device` (the gather
    table of `live_step`; built once for each map and device, and shared:
    do not write to it)."""
    return torch.tensor(colormap_lut_np(name), device=device)


def _pack_rgb(rgb):
    rgb = np.asarray(rgb).astype(np.int64)
    return rgb[..., 0] * 65536 + rgb[..., 1] * 256 + rgb[..., 2]


def lut_index_distance(a, b, colormap="turbo"):
    """Per pixel of two rendered u8 frames [..., 3], the least |i - j| over
    the LUT indices i and j whose colors they show (0 where the colors are
    equal). Rendered frames are compared by index: a last-ulp difference in
    the normalized depth may move `int(norm * 255)` by one. Raises on a
    color the map does not hold."""
    keys = _pack_rgb(colormap_lut_np(colormap).astype(np.uint8))
    uniq, inv = np.unique(keys, return_inverse=True)
    lo = np.full(len(uniq), 256)
    hi = np.full(len(uniq), -1)
    np.minimum.at(lo, inv, np.arange(256))
    np.maximum.at(hi, inv, np.arange(256))

    def index_range(frame):
        k = _pack_rgb(frame)
        pos = np.clip(np.searchsorted(uniq, k), 0, len(uniq) - 1)
        if not (uniq[pos] == k).all():
            raise ValueError(f"a color outside the {colormap} map")
        return lo[pos], hi[pos]

    (alo, ahi), (blo, bhi) = index_range(a), index_range(b)
    return np.maximum(np.maximum(blo - ahi, alo - bhi), 0)


def display_resize(norm, display_hw):
    """[B, h, w] f32 -> [B, Hd, Wd]: an exact integer upscale through the
    fixed-matmul path (`upsample_matmul`), any other size with
    `jax.image.resize`'s bilinear semantics (`resample_2d`, the batch
    carried as channels)."""
    _, h, w = norm.shape
    dh, dw = display_hw
    if dh % h == 0 and dw % w == 0 and dh // h == dw // w and dh > h:
        return upsample_matmul(norm[..., None], dh // h)[..., 0]
    return resample_2d(norm.permute(1, 2, 0), (dh, dw)).permute(2, 0, 1)


@torch.inference_mode()
def live_step(model, frame_u8, *, input_hw, display_hw, prev_log=None,
              has_prev=None, smooth=0.0, colormap="turbo", tta=""):
    """[B, H, W, 3] uint8 tensor -> (depth [B, h, w], rendered
    [B, Hd, Wd, 3] uint8), on the frame's device (the model's).

    smooth > 0: temporal EMA over frames in log-depth,
    logd_t = smooth * logd_{t-1} + (1-smooth) * logd; prev_log carries the
    previous smoothed log-depth, has_prev (f32 scalar tensor, 0 on the
    first frame) gates the blend so frame 0 passes through. The smoothed
    program also returns the new carry: (depth, rendered, logd).

    tta="flip": also run the horizontally mirrored frame and average the
    two predictions in linear depth (logaddexp in log space); the mirror
    is taken on the raw frame (`torch.flip` gives the contiguous copy the
    kernel takes).
    """
    images = preprocess.preprocess_image(frame_u8, tuple(input_hw))
    pred_log = model(images)
    if tta == "flip":
        pred_f = model(preprocess.preprocess_image(
            torch.flip(frame_u8, dims=(2,)), tuple(input_hw)))
        pred_log = (torch.logaddexp(pred_log, pred_f.flip(2))
                    - math.log(2.0))
    elif tta:
        raise ValueError(f"unknown tta mode {tta!r} (have: 'flip')")
    logd = pred_log[..., 0]
    if smooth > 0:
        blended = smooth * prev_log + (1.0 - smooth) * logd
        logd = torch.where(has_prev > 0, blended, logd)
    depth = torch.exp(logd)

    # normalize per frame to [0,1] for display (log scale reads better)
    lo = logd.amin(dim=(1, 2), keepdim=True)
    hi = logd.amax(dim=(1, 2), keepdim=True)
    norm = (logd - lo) / torch.clamp(hi - lo, min=1e-6)
    disp = display_resize(norm, display_hw)
    # the int cast truncates toward zero, as the reference's astype does
    idx = torch.clamp((disp * 255.0).to(torch.int32), 0, 255)
    rendered = colormap_lut(colormap, frame_u8.device)[idx].to(torch.uint8)
    if smooth > 0:
        return depth, rendered, logd
    return depth, rendered


class LiveEngine:
    """Per-frame inference on one device, with one frame in flight.

    model: the depth net on its device (serving.prepare_model). The
    constructor runs one frame through the whole program, in the calling
    thread (cuDNN keeps its handles and plans per thread), and so builds
    the kernel there. On the card it then captures the engine's step
    (`_program`: `live_step` at the engine's frame shape, with the
    engine's smoothing) in a CUDA graph (a `GraphCache` of one key, after
    one warm call on a side stream), and every frame replays it: the
    counterpart of the JAX engine's `jax.jit` of `live_step`. On the CPU
    every frame runs the step eagerly.

    With smoothing the step reads and writes the EMA carry in place
    (`copy_` inside the step, `zero_` in `reset_smoothing`): a graph holds
    the addresses it was captured with."""

    def __init__(self, model, frame_hw, input_hw, display_hw=None,
                 smooth=0.0, colormap="turbo"):
        self.model = model
        self.device = next(model.parameters()).device
        self.frame_hw = tuple(frame_hw)
        self.input_hw = tuple(input_hw)
        self.display_hw = tuple(display_hw or frame_hw)
        if not 0.0 <= smooth < 1.0:
            raise ValueError(f"smooth must be in [0, 1), got {smooth}")
        self.smooth = float(smooth)
        colormap_lut(colormap)  # validate the name before the warmup
        self.colormap = colormap
        # Two slots of pinned host buffers (frame in, rendered frame out),
        # each with the event recorded after its last copy.
        cuda = self.device.type == "cuda"
        self._host_frames, self._host_rendered = (
            [torch.empty((1, *hw, 3), dtype=torch.uint8, pin_memory=cuda)
             for _ in range(2)] for hw in (self.frame_hw, self.display_hw))
        self._events = [torch.cuda.Event() if cuda else None
                        for _ in range(2)]
        self._frame_dev = torch.zeros((1, *self.frame_hw, 3),
                                      dtype=torch.uint8, device=self.device)
        self._owner = [None, None]
        self._seq = 0
        # The warmup frame: it builds the kernel and cuDNN's plans, and
        # gives the shape of the EMA carry; it does not seed the EMA.
        depth, _ = live_step(self.model, self._frame_dev,
                             **self._step_kw(smooth=0.0))
        if self.smooth > 0:
            # normal tensors, which reset_smoothing zeroes in place
            with torch.inference_mode(False):
                self._carry = torch.zeros_like(depth)
                self._has_prev = torch.zeros((), device=self.device)
        self._graph = graphs.GraphCache(self._program, device=self.device)
        self._step(self._frame_dev)  # the capture, on the card
        self.reset_smoothing()  # the step moved the carry
        self._sync()

    def _step_kw(self, smooth):
        return dict(input_hw=self.input_hw, display_hw=self.display_hw,
                    smooth=smooth, colormap=self.colormap)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wait(self, slot):
        if self._events[slot] is not None:
            self._events[slot].synchronize()

    def reset_smoothing(self):
        """Forget the temporal-EMA carry (stream restart / scene cut)."""
        if self.smooth > 0:
            self._carry.zero_()
            self._has_prev.zero_()

    @torch.inference_mode()
    def _program(self, frame_dev):
        """The engine's device step: `live_step` of one frame at the
        engine's smoothing, the new carry written in place. The carry
        stays on the device: the next frame depends on this one's output
        without a host sync."""
        if self.smooth > 0:
            depth, rendered, logd = live_step(
                self.model, frame_dev, prev_log=self._carry,
                has_prev=self._has_prev, **self._step_kw(self.smooth))
            self._carry.copy_(logd)
            self._has_prev.fill_(1.0)
            return depth, rendered
        return live_step(self.model, frame_dev, **self._step_kw(0.0))

    def _step(self, frame_dev):
        """(depth, rendered) of a frame on the device through the engine's
        `GraphCache` of `_program`: on the card the frame is copied into
        the graph's input and the graph replays, on the CPU the step runs
        eagerly. depth is the caller's own copy; rendered is the graph's
        output, which the next step overwrites: copy it out (a copy queued
        before the next step) before stepping again."""
        depth, rendered = self._graph(frame_dev)
        return depth.clone(), rendered

    def infer(self, frame_u8: np.ndarray, fetch_depth: bool = False):
        """One frame -> (depth, rendered np [Hd,Wd,3], latency_s).

        depth is a device tensor [1, h, w] unless fetch_depth (then numpy
        [h, w]; one more D2H)."""
        return self.retrieve(self.submit(frame_u8), fetch_depth)

    # -- pipelined API: one frame in flight, so the host takes frame k+1
    #    while the device runs frame k --

    def submit(self, frame_u8: np.ndarray):
        """Dispatch a frame [H, W, 3] uint8; returns an opaque token."""
        t0 = time.perf_counter()
        slot, self._seq = self._seq % 2, self._seq + 1
        # The slot's copies from two frames ago are done before its host
        # buffers are written again.
        self._wait(slot)
        host = self._host_frames[slot]
        host.numpy()[0] = frame_u8
        self._frame_dev.copy_(host, non_blocking=True)
        depth, rendered = self._step(self._frame_dev)
        self._host_rendered[slot].copy_(rendered, non_blocking=True)
        if self._events[slot] is not None:
            self._events[slot].record()
        self._owner[slot] = self._seq
        return slot, self._seq, depth, t0

    def retrieve(self, token, fetch_depth: bool = False):
        """Complete an in-flight token -> (depth, rendered, latency_s)."""
        slot, seq, depth, t0 = token
        if self._owner[slot] != seq:
            raise RuntimeError("this frame's buffers were reused: retrieve "
                               "each frame before submitting two more")
        self._wait(slot)
        rendered = self._host_rendered[slot][0].numpy().copy()
        if fetch_depth:
            depth = depth[0].cpu().numpy()
        return depth, rendered, time.perf_counter() - t0

    def device_step_latency(self, n: int = 50) -> float:
        """Amortized per-frame time (s) of the device program on a
        device-resident frame, host<->device copies excluded."""
        frame = torch.zeros((1, *self.frame_hw, 3), dtype=torch.uint8,
                            device=self.device)
        self._step(frame)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n):
            self._step(frame)
        self._sync()
        return (time.perf_counter() - t0) / n

    # The JAX engine's host-link assumption for a TPU host (PCIe, pinned
    # DMA); kept so the result has the reference's keys.
    LOCAL_LINK_GBPS = 8.0

    def latency_decomposition(self, n: int = 30) -> dict:
        """Per-frame latency split into H2D / device program / D2H, each
        measured here with a sync after every copy.

        On the card `e2e_ms_here` is the measured number: the card is
        attached to this host, and the copies are the engine's own (from
        and to pinned buffers). `projected_local_chip_e2e_ms` keeps the
        reference's projection (program + bytes over LOCAL_LINK_GBPS, an
        assumption about a TPU host), for parity of keys only."""
        self._wait(0)
        self._owner[0] = None  # a frame in flight in slot 0 is lost
        host = self._host_frames[0]
        host.zero_()
        frame_bytes = host.numel()
        dev = torch.empty_like(host, device=self.device)
        _, rendered = self._step(dev.copy_(host))
        self._sync()
        rendered_bytes = self.display_hw[0] * self.display_hw[1] * 3

        t0 = time.perf_counter()
        for _ in range(n):
            dev.copy_(host, non_blocking=True)
            self._sync()
        h2d = (time.perf_counter() - t0) / n

        program = self.device_step_latency(n)

        out = self._host_rendered[0]
        t0 = time.perf_counter()
        for _ in range(n):
            out.copy_(rendered, non_blocking=True)
            self._sync()
        d2h = (time.perf_counter() - t0) / n

        local_link = self.LOCAL_LINK_GBPS * 1e9
        projected = (program + frame_bytes / local_link
                     + rendered_bytes / local_link)
        return {
            "h2d_ms_here": round(h2d * 1e3, 3),
            "program_ms": round(program * 1e3, 3),
            "d2h_ms_here": round(d2h * 1e3, 3),
            "e2e_ms_here": round((h2d + program + d2h) * 1e3, 3),
            "frame_bytes": int(frame_bytes),
            "rendered_bytes": int(rendered_bytes),
            "local_link_gbps_assumed": self.LOCAL_LINK_GBPS,
            "projected_local_chip_e2e_ms": round(projected * 1e3, 3),
        }
