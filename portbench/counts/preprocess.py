"""The preprocess kernel's byte bound: each input byte read once (the raw
frames and the [B, 8] f32 parameter rows) and each output byte written
once (f32), over the card's memory rate. The kernel's arithmetic (a
banded separable resample) stays far under the f32 rate at these shapes,
so the bytes bound it."""

from __future__ import annotations

from portbench.counts.peaks import HBM_BYTES_PER_S


def call_bytes(batch, in_hw, out_hw, channels, in_itemsize):
    frames = batch * in_hw[0] * in_hw[1] * channels * in_itemsize
    params = batch * 8 * 4
    out = batch * out_hw[0] * out_hw[1] * channels * 4
    return frames + params + out


def bound_s(nbytes):
    return nbytes / HBM_BYTES_PER_S


def train_step_bound_s(batch, image_hw, depth_hw, input_hw, target_hw):
    """Bound of one train step's two calls: the frames (uint8, 3 channels)
    and the depth maps (f32, 1 channel)."""
    return bound_s(call_bytes(batch, image_hw, input_hw, 3, 1)
                   + call_bytes(batch, depth_hw, target_hw, 1, 4))
