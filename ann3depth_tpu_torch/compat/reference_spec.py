"""Reference-derived constants of the PyTorch port.

Counterpart of `ann3depth_tpu/compat/reference_spec.py`. The port keeps its
own copy so that it imports nothing of the JAX package; the values are the
same (tests/test_torch_preprocess.py compares them).
"""

from __future__ import annotations

import dataclasses

# Canonical tensor shapes: 320x240 RGB input, 160x120 depth target.
# Layout convention at every public function: NHWC, H=rows, W=cols.
INPUT_H = 240
INPUT_W = 320
TARGET_H = 120
TARGET_W = 160

# Live path frame size: 640x480 camera frames.
LIVE_FRAME_H = 480
LIVE_FRAME_W = 640

# Make3D laser depth grid (rows x cols) and raw image size.
MAKE3D_DEPTH_H = 305
MAKE3D_DEPTH_W = 55
MAKE3D_IMAGE_H = 2272
MAKE3D_IMAGE_W = 1704

# NYU Depth v2 native frame size.
NYU_H = 480
NYU_W = 640

# DPT input resolution.
DPT_RES = 384

# uint8 RGB is scaled to [0, 1], then standardized per channel.
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)

# Depth validity: (DEPTH_EPS, MAKE3D_DEPTH_CAP] metres is valid.
MAKE3D_DEPTH_CAP = 70.0
DEPTH_EPS = 1e-6

# Depth resampling keeps an output pixel only when at least this fraction
# of its resample footprint was valid; otherwise it is written as 0.
DEPTH_VALID_RESAMPLE_THRESH = 0.5

# Scale-invariant log loss weight (Eigen et al. 2014).
SI_LOSS_LAMBDA = 0.5

# Optimizer defaults.
DEFAULT_LEARNING_RATE = 1e-4
DEFAULT_ADAM_B1 = 0.9
DEFAULT_ADAM_B2 = 0.999

# Bilinear resizes use half-pixel centers everywhere.
RESIZE_ALIGN_CORNERS = False

# Eval metrics sum their statistics over all valid pixels of the split and
# finalize once ("global-pixel"); the eval loss is the mean over images of
# the per-image loss.
EVAL_ACCUMULATION = "global-pixel"

# Literature eval crops (--crop eigen|garg): fractions of the depth map's
# (H, W) as (top, bottom, left, right); metrics count only rows
# [top*H, bottom*H) and columns [left*W, right*W).
EVAL_CROPS = {
    "eigen": (0.3324324, 0.91351351, 0.0359477, 0.96405229),
    "garg": (0.40810811, 0.99189189, 0.03594771, 0.96405229),
}


@dataclasses.dataclass(frozen=True)
class ReferenceSpec:
    """Bundled view of the constants for code that wants one object."""

    input_h: int = INPUT_H
    input_w: int = INPUT_W
    target_h: int = TARGET_H
    target_w: int = TARGET_W
    rgb_mean: tuple = RGB_MEAN
    rgb_std: tuple = RGB_STD
    si_loss_lambda: float = SI_LOSS_LAMBDA
    depth_cap: float = MAKE3D_DEPTH_CAP


SPEC = ReferenceSpec()
