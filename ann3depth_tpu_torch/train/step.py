"""Inference steps of the port.

Counterpart of the inference subset of `ann3depth_tpu/train/step.py`:
`init_params`, `apply_with_tta` and `infer_step`. Training steps come in a
later slice.
"""

from __future__ import annotations

import math

import torch

from ann3depth_tpu_torch.pipeline import preprocess


def init_params(model, seed=0, *, device=None):
    """flax-style initialization from a seeded `torch.Generator`; returns
    the model on `device`. The draws differ from jax.random's, the
    distributions are the same."""
    gen = torch.Generator().manual_seed(int(seed))
    return model.init_weights(gen).to(device or "cpu")


def apply_with_tta(model, images, tta=""):
    """Forward with optional test-time augmentation.

    tta="flip": average, in linear depth, the prediction with the unflipped
    prediction of the mirrored input:
    log(0.5*(e^a + e^b)) = logaddexp(a, b) - log 2."""
    pred_log = model(images)
    if tta == "flip":
        flipped = model(images.flip(2))
        pred_log = torch.logaddexp(pred_log, flipped.flip(2)) - math.log(2.0)
    elif tta:
        raise ValueError(f"unknown tta mode {tta!r} (have: 'flip')")
    return pred_log


@torch.inference_mode()
def infer_step(model, img_u8, *, input_hw, tta=""):
    """Raw uint8 frames [B,H,W,3] -> linear depth maps [B,h,w]."""
    images = preprocess.preprocess_image(img_u8, input_hw)
    return torch.exp(apply_with_tta(model, images, tta)[..., 0])
