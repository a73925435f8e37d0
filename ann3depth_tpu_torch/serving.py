"""The serving function and JAX serving artifacts, in torch.

Counterpart of `ann3depth_tpu/serving.py`. `make_serving_fn` is the served
program: raw uint8 frames -> preprocess (the fused CUDA kernel on the card)
-> model -> exp to linear depth. `load_serving` serves the weights of an
artifact directory written by the JAX package's `export_serving`: it reads
`meta.json` and `params.npz`; the StableHLO program beside them cannot run
here and is not read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import PRESETS, ModelConfig
from ann3depth_tpu_torch.device import resolve_device
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.models.encdec import EncDecDepthNet
from ann3depth_tpu_torch.pipeline import preprocess


def make_serving_fn(model, input_hw):
    """fn(img_u8 [B,H,W,3] tensor) -> linear depth [B,h,w] f32 tensor, on
    the device of the input (which must be the model's)."""
    input_hw = tuple(input_hw)

    @torch.inference_mode()
    def serve(img_u8):
        images = preprocess.preprocess_image(img_u8, input_hw)
        return torch.exp(model(images)[..., 0])

    return serve


def prepare_model(model, device):
    """Model on `device` in channels_last memory, in eval mode."""
    return model.to(device=device, memory_format=torch.channels_last).eval()


def numpy_predictor(fn, device):
    """Wrap a serving fn as numpy u8 [B,H,W,3] -> numpy f32 [B,h,w]."""
    def predict(img_u8):
        x = torch.from_numpy(np.ascontiguousarray(img_u8, dtype=np.uint8))
        return fn(x.to(device)).cpu().numpy()
    return predict


class ServingModel:
    """A loaded artifact: `predict` maps numpy uint8 frames [B,H,W,3] to
    linear depth [B,h,w]."""

    def __init__(self, model, meta, device):
        self.model = model
        self.meta = meta
        self.predict = numpy_predictor(
            make_serving_fn(model, meta["input_hw"]), device)


def model_from_artifact(meta, state_dict):
    """The (CPU) module that serves an artifact's weights: widths from the
    stored params, compute dtype from the artifact's named preset (bf16
    when it names none)."""
    preset = PRESETS.get(meta.get("config") or "")
    cfg = preset.model if preset else ModelConfig()
    cfg = dataclasses.replace(cfg, name=meta["model"],
                              quant=meta.get("quant", "none"))
    if cfg.name == "encdec":
        cfg = dataclasses.replace(
            cfg, width_mult=EncDecDepthNet.width_mult_of(state_dict))
    model = registry.build(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def load_serving(artifact_dir, *, device=None):
    """Artifact directory -> ServingModel on `device` (default CUDA)."""
    device = resolve_device(device)
    meta, state_dict = convert.read_artifact(artifact_dir)
    model = model_from_artifact(meta, state_dict)
    return ServingModel(prepare_model(model, device), meta, device)
