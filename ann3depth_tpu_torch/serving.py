"""The serving function and JAX serving artifacts, in torch.

Counterpart of `ann3depth_tpu/serving.py`. `make_serving_fn` is the served
program: raw uint8 frames -> preprocess (the fused CUDA kernel on the card)
-> model -> exp to linear depth. `load_serving` serves the weights of an
artifact directory written by the JAX package's `export_serving`: it reads
`meta.json` and `params.npz`; the StableHLO program beside them cannot run
here and is not read. `model_from_checkpoint` serves the port's own
checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import PRESETS, ModelConfig
from ann3depth_tpu_torch.device import resolve_device
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.pipeline import preprocess

log = logging.getLogger(__name__)


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
    """The (CPU) module that serves an artifact's weights: the model its
    meta names, at the width of the stored params (small, encdec and
    multiscale) and the input size of its meta (DPT's token grid), with
    the compute dtype of the artifact's named preset (bf16 when it names
    none), loaded strictly."""
    from ann3depth_tpu_torch.train import step as steplib

    preset = PRESETS.get(meta.get("config") or "")
    cfg = preset.model if preset else ModelConfig()
    cfg = dataclasses.replace(cfg, name=meta["model"],
                              quant=meta.get("quant", "none"))
    width_mult_of = getattr(registry.model_class(cfg.name), "width_mult_of",
                            None)
    if width_mult_of is not None:
        cfg = dataclasses.replace(cfg, width_mult=width_mult_of(state_dict))
    model = steplib.init_params(registry.build(cfg), meta["input_hw"])
    model.load_state_dict(state_dict, strict=True)
    return model


def model_from_checkpoint(cfg, *, ckpt_dir=None, use_ema=False,
                          ckpt_step=None, device=None, init=False,
                          require=True):
    """The registry model of `cfg` on `device` (default CUDA), prepared to
    serve, with the params of the checkpoint in ckpt_dir (default
    cfg.train.ckpt_dir): the latest save or the one at ckpt_step, its EMA
    params with use_ema. init=True keeps the random init from
    cfg.train.seed. Without a checkpoint: raises when `require`, else
    warns and keeps the random init."""
    from ann3depth_tpu_torch.train import step as steplib
    from ann3depth_tpu_torch.train.checkpoint import CheckpointManager

    device = resolve_device(device)
    model = steplib.init_params(registry.build(cfg.model), cfg.data.input_hw,
                                cfg.train.seed)
    if not init:
        ckpt_dir = ckpt_dir or cfg.train.ckpt_dir
        # restore_params reads the step and the params only, so a bare
        # model facade is enough: no optimizer is built here.
        facade = steplib.TrainState(step=0, model=model, optimizer=None,
                                    tx=None)
        _, restored = CheckpointManager(ckpt_dir).restore_params(
            facade, use_ema=use_ema, step=ckpt_step)
        if restored is None:
            if require:
                raise RuntimeError(f"no checkpoint in {ckpt_dir}")
            log.warning("no checkpoint in %s — running with random weights",
                        ckpt_dir)
    return prepare_model(model, device)


def load_serving(artifact_dir, *, device=None):
    """Artifact directory -> ServingModel on `device` (default CUDA)."""
    device = resolve_device(device)
    meta, state_dict = convert.read_artifact(artifact_dir)
    model = model_from_artifact(meta, state_dict)
    return ServingModel(prepare_model(model, device), meta, device)
