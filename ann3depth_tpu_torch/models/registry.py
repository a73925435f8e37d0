"""Model registry: name -> torch module.

Counterpart of `ann3depth_tpu/models/registry.py`, with the same five
models and the same contract:

    model(x: NHWC [B,H,W,3] normalized f32) -> NHWC [B,h,w,1] log-depth f32

with `h, w = output_hw(name, (H, W))`. Quantized twins exist for encdec
("int8", "int8-qat") and the dpt family ("int8"); the registry refuses the
rest as the JAX registry does.
"""

from __future__ import annotations

import torch

from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models.dpt import DPTDepthNet
from ann3depth_tpu_torch.models.encdec import EncDecDepthNet
from ann3depth_tpu_torch.models.multiscale import MultiScaleDepthNet
from ann3depth_tpu_torch.models.small_depth import SmallDepthNet

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CLASSES = {"small": SmallDepthNet, "encdec": EncDecDepthNet,
            "multiscale": MultiScaleDepthNet, "dpt": DPTDepthNet,
            "dpt-small": DPTDepthNet}
# dpt-small: the CPU-sized member of the DPT family.
DPT_SMALL = dict(dim=128, depth=6, heads=4, fusion_features=64,
                 tap_layers=(1, 2, 4, 5))


def register(name):
    """Class decorator: add a model class to the registry under `name`.
    `build` constructs it with the registry's keywords (compute_dtype, and
    remat for every name but "small"); `output_hw` and
    `s2d_input_factor` read its `output_hw` and `S2D_INPUT_FACTOR`."""
    def deco(cls):
        _CLASSES[name] = cls
        return cls
    return deco


def available():
    return sorted(_CLASSES)


def model_class(name: str):
    """The torch module class of a registry name."""
    try:
        return _CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have {available()}") from None


def build(cfg: ModelConfig):
    """Instantiate the (uninitialized) torch module for a ModelConfig, with
    the JAX registry's arguments (remat for every family but small, quant
    for encdec and the dpt family) and its refusals."""
    cls = model_class(cfg.name)
    dpt = cfg.name.startswith("dpt")
    if cfg.quant != "none" and not (cfg.name == "encdec" or dpt):
        raise ValueError(
            f"quant={cfg.quant!r} is only supported by 'encdec' and the "
            f"dpt family, not {cfg.name!r}")
    if cfg.quant == "int8-qat" and cfg.name != "encdec":
        raise ValueError("quant='int8-qat' is encdec-only (the JAX package "
                         "trains no DPT for int8 serving)")
    kw = dict(compute_dtype=_DTYPES[cfg.compute_dtype])
    if cfg.name != "small":
        kw["remat"] = cfg.remat
    if cfg.name == "encdec" or dpt:
        kw["quant"] = cfg.quant
    if cfg.name in ("small", "encdec", "multiscale"):
        kw["width_mult"] = cfg.width_mult
    if cfg.name == "dpt-small":
        kw.update(DPT_SMALL)
    return cls(**kw)


def output_hw(name: str, input_hw):
    """Static output shape for a registered model at a given input size."""
    return model_class(name).output_hw(input_hw)


def s2d_input_factor(name: str) -> int:
    """Space-to-depth factor of pre-s2d input the model's stem accepts
    directly (0 = RGB only)."""
    return model_class(name).S2D_INPUT_FACTOR
