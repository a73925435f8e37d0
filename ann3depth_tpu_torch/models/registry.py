"""Model registry: name -> torch module.

Counterpart of `ann3depth_tpu/models/registry.py`, holding the models the
port has so far. All share the JAX package's contract:

    model(x: NHWC [B,H,W,3] normalized f32) -> NHWC [B,h,w,1] log-depth f32
"""

from __future__ import annotations

import torch

from ann3depth_tpu_torch.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _encdec(cfg: ModelConfig):
    from ann3depth_tpu_torch.models.encdec import EncDecDepthNet
    return EncDecDepthNet(width_mult=cfg.width_mult,
                          compute_dtype=_DTYPES[cfg.compute_dtype])


_REGISTRY = {"encdec": _encdec}


def available():
    return sorted(_REGISTRY)


def build(cfg: ModelConfig):
    """Instantiate the (uninitialized) torch module for a ModelConfig."""
    try:
        ctor = _REGISTRY[cfg.name]
    except KeyError:
        raise KeyError(f"model {cfg.name!r} is not ported yet; the port has "
                       f"{available()}") from None
    if cfg.quant != "none":
        raise ValueError(f"quant={cfg.quant!r} is not ported yet; the port "
                         "serves quant='none' only")
    return ctor(cfg)


# Models of the JAX package whose port is still to come.
_NOT_PORTED = ("small", "multiscale", "dpt", "dpt-small")


def _model_class(name: str):
    if name == "encdec":
        from ann3depth_tpu_torch.models.encdec import EncDecDepthNet
        return EncDecDepthNet
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet; the "
                                  f"port has {available()}")
    raise KeyError(name)


def output_hw(name: str, input_hw):
    """Static output shape for a registered model at a given input size."""
    return _model_class(name).output_hw(input_hw)


def s2d_input_factor(name: str) -> int:
    """Space-to-depth factor of pre-s2d input the model's stem accepts
    directly (0 = RGB only)."""
    return _model_class(name).S2D_INPUT_FACTOR
