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
