"""Flax params -> the port's state_dict.

Counterpart of the params half of `ann3depth_tpu/serving.py` and
`train/step.py:init_params`: it maps a flax params tree (a nested dict of
numpy arrays, as `init_params` returns it) or the flat `/`-joined
`params.npz` of a JAX serving artifact onto the port's module names. It
uses numpy and torch only.

    enc0/conv_down/kernel    HWIO  ->  enc0.conv_down.weight  OIHW
    enc0/GroupNorm_0/scale         ->  enc0.norm.weight
    enc0/GroupNorm_0/bias          ->  enc0.norm.bias
    head/bias                      ->  head.bias
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

PARAMS_FILE = "params.npz"
META_FILE = "meta.json"

_MODULE_NAMES = {"GroupNorm_0": "norm"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def flatten(tree, prefix=""):
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def torch_name(flax_key: str) -> str:
    *mods, leaf = flax_key.split("/")
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"no torch name for flax param {flax_key!r}")
    return ".".join([_MODULE_NAMES.get(m, m) for m in mods]
                    + [_LEAF_NAMES[leaf]])


def to_state_dict(params) -> dict:
    """Flax params (nested or `/`-flat dict of arrays) -> torch state_dict
    of f32 tensors. 4-D kernels go HWIO -> OIHW."""
    out = {}
    for key, value in flatten(params).items():
        a = np.asarray(value, dtype=np.float32)
        if key.endswith("/kernel") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[torch_name(key)] = torch.tensor(a)
    return out


def read_artifact(artifact_dir):
    """(meta, state_dict) of a JAX serving artifact directory: meta.json
    and params.npz (flat `/`-joined keys, bf16 stored as f32). The
    StableHLO program beside them is not read."""
    with open(os.path.join(artifact_dir, META_FILE)) as f:
        meta = json.load(f)
    with np.load(os.path.join(artifact_dir, PARAMS_FILE)) as npz:
        flat = {k: npz[k] for k in npz.files}
    return meta, to_state_dict(flat)
