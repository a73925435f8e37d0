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
    context/mlp_in/kernel  [in, out] -> context.mlp_in.weight [out, in]
    block0/LayerNorm_1/scale       ->  block0.norm2.weight
    block0/MLP_0/Dense_0/kernel    ->  block0.mlp.fc1.weight  [out, in]
    block0/MultiHeadDotProductAttention_0/query/kernel (E, H, D)
                                   ->  block0.attn.query.weight [H*D, E]
    block0/MultiHeadDotProductAttention_0/query/bias (H, D)
                                   ->  block0.attn.query.bias [H*D]
    block0/MultiHeadDotProductAttention_0/out/kernel (H, D, E)
                                   ->  block0.attn.out.weight [E, H*D]
    fuse1/Conv_0/kernel            ->  fuse1.conv_skip.weight
    pos_embed                      ->  pos_embed
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

PARAMS_FILE = "params.npz"
META_FILE = "meta.json"

_MODULE_NAMES = {"GroupNorm_0": "norm", "LayerNorm_0": "norm1",
                 "LayerNorm_1": "norm2",
                 "MultiHeadDotProductAttention_0": "attn", "MLP_0": "mlp",
                 "Dense_0": "fc1", "Dense_1": "fc2", "Conv_0": "conv_skip",
                 "Conv_1": "conv1", "Conv_2": "conv2"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "pos_embed": "pos_embed"}


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


def _torch_layout(key: str, a: np.ndarray) -> np.ndarray:
    """A flax leaf in the layout of its torch parameter."""
    if key.endswith("/kernel"):
        if a.ndim == 4:                      # conv HWIO -> OIHW
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 3 and key.endswith("/out/kernel"):
            return a.reshape(-1, a.shape[-1]).T   # (H, D, E) -> [E, H*D]
        if a.ndim == 3:
            return a.reshape(a.shape[0], -1).T    # (E, H, D) -> [H*D, E]
        if a.ndim == 2:                      # Dense [in, out] -> [out, in]
            return a.T
    if key.endswith("/bias") and a.ndim == 2:     # (H, D) -> [H*D]
        return a.reshape(-1)
    return a


def to_state_dict(params) -> dict:
    """Flax params (nested or `/`-flat dict of arrays) -> torch state_dict
    of f32 tensors, in torch's layouts (module docstring)."""
    out = {}
    for key, value in flatten(params).items():
        a = _torch_layout(key, np.asarray(value, dtype=np.float32))
        out[torch_name(key)] = torch.tensor(np.ascontiguousarray(a))
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
