"""TF checkpoint -> port model import.

Counterpart of `ann3depth_tpu/compat/tf_ckpt_import.py`, acting on a port
model (`nn.Module`) instead of a flax params tree: load a TensorFlow
checkpoint (TF1 Saver family or TF2, both read by
`tf.train.load_checkpoint`), map its variables onto the model, and compare
the model's depth maps with reference outputs within a tolerance.

Name maps are keyed by the model's FLAX paths, exactly as in the JAX
package (`enc0/conv_down/kernel`, `enc0/GroupNorm_0/scale`, ...), so one
map serves both packages. The paths and the flax-layout arrays come from
the model's state_dict through `convert.to_flax` (the inverse of
`convert.to_state_dict`); shapes are checked in the flax layout, which is
TF's own (conv kernels HWIO, dense kernels (in, out), 1-D biases), and the
imported arrays go back through `convert.to_state_dict` into
`load_state_dict(strict=True)`. No transpose is applied silently: a shape
mismatch is a hard error that names both shapes.

`tensorflow` is imported only by `_reader`, when a checkpoint is read.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ann3depth_tpu_torch import convert

log = logging.getLogger(__name__)


def _reader(ckpt_path: str):
    """The checkpoint's reader: get_variable_to_shape_map, get_tensor."""
    import tensorflow as tf  # local: the TF import is heavy

    return tf.train.load_checkpoint(ckpt_path)


def _heads(model) -> Optional[int]:
    """The attention heads count of a DPT-family model, else None."""
    return next((m.heads for m in model.modules() if hasattr(m, "heads")),
                None)


def _flax_params(model) -> Dict[str, np.ndarray]:
    """{flax path: f32 array in flax layout} of the model's parameters."""
    return convert.to_flax(model.state_dict(), heads=_heads(model))


def list_variables(ckpt_path: str) -> Dict[str, tuple]:
    """{tf_variable_name: shape} for any TF checkpoint."""
    reader = _reader(ckpt_path)
    return {name: tuple(shape) for name, shape in
            reader.get_variable_to_shape_map().items()}


def default_name_map(model) -> Dict[str, str]:
    """Identity mapping: flax path -> the same string as TF variable name
    (`tf1_scoped_name_map` encodes the expected real-world schema)."""
    return {p: p for p in _flax_params(model)}


def tf1_scoped_name_map(model, *, scope: str = "", style: str = "layers",
                        layer_order=None) -> Dict[str, str]:
    """Hypothesized reference variable schema -> {flax_path: tf_name}.

    TF1-era graphs name variables by creation order under auto-uniquified
    scopes:

      style="layers"  tf.layers.conv2d:   conv2d/kernel, conv2d_1/kernel,
                      ... with conv2d_N/bias; norm layers as
                      group_norm[_N]/gamma|beta.
      style="slim"    tf.contrib.slim:    Conv/weights, Conv_1/weights,
                      ... with Conv_N/biases; norm as GroupNorm[_N]/
                      gamma|beta.

    An optional outer variable scope ("<scope>/...") prefixes every name.
    Each flax module prefix is one layer: one holding {kernel[, bias]} a
    conv layer, one holding {scale, bias} a norm layer (scale->gamma,
    bias->beta). `layer_order` lists flax module prefixes in TF creation
    order; it defaults to the alphabetical order of the FLAX prefixes
    (never of the torch names: `norm` and `GroupNorm_0`, `conv_skip` and
    `Conv_0` sort differently and would number `conv2d_N` otherwise), so
    the map equals the JAX package's for the same model.
    """
    if style == "layers":
        conv_base, kernel, bias, norm_base = "conv2d", "kernel", "bias", \
            "group_norm"
    elif style == "slim":
        conv_base, kernel, bias, norm_base = "Conv", "weights", "biases", \
            "GroupNorm"
    else:
        raise ValueError(f"unknown style {style!r}; have layers | slim")

    modules: Dict[str, Dict[str, str]] = {}
    for path in sorted(_flax_params(model)):
        prefix, _, leaf = path.rpartition("/")
        modules.setdefault(prefix, {})[leaf] = path
    order = list(layer_order) if layer_order is not None else sorted(modules)
    unknown = set(modules) - set(order)
    if layer_order is not None and unknown:
        raise ValueError(f"layer_order misses modules {sorted(unknown)}")

    def _uniq(base: str, i: int) -> str:
        return base if i == 0 else f"{base}_{i}"

    out: Dict[str, str] = {}
    n_conv = n_norm = 0
    for prefix in order:
        leaves = modules[prefix]
        pre = f"{scope}/" if scope else ""
        if "scale" in leaves:  # norm layer: scale/bias -> gamma/beta
            tf_mod = _uniq(norm_base, n_norm)
            n_norm += 1
            out[leaves["scale"]] = f"{pre}{tf_mod}/gamma"
            if "bias" in leaves:
                out[leaves["bias"]] = f"{pre}{tf_mod}/beta"
        else:  # conv/dense layer
            tf_mod = _uniq(conv_base, n_conv)
            n_conv += 1
            if "kernel" in leaves:
                out[leaves["kernel"]] = f"{pre}{tf_mod}/{kernel}"
            if "bias" in leaves:
                out[leaves["bias"]] = f"{pre}{tf_mod}/{bias}"
        handled = {"scale", "kernel", "bias"}
        for leaf, path in leaves.items():
            if leaf not in handled:
                out[path] = f"{pre}{tf_mod}/{leaf}"
    return out


def import_checkpoint(ckpt_path: str, model,
                      name_map: Optional[Dict[str, str]] = None,
                      transform: Optional[Callable[[str, np.ndarray],
                                                   np.ndarray]] = None):
    """Load TF checkpoint values into `model`'s parameters; returns it.

    name_map: flax_path -> tf_variable_name (default: identity).
    transform: optional (flax_path, array) -> array hook (e.g. transposes
      for a checkpoint that used a different conv layout).

    Raises KeyError on missing variables and ValueError on shape mismatch
    (in the flax layout), before any parameter is written.
    """
    reader = _reader(ckpt_path)
    available = set(reader.get_variable_to_shape_map())
    flat = _flax_params(model)
    name_map = name_map or {p: p for p in flat}

    missing = [p for p in flat if name_map.get(p) not in available]
    if missing:
        raise KeyError(
            f"checkpoint {ckpt_path} lacks variables for paths {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}; available: "
            f"{sorted(available)[:5]}...")

    new_flat = {}
    for path, leaf in flat.items():
        arr = np.asarray(reader.get_tensor(name_map[path]))
        if transform is not None:
            arr = transform(path, arr)
        if arr.shape != leaf.shape:
            raise ValueError(
                f"shape mismatch at {path}: checkpoint {arr.shape} vs "
                f"model {leaf.shape}")
        new_flat[path] = arr.astype(leaf.dtype)
    model.load_state_dict(convert.to_state_dict(new_flat), strict=True)
    return model


def verify_outputs(model, inputs: np.ndarray, expected: np.ndarray,
                   rtol: float = 1e-4, atol: float = 1e-4) -> dict:
    """Forward `inputs` (NHWC, on the model's device) and compare with the
    reference `expected` depth maps.

    Returns a report dict; raises AssertionError on a mismatch beyond
    the tolerance (the pixel-parity gate).
    """
    dev = next(model.parameters()).device
    with torch.no_grad():
        got = model(torch.as_tensor(np.asarray(inputs, np.float32),
                                    device=dev)).float().cpu().numpy()
    expected = np.asarray(expected).reshape(got.shape)
    abs_err = np.abs(got - expected)
    rel_err = abs_err / np.maximum(np.abs(expected), 1e-8)
    report = {
        "max_abs_err": float(abs_err.max()),
        "max_rel_err": float(rel_err.max()),
        "mean_abs_err": float(abs_err.mean()),
        "within_tolerance": bool(
            np.allclose(got, expected, rtol=rtol, atol=atol)),
    }
    if not report["within_tolerance"]:
        raise AssertionError(f"parity failure: {report}")
    return report
