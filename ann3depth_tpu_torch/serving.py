"""The serving program, its exported artifact, and JAX serving artifacts.

Counterpart of `ann3depth_tpu/serving.py`. `ServingProgram` is the served
program: raw uint8 frames -> preprocess (the registered op
`torch.ops.ann3depth.fused_preprocess`: the fused CUDA kernel on the card)
-> model -> exp to linear depth. `make_serving_fn` serves it through a
`utils.graphs.GraphCache`: on the card one CUDA graph for each batch size
(the counterpart of the JAX package's `jax.jit(serve_fn)`, one program a
bucket), on the CPU the eager call.

`export_serving` writes it as a `torch.export` artifact directory:

    serving.pt2   the exported program (`torch.export.save`), weights inside
    meta.json     config/model names, quant, shapes, batch (null: any),
                  platforms, param count, torch version, format

`load_serving` serves such a directory through `torch.export.load` on the
device type it was exported on, with no model code (the ops it calls are
registered by importing `ops.fused_preprocess` and, for the encdec and
multiscale models, `ops.group_norm`, which this module's imports of
`pipeline.preprocess` and `models` do), through the same cache.
It also serves the weights of a directory written by the JAX package's
`export_serving` (`meta.json` and `params.npz`; its StableHLO program cannot
run here and is not read) in the port's model code.
`model_from_checkpoint` serves the port's own checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import numpy as np
import torch
from torch import nn

from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import PRESETS, ModelConfig
from ann3depth_tpu_torch.device import resolve_device
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.pipeline import preprocess
from ann3depth_tpu_torch.utils import graphs

log = logging.getLogger(__name__)


ARTIFACT_FILE = "serving.pt2"
FORMAT = "torch.export"


class ServingProgram(nn.Module):
    """img_u8 [B,H,W,3] tensor -> linear depth [B,h,w] f32 tensor, on the
    device of the input (which must be the model's)."""

    def __init__(self, model, input_hw):
        super().__init__()
        self.model = model
        self.input_hw = tuple(input_hw)

    def forward(self, img_u8):
        images = preprocess.preprocess_image(img_u8, self.input_hw)
        return torch.exp(self.model(images)[..., 0])


def serving_program(model, input_hw):
    """`ServingProgram` as an eager fn, in inference mode."""
    return torch.inference_mode()(ServingProgram(model, input_hw))


def make_serving_fn(model, input_hw):
    """fn(img_u8 [B,H,W,3] tensor) -> linear depth [B,h,w] f32 tensor on
    the model's device: `serving_program` through a `GraphCache` there,
    one CUDA graph for each batch size on the card (the input may lie on
    the host: it is copied into the graph's static input), the eager call
    on the CPU. The answer is the graph's static output, valid until the
    next call; `fn.fn` is the eager program."""
    device = next(model.parameters()).device
    return graphs.GraphCache(serving_program(model, input_hw),
                             device=device)


def prepare_model(model, device):
    """Model on `device` in channels_last memory, in eval mode."""
    return model.to(device=device, memory_format=torch.channels_last).eval()


def numpy_predictor(fn):
    """Wrap a serving fn (a `GraphCache` on its device, as
    `make_serving_fn` gives) as numpy u8 [B,H,W,3] -> numpy f32 [B,h,w]:
    the host frames are copied straight into its static input, and the
    answer is copied to the host before the next call can overwrite it.
    `predict.fn` is `fn`."""
    def predict(img_u8):
        x = torch.from_numpy(np.ascontiguousarray(img_u8, dtype=np.uint8))
        return fn(x).to("cpu", copy=True).numpy()

    predict.fn = fn
    return predict


class ServingModel:
    """A loaded artifact: `predict` maps numpy uint8 frames [B,H,W,3] to
    linear depth [B,h,w] through `fn` (a `GraphCache`). `model` is the depth model that
    serves a JAX artifact's weights, or the port's exported program."""

    def __init__(self, model, meta, fn):
        self.model = model
        self.meta = meta
        self.fn = fn
        self.predict = numpy_predictor(fn)


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


def export_serving(cfg, model, out_dir, *, batch=None, raw_hw=(480, 640),
                   config_name=None, device=None):
    """Export the serving program of `model` (its params as they are) on
    `device` (default CUDA) into `out_dir`; returns meta.

    batch: None -> one program for any batch >= 1 (traced at batch 2: torch
    specializes sizes 0 and 1); int -> that batch only. raw_hw: the raw
    frame shape the program takes (resized by its preprocess). The program
    runs on the device type it was exported on only: tensors that the
    forward builds, such as the decoder's upsample matrices, are baked in
    as constants there.
    """
    device = resolve_device(device)
    program = ServingProgram(prepare_model(model, device), cfg.data.input_hw)
    example = torch.zeros((2 if batch is None else int(batch), *raw_hw, 3),
                          dtype=torch.uint8, device=device)
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if batch is None \
        else None
    with torch.no_grad():
        # An eager call first fills the caches of the tensors the forward
        # builds (upsample matrices, preprocess param rows) with real
        # tensors, which the trace bakes in; a cold trace would leave its
        # fake tensors in those caches.
        out = program(example)
        exported = torch.export.export(program, (example,),
                                       dynamic_shapes=dynamic)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, ARTIFACT_FILE))
    meta = {
        "config": config_name,
        "model": cfg.model.name,
        "quant": cfg.model.quant,
        "input_hw": list(cfg.data.input_hw),
        "raw_hw": list(raw_hw),
        "batch": batch,  # null -> any batch
        "platforms": [device.type],
        "out_shape": ["batch" if batch is None else str(batch),
                      *(str(d) for d in out.shape[1:])],
        "param_count": sum(p.numel() for p in model.parameters()),
        "torch_version": torch.__version__,
        "format": FORMAT,
    }
    with open(os.path.join(out_dir, convert.META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_serving(artifact_dir, *, device=None):
    """Artifact directory -> ServingModel on `device` (default CUDA): the
    port's exported program, on the device type it was exported on (other
    devices raise), or a JAX artifact's weights in the port's model."""
    device = resolve_device(device)
    with open(os.path.join(artifact_dir, convert.META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") == FORMAT:
        if device.type not in meta["platforms"]:
            raise ValueError(
                f"{artifact_dir} was exported for {meta['platforms']}; it "
                f"cannot run on {device}: export it again there")
        program = torch.export.load(
            os.path.join(artifact_dir, ARTIFACT_FILE)).module()
        return ServingModel(program, meta, graphs.GraphCache(
            torch.inference_mode()(program), device=device))
    meta, state_dict = convert.read_artifact(artifact_dir)
    model = prepare_model(model_from_artifact(meta, state_dict), device)
    return ServingModel(model, meta,
                        make_serving_fn(model, meta["input_hw"]))
