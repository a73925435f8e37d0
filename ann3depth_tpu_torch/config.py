"""Typed configs and named presets of the PyTorch port.

Counterpart of `ann3depth_tpu/config.py`: the same dataclasses, fields,
defaults and presets, so `get_config(name)` returns the same values in both
packages (tests/test_torch_serving.py compares every preset), and one of
its own, `dpt-large`. Field meanings are documented there; this copy keeps
the port free of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ann3depth_tpu_torch.compat import reference_spec as ref


@dataclasses.dataclass(frozen=True)
class DataConfig:
    datasets: Tuple[str, ...] = ("make3d",)  # make3d | nyu | synthetic
    data_dir: str = "data"
    input_hw: Tuple[int, int] = (ref.INPUT_H, ref.INPUT_W)
    augment: bool = False
    preprocess_impl: str = "xla"   # "xla" | "pallas": the same code here
    prefetch: int = 2
    use_grain: bool = False
    num_workers: int = 0
    cache_device: bool = False
    cache_window_mb: int = 0
    window_epochs: int = 1
    synth_n: int = 64
    synth_test_n: int = 64
    synth_img_hw: Tuple[int, int] = (96, 128)
    synth_depth_hw: Tuple[int, int] = (48, 64)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "encdec"             # registry key (models/registry.py)
    compute_dtype: str = "bfloat16"  # activations; params stay f32
    width_mult: float = 1.0
    remat: bool = False
    quant: str = "none"              # "none" | "int8" | "int8-qat"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    grad_accum: int = 1
    zero1: bool = False
    ema_decay: float = 0.0
    tensor_parallel: int = 1
    steps: int = 1000
    learning_rate: float = ref.DEFAULT_LEARNING_RATE
    warmup_steps: int = 100
    optimizer: str = "adamw"         # "adamw" | "adam" | "sgd"
    schedule: str = "cosine"         # "cosine" | "constant"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    checkpoint_every: int = 500
    log_every: int = 50
    eval_every: int = 500
    steps_per_dispatch: int = 1
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    save_best: bool = False
    ckpt_dir: str = "checkpoints"
    resume: bool = False
    resume_step: Optional[int] = None
    tensorboard: bool = False
    seed: int = 0
    loss: str = "si"                 # "si" | "si+grad" | "l2" | "berhu"
    si_lambda: float = ref.SI_LOSS_LAMBDA
    distill_from: str = ""
    distill_model: str = ""
    distill_width_mult: float = 1.0
    distill_alpha: float = 0.5
    profile_dir: str = ""
    profile_steps: int = 20


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    frame_hw: Tuple[int, int] = (ref.LIVE_FRAME_H, ref.LIVE_FRAME_W)
    target_fps: int = 30
    ring_capacity: int = 8
    camera_index: int = 0
    smooth: float = 0.0
    colormap: str = "turbo"


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    live: LiveConfig = dataclasses.field(default_factory=LiveConfig)


def _cfg(**kw) -> Config:
    out = Config()
    for section, overrides in kw.items():
        out = dataclasses.replace(
            out, **{section: dataclasses.replace(getattr(out, section), **overrides)}
        )
    return out


PRESETS = {
    "make3d-small": _cfg(
        data={"datasets": ("make3d",)},
        model={"name": "small", "compute_dtype": "float32"},
        train={"batch_size": 1, "steps": 100},
    ),
    # The parity configuration: encoder-decoder, 320x240 in / 160x120 out.
    "make3d-encdec": _cfg(
        data={"datasets": ("make3d",)},
        model={"name": "encdec"},
        train={"batch_size": 16},
    ),
    "make3d-multiscale": _cfg(
        data={"datasets": ("make3d",)},
        model={"name": "multiscale"},
        train={"batch_size": 16},
    ),
    "nyu-encdec-aug": _cfg(
        data={"datasets": ("nyu",), "augment": True},
        model={"name": "encdec"},
        train={"batch_size": 16},
    ),
    "live": _cfg(
        model={"name": "encdec"},
    ),
    "dpt-384": _cfg(
        data={
            "datasets": ("nyu",),
            "input_hw": (ref.DPT_RES, ref.DPT_RES),
        },
        model={"name": "dpt"},
        train={"batch_size": 16},
    ),
    "encdec-w2": _cfg(
        data={"datasets": ("make3d",)},
        model={"name": "encdec", "width_mult": 2.0},
        train={"batch_size": 64},
    ),
    "encdec-w2-best": _cfg(
        data={"datasets": ("make3d",), "augment": True},
        model={"name": "encdec", "width_mult": 2.0},
        train={"batch_size": 64, "loss": "si+grad"},
    ),
    "dpt-384-best": _cfg(
        data={
            "datasets": ("nyu",),
            "input_hw": (ref.DPT_RES, ref.DPT_RES),
        },
        model={"name": "dpt"},
        train={"batch_size": 16, "loss": "si+grad"},
    ),
    "encdec-b128": _cfg(
        data={"datasets": ("make3d",)},
        model={"name": "encdec"},
        train={"batch_size": 128},
    ),
    # The port's own (no JAX preset): DPT-Large at its published widths
    # (models/dpt_large.py) on the dpt-384 preset's data and training.
    "dpt-large": _cfg(
        data={
            "datasets": ("nyu",),
            "input_hw": (ref.DPT_RES, ref.DPT_RES),
        },
        model={"name": "dpt-large"},
        train={"batch_size": 16},
    ),
    "smoke": _cfg(
        data={"datasets": ("synthetic",)},
        model={"name": "small", "compute_dtype": "float32"},
        train={"batch_size": 2, "steps": 10, "log_every": 5,
               "checkpoint_every": 5, "eval_every": 0},
    ),
}


def get_config(name: str) -> Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown config preset {name!r}; have {sorted(PRESETS)}")
