"""Plain PyTorch references of what the benchmark's cells run.

Everything here is written from the published description of each step,
in float32 with TF32 off, with no kernel, cache, graph or batching of its
own, and imports nothing of the program under test. Each model is a
function of a flat parameter dict whose keys are the program's state_dict
keys, so that the benchmark can hand the same seeded weights to both.

A reference model is a module of this package that sets `MODEL = True`
and defines `param_shapes(arch, input_hw)`, `forward(params, x, arch,
lowp=None)` and `output_hw(input_hw)`; a configuration names it by its
file name in its `reference` key. The other modules (`ops`, `train`) are
helpers and name no model.

`lowp` (the control of `correct`): where a function takes it, "fp8" holds
in float8 what the configuration computes in bf16, the precision step
below it: the operands and outputs of the convolutions and upsamples in
e4m3 and the gradients flowing back through them in e5m2, each under a
per-tensor scale (ops.lowp_round).
"""

import importlib
import pkgutil

import torch

MODEL_API = ("param_shapes", "forward", "output_hw")


def _module(name):
    """reference/<name>.py, or None where there is no such file."""
    full = f"{__name__}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        return None


def reference_models():
    """The names of the reference models: the modules here that set
    MODEL."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__)
                  if getattr(_module(m.name), "MODEL", False))


def reference_model(name):
    """The reference module of a configuration's `reference` key:
    reference/<name>.py, which sets MODEL and defines MODEL_API."""
    module = _module(name) if name.isidentifier() else None
    if not getattr(module, "MODEL", False):
        raise KeyError(f"no reference model {name!r}; the reference models "
                       f"are {reference_models()}")
    missing = [a for a in MODEL_API if not callable(getattr(module, a, None))]
    if missing:
        raise TypeError(f"reference model {name!r} lacks {missing}")
    return module


def exact_f32():
    """Turn TF32 off for matmuls and convolutions (an f32 product on the
    card may otherwise run in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
