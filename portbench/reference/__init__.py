"""Plain PyTorch references of what the benchmark's cells run.

Everything here is written from the published description of each step,
in float32 with TF32 off, with no kernel, cache, graph or batching of its
own, and imports nothing of the program under test. Each model is a
function of a flat parameter dict whose keys are the program's state_dict
keys, so that the benchmark can hand the same seeded weights to both.

`lowp` (the control of `correct`): where a function takes it, "fp8" holds
in float8 what the configuration computes in bf16, the precision step
below it: the operands and outputs of the convolutions and upsamples in
e4m3 and the gradients flowing back through them in e5m2, each under a
per-tensor scale (ops.lowp_round).
"""

import torch

REFERENCES = ("encdec",)


def reference_model(name):
    """The reference module of a configuration's `reference` key."""
    if name == "encdec":
        from portbench.reference import encdec
        return encdec
    raise KeyError(f"no reference model {name!r}; have {REFERENCES}")


def exact_f32():
    """Turn TF32 off for matmuls and convolutions (an f32 product on the
    card may otherwise run in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
