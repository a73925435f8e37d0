"""Device selection for the port's entry points.

The JAX package lets XLA pick its backend; the port names its device
explicitly. Entry points run on the card unless the caller asks for the CPU,
and never carry on on the CPU when the card was asked for and is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> "cuda". Raises when CUDA is asked for and no card is present.

    On CUDA this also sets both TF32 flags to False. The model computes in
    bf16 under autocast, so TF32 would speed up nothing that matters; what
    stays f32 (the head conv, the plain preprocess einsums, f32-compute
    configs) must stay true f32 so that the card agrees with the CPU
    reference at the tolerances the tests state.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
