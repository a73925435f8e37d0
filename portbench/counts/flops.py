"""FLOPs of a step, counted once on the plain reference model at the
cell's shapes with `torch.utils.flop_counter` on the meta device (no
memory, no arithmetic): the matrix products and convolutions of the
forward pass, and of the backward pass for a training step. Elementwise
work, the preprocess and the update are not counted; they run outside the
tensor cores that the bf16 peak describes."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import reference_model


def model_flops(reference: str, arch: dict, input_hw, batch: int,
                backward: bool) -> int:
    model = reference_model(reference)
    shapes = model.param_shapes(arch, input_hw)
    params = {k: torch.empty(s, device="meta", requires_grad=backward)
              for k, s in shapes.items()}
    x = torch.empty((batch, *input_hw, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        y = model.forward(params, x, arch)
        if backward:
            torch.autograd.grad(y.sum(), list(params.values()))
    return int(counter.get_total_flops())
