"""FLOPs of DPT-Large's parts in a training step (forward and backward),
for the per-layer rooflines of its cell:

- attention: the model FLOPs of softmax(q k^T / sqrt(d)) v, 4 B H T^2 D a
  block forward (the two matrix products), times 3 for the forward and the
  backward, times the blocks;
- convolutions: the `aten.convolution*` entries of FlopCounterMode over the
  plain reference's forward and backward on the meta device (the patch
  conv, reassembly, transposed convs, scratch, fusion and head convs).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import reference_model


def attention_flops(arch: dict, input_hw, batch: int) -> int:
    tokens = 1 + (input_hw[0] // arch["patch"]) * (input_hw[1] // arch["patch"])
    forward = 4 * batch * arch["dim"] * tokens * tokens  # heads x head dim
    return 3 * forward * arch["depth"]


def conv_flops(reference: str, arch: dict, input_hw, batch: int) -> int:
    model = reference_model(reference)
    params = {k: torch.empty(s, device="meta", requires_grad=True)
              for k, s in model.param_shapes(arch, input_hw).items()}
    x = torch.empty((batch, *input_hw, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        y = model.forward(params, x, arch)
        torch.autograd.grad(y.sum(), list(params.values()))
    ops = counter.get_flop_counts()["Global"]
    return int(sum(n for op, n in ops.items()
                   if str(op).startswith("aten.convolution")))
