"""FLOP counts and device peaks for `info --flops` and the chip run.

Counterpart of the parts of `benchmarks/flops.py` that the JAX CLI's
`info` uses (`step_flops`, `device_peak_flops`). XLA's cost analysis is
replaced by `torch.utils.flop_counter.FlopCounterMode`, which counts 2
FLOPs a multiply-add of every convolution, matmul and attention over the
whole kernel window (SAME-padding taps included) and counts no elementwise
op. XLA counts a convolution's taps inside the unpadded input only and one
FLOP an element of each elementwise op (bias add, ReLU, GroupNorm), so
the two counts of one model differ by a few percent (tests/
test_torch_info.py states by how much).
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense bf16 peak FLOP/s by card name (torch.cuda.get_device_name): NVIDIA's
# data sheet, SXM part, without sparsity, at the full 700 W power limit.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def _cpu_attention_formulas():
    """FlopCounterMode's attention formulas for the CPU's fused attention
    kernels, which it lacks (it counts the CUDA ones): without them a DPT's
    QK^T and AV products (6.1 of dpt-384's 47.3 forward GFLOP) count on
    the card only."""
    from torch.utils import flop_counter as fc

    aten = torch.ops.aten

    def forward(query_shape, key_shape, value_shape, *args, **kwargs):
        return fc.sdpa_flop_count(query_shape, key_shape, value_shape)

    def backward(grad_out_shape, query_shape, key_shape, value_shape, *args,
                 **kwargs):
        return fc.sdpa_backward_flop_count(grad_out_shape, query_shape,
                                           key_shape, value_shape)

    return {aten._scaled_dot_product_flash_attention_for_cpu: forward,
            aten._scaled_dot_product_flash_attention_for_cpu_backward:
                backward}


def step_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call of `fn(*args, **kwargs)` as FlopCounterMode counts
    them (a forward, or a forward and backward if `fn` runs one), the same
    on the CPU as on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False,
                              custom_mapping=_cpu_attention_formulas())
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def forward_flops(model, x) -> float:
    """FLOPs of one forward of `model` on `x`, without autograd."""
    with torch.no_grad():
        return step_flops(model, x)


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a CUDA device (default: the current one)
    when its card is in PEAK_BF16_FLOPS; None for any other device, the
    CPU included, so callers omit the figure rather than invent one."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))
