"""FLOP counts, device peaks, MFU and peak memory for `info --flops`,
`bench` and the chip run.

Counterpart of the parts of `benchmarks/flops.py` that the JAX CLI's
`info` and `bench` use (`step_flops`, `device_peak_flops`, `attach_mfu`,
`attach_memory`). XLA's cost analysis is replaced by
`torch.utils.flop_counter.FlopCounterMode`, which counts 2 FLOPs a
multiply-add of every convolution, matmul and attention over the
whole kernel window (SAME-padding taps included) and counts no elementwise
op. XLA counts a convolution's taps inside the unpadded input only and one
FLOP an element of each elementwise op (bias add, ReLU, GroupNorm), so
the two counts of one model differ by a few percent (tests/
test_torch_info.py states by how much). An int8 product (`torch._int_mm`,
ops/quant.py) counts 2 operations a multiply-add, as XLA counts an int8
convolution.
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense bf16 peak FLOP/s by card name (torch.cuda.get_device_name): NVIDIA's
# data sheet, SXM part, without sparsity, at the full 700 W power limit.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
# Dense int8 peak OP/s, the denominator of `--quant int8` serving's MFU:
# the same data sheet, part and power limit.
PEAK_INT8_OPS = {"NVIDIA H100 80GB HBM3": 1979e12}


def _extra_formulas():
    """FlopCounterMode's formulas for ops it lacks: the CPU's fused
    attention kernels (it counts the CUDA ones; without them a DPT's QK^T
    and AV products, 6.1 of dpt-384's 47.3 forward GFLOP, count on the card
    only) and `torch._int_mm`, int8 serving's every conv and projection."""
    from torch.utils import flop_counter as fc

    aten = torch.ops.aten

    def forward(query_shape, key_shape, value_shape, *args, **kwargs):
        return fc.sdpa_flop_count(query_shape, key_shape, value_shape)

    def backward(grad_out_shape, query_shape, key_shape, value_shape, *args,
                 **kwargs):
        return fc.sdpa_backward_flop_count(grad_out_shape, query_shape,
                                           key_shape, value_shape)

    def int_mm(a_shape, b_shape, *args, **kwargs):
        return fc.mm_flop(a_shape, b_shape)

    return {aten._scaled_dot_product_flash_attention_for_cpu: forward,
            aten._scaled_dot_product_flash_attention_for_cpu_backward:
                backward,
            aten._int_mm: int_mm}


def step_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call of `fn(*args, **kwargs)` as FlopCounterMode counts
    them (a forward, or a forward and backward if `fn` runs one), the same
    on the CPU as on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False,
                              custom_mapping=_extra_formulas())
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def forward_flops(model, x) -> float:
    """FLOPs of one forward of `model` on `x`, without autograd."""
    with torch.no_grad():
        return step_flops(model, x)


def device_peak_flops(device=None, dtype: str = "bf16") -> Optional[float]:
    """Dense peak of a CUDA device (default: the current one) when its card
    is in the table of `dtype`: PEAK_BF16_FLOPS ("bf16") or PEAK_INT8_OPS
    ("int8"); None for any other device, the CPU included, so callers omit
    the figure rather than invent one."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    table = PEAK_INT8_OPS if dtype == "int8" else PEAK_BF16_FLOPS
    return table.get(torch.cuda.get_device_name(device))


def attach_memory(result: dict, device=None) -> dict:
    """Add the peak memory allocated on a CUDA device since its peak stats
    were last reset, as `peak_hbm_gb` (GiB); nothing on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and torch.cuda.is_available():
        peak = torch.cuda.max_memory_allocated(device)
        if peak:
            result["peak_hbm_gb"] = round(peak / 2**30, 3)
    return result


def attach_mfu(result: dict, flops: Optional[float], steps: int,
               dt_seconds: float, dtype: str = "bf16", device=None) -> dict:
    """Extend a benchmark result with model_tflops_per_step and
    achieved_tflops when `flops` (of one step) is known, and mfu when the
    device's peak for `dtype` is (`device_peak_flops`); mfu_peak_dtype
    names a denominator other than bf16."""
    if not flops or dt_seconds <= 0:
        return result
    achieved = flops * steps / dt_seconds
    result["model_tflops_per_step"] = round(flops / 1e12, 4)
    result["achieved_tflops"] = round(achieved / 1e12, 2)
    peak = device_peak_flops(device, dtype=dtype)
    if peak:
        result["mfu"] = round(achieved / peak, 4)
        if dtype != "bf16":
            result["mfu_peak_dtype"] = dtype
    return result
