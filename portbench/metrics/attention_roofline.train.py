"""attention_roofline.train: DPT-Large's attention model FLOPs a training
step (counts/dpt.py: 4 B H T^2 D a block forward, x3 for the backward, x24
blocks) times the traced steps, over the device seconds of the fused
attention kernels that F.scaled_dot_product_attention runs (cuDNN's, flash
or memory-efficient, forward and backward), over the bf16 dense peak, in
percent. None where the trace holds no such kernel (the math backend runs
plain matrix products)."""

from portbench import spec
from portbench.counts import dpt
from portbench.counts.peaks import BF16_DENSE_FLOPS

CONFIG = "dpt-large"
# cuDNN: *_sdpa_*_fprop_* / *_bprop_*, compute_dot_do_o, convert_dq_to_16bits
# (H100, torch 2.11); flash: flash_fwd / flash_bwd; memory-efficient:
# fmha_cutlassF / fmha_cutlassB.
KERNELS = ("_sdpa_", "compute_dot_do_o", "convert_dq", "flash_fwd",
           "flash_bwd", "fmha_cutlass")


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    seconds = sum(s for n, s in ctx["trace"].by_name.items()
                  if any(k in n for k in KERNELS))
    if seconds <= 0:
        return None
    config = spec.config(CONFIG)
    step = dpt.attention_flops(config["arch"],
                               config["config"]["data"]["input_hw"],
                               ctx["batch"])
    return 100.0 * step * ctx["traced_steps"] / seconds / BF16_DENSE_FLOPS
