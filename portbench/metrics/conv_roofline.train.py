"""conv_roofline.train: the convolution FLOPs of DPT-Large's training step
(counts/dpt.py: the `aten.convolution*` entries of the reference's forward
and backward) times the traced steps, over the device seconds of cuDNN's
convolution kernels (implicit-GEMM fprop, dgrad and wgrad, the f32 head's
`wgrad_alg0`, and cuDNN's padding, workspace and split-K helpers), over
the bf16 dense peak, in percent. cuDNN's attention kernels (`_sdpa_`,
whose names hold "fprop" and "bprop") are left out. None where the trace
holds no convolution kernel."""

from portbench import spec
from portbench.counts import dpt
from portbench.counts.peaks import BF16_DENSE_FLOPS

CONFIG = "dpt-large"
# Kernel names of the step's convolutions in an H100 trace (torch 2.11):
# sm90_xmma_{fprop,dgrad,wgrad}_*implicit_gemm*, sm80_xmma_*implicit_gemm*,
# cutlass_tensorop_bf16_s16816{fprop,dgrad}_*, cutlass ImplicitGemmConvolution
# (wgrad), wgrad_alg0_engine, nhwcAddPaddingKernel, ReduceSplitK and
# init_device_workspace_kernel of cuDNN's cutlass and xmma.
KERNELS = ("_implicit_gemm", "s16816fprop", "s16816dgrad",
           "ImplicitGemmConvolution", "wgrad_alg0", "nhwcAddPaddingKernel",
           "ReduceSplitK", "init_device_workspace_kernel")
NOT = ("_sdpa_", "flash")


def conv_kernel(name):
    return (any(k in name for k in KERNELS)
            and not any(k in name for k in NOT))


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    seconds = sum(s for n, s in ctx["trace"].by_name.items()
                  if conv_kernel(n))
    if seconds <= 0:
        return None
    config = spec.config(CONFIG)
    step = dpt.conv_flops(config["reference"], config["arch"],
                          config["config"]["data"]["input_hw"], ctx["batch"])
    return 100.0 * step * ctx["traced_steps"] / seconds / BF16_DENSE_FLOPS
