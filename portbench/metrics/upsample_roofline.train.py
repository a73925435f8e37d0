"""upsample_roofline.train: the byte bound of DPT-Large's align_corners
upsamples in a training step (the four fusion blocks' and the head's x2:
each input and output element read or written once, forward and backward)
times the traced steps, over the device seconds of the two upsample
kernels (csrc/upsample_aligned_nhwc.cu, `upsample_aligned_nhwc_fwd` and
`upsample_aligned_nhwc_bwd`), at the HBM rate, in percent. None where the
trace holds neither kernel."""

from portbench import spec
from portbench.counts.peaks import HBM_BYTES_PER_S

CONFIG = "dpt-large"
KERNELS = ("upsample_aligned_nhwc_fwd", "upsample_aligned_nhwc_bwd")
ITEMSIZE = 2  # bf16: the fusion path runs in the compute dtype
FUSION_STRIDE = 32  # the deepest fusion block's input: the grid at stride 32


def step_bytes(arch: dict, input_hw, batch: int) -> int:
    """Bytes of a step's upsamples: the fusion blocks' inputs double from
    the input at stride 32, at `features` channels, four times, then the
    head's at features // 2 to the input's size."""
    h, w = (s // FUSION_STRIDE for s in input_hw)
    total = 0
    for c in [arch["features"]] * 4 + [arch["features"] // 2]:
        pixels_in = batch * h * w
        total += 2 * (pixels_in + 4 * pixels_in) * c * ITEMSIZE
        h, w = 2 * h, 2 * w
    return total


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    seconds = sum(ctx["trace"].device_seconds(k) for k in KERNELS)
    if seconds <= 0:
        return None
    config = spec.config(CONFIG)
    nbytes = step_bytes(config["arch"], config["config"]["data"]["input_hw"],
                        ctx["batch"])
    return 100.0 * nbytes * ctx["traced_steps"] / seconds / HBM_BYTES_PER_S
