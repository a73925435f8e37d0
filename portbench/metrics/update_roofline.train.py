"""update_roofline.train: the byte bound of DPT-Large's update in a
training step (the global-norm clip and AdamW over every parameter: p, m
and v read and written once, the gradient read twice, once for the norm
and once for the update; 32 bytes a parameter, from the configuration's
`arch.params`) times the traced steps, over the device seconds of the
update's two kernels (csrc/adamw_clip.cu, whose names hold `adamw_clip_`),
at the HBM rate, in percent. None where the trace holds neither kernel."""

from portbench import spec
from portbench.counts.peaks import HBM_BYTES_PER_S

CONFIG = "dpt-large"
KERNEL = "adamw_clip_"
BYTES_PER_PARAM = 32  # f32 p, m, v read and written; g read twice


def step_bytes(arch: dict) -> int:
    return BYTES_PER_PARAM * int(arch["params"])


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    seconds = ctx["trace"].device_seconds(KERNEL)
    if seconds <= 0:
        return None
    nbytes = step_bytes(spec.config(CONFIG)["arch"])
    return 100.0 * nbytes * ctx["traced_steps"] / seconds / HBM_BYTES_PER_S
