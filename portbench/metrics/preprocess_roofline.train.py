"""preprocess_roofline.train: the byte bound of a training step's
preprocess calls (counts/preprocess.py) times the traced steps, over the
device time of the preprocess kernel's launches in the traced window, in
percent. None when the trace holds no such launch."""

KERNELS = ("band_resample", "photometric")


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    seconds = sum(ctx["trace"].device_seconds(k) for k in KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * ctx["preprocess_bound_s"] * ctx["traced_steps"] / seconds
