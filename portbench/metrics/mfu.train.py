"""mfu.train: the reference's FLOPs of a training step (forward and
backward, counts/flops.py) times the steps completed in the window, over
the window's seconds, over the bf16 dense peak, in percent."""

from portbench.counts.peaks import BF16_DENSE_FLOPS


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    rate = ctx["step_flops"] * ctx["steps"] / ctx["window_s"]
    return 100.0 * rate / BF16_DENSE_FLOPS
