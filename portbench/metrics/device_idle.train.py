"""device_idle.train: the share of the traced window of training steps in
which no operation ran on the device, in percent."""


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
