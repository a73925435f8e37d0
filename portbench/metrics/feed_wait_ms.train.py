"""feed_wait_ms.train: the mean host time a window step spent in the call
that takes its batch from the program's feed (the host feed's queue of
prepared batches, or the device pool's next block of indices), in ms."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    return 1e3 * ctx["feed_wait_s"] / ctx["steps"]
