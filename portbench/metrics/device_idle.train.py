"""The share of the profiled stretch of training that no operation on the
card covers (the union of the device records' intervals)."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
