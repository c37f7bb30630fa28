"""Kernels the profiler saw on the card per training step (copies and
fills left out): the launches the driver loop pays for."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    return len(ctx.trace.kernel_idx()) / ctx.trace.units
