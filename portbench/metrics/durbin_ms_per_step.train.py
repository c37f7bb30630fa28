"""Device milliseconds per training step in the Durbin kernels
(``ops/durbin.py``, ``csrc/durbin.cu``: the recursion and, for a learned
prior, its reverse), by name."""

KERNELS = r"\bdurbin_\w*kernel\b"


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    idx = ctx.trace.kernel_idx(KERNELS)
    return ctx.trace.seconds(idx) * 1e3 / ctx.trace.units if idx else None
