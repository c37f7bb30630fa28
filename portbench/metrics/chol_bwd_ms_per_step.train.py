"""Device milliseconds per training step in the Cholesky backward's kernel
(``ops/chol_bwd.py``, ``csrc/chol_bwd.cu``: its three passes over the
factor bank), by name.  A program without the kernel reads nothing."""

KERNELS = r"\bchol_bwd_kernel\b"


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    idx = ctx.trace.kernel_idx(KERNELS)
    return ctx.trace.seconds(idx) * 1e3 / ctx.trace.units if idx else None
