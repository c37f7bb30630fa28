"""Device milliseconds per training step in the library's matrix products
(cuBLAS and CUTLASS kernels, by name): mostly the Cholesky backward's and
the gram pullback's float32 products (``ops/chol.py``), with the small
forward ones."""

KERNELS = r"(?i)gemm|gemv|cutlass|xmma"


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    idx = ctx.trace.kernel_idx(KERNELS)
    return ctx.trace.seconds(idx) * 1e3 / ctx.trace.units if idx else None
