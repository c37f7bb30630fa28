"""Device milliseconds per imputation call in the GP posterior's
factorization and solve (``gp.posterior_conditional``): ``hist_panel``,
``chol_block``, ``panel_solve``, ``tri_inv``, and the library's triangular
solve (float64, above T = 2048: its ``trsm`` kernels and the float64
products inside it, the only float64 products of a call), by name."""

KERNELS = (r"\b(hist_panel|chol_block|panel_solve|tri_inv)_kernel\b"
           r"|(?i:trsm)|gemm_f64f64")


def read(ctx):
    if ctx.trace is None or ctx.kind != "impute":
        return None
    idx = ctx.trace.kernel_idx(KERNELS)
    return ctx.trace.seconds(idx) * 1e3 / ctx.trace.units if idx else None
