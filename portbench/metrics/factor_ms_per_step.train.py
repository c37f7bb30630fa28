"""Device milliseconds per training step in the factorization's kernels
(``ops/blocked.py`` and ``ops/logdet.py``: ``gram_panel``, ``chol_block``,
``panel_solve``, ``diag_logdet``; ``gram_chol`` at T <= 64), by name."""

KERNELS = r"\b(gram_panel|chol_block|panel_solve|diag_logdet|gram_chol)_kernel\b"


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    idx = ctx.trace.kernel_idx(KERNELS)
    return ctx.trace.seconds(idx) * 1e3 / ctx.trace.units if idx else None
