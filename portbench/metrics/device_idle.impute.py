"""The share of the profiled stretch of imputation calls that no
operation on the card covers."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "impute":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
