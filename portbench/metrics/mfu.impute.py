"""The whole imputation call's share of the card's peak (``call_terms``),
over the wall time a call took in the window with the profiler off."""

from portbench.metrics_lib import mfu


def read(ctx):
    if ctx.trace is None or ctx.kind != "impute":
        return None
    return mfu(ctx)
