"""The whole training step's share of the card's peak: the operations a
step needs (``counts/<config>.py``'s ``step_terms``), at ``peaks.py``'s
rate for each one's precision, over the wall time a step took in the
window with the profiler off."""

from portbench.metrics_lib import mfu


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    return mfu(ctx)
