"""The hand-written kernels' share of their roofline in an imputation
call (see ``kernel_roofline.train.py``)."""

from portbench.metrics_lib import roofline


def read(ctx):
    if ctx.trace is None or ctx.kind != "impute":
        return None
    return roofline(ctx)
