"""The hand-written kernels' share of their roofline in a training step:
the least time their work takes on the card (``counts/<config>.py``'s
kernel groups at ``peaks.py``'s rates) over their device time.  A group
whose launches in the stretch are not the count its work was counted for
is left out; with none left, nothing is read."""

from portbench.metrics_lib import roofline


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    return roofline(ctx)
