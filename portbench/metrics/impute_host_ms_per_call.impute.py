"""Host milliseconds per imputation call inside the port's
``gpvae.impute`` span (``analysis.impute``): the call's enqueue, with
whatever waits for the card inside it."""

from portbench.spans_lib import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "impute", "gpvae.impute")
