"""Device milliseconds per imputation call inside the port's
``gpvae.posterior`` span (``gp.posterior_conditional``), between the
span's two CUDA events: the posterior's factorization and solve, the rest
of the layer and any idle inside it."""

from portbench.spans_lib import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "impute", "gpvae.posterior")
