"""Device milliseconds per training step inside the port's
``gpvae.factor`` span (``GPVAE.chol_banks`` in the forward): the stream's
time between the span's two CUDA events, so the factorization's kernels,
the rest of the layer and any idle inside it."""

from portbench.spans_lib import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train", "gpvae.factor")
