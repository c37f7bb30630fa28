"""Device milliseconds per training step inside the port's ``gpvae.kl``
span (``GPVAE.kl`` in the forward: the dense ``gp_kl``, or the Toeplitz
prior's Durbin KL), between the span's two CUDA events."""

from portbench.spans_lib import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train", "gpvae.kl")
