"""Device milliseconds per training step inside the port's
``gpvae.step.backward`` span (``loss.backward()``: every backward kernel,
which autograd's own thread launches on the same stream), between the
span's two CUDA events."""

from portbench.spans_lib import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train", "gpvae.step.backward")
