"""Host milliseconds per training step in ``train.fit`` outside its steps
and its log point's host read: the port's ``gpvae.fit`` span less its
``gpvae.step`` and ``gpvae.fit.log`` children (the pool's staging
``gpvae.fit.stage``, the index window ``gpvae.fit.indices`` and the
loop's own Python stay in)."""

from portbench.spans_lib import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train", "gpvae.fit",
                            less=("gpvae.step", "gpvae.fit.log"))
