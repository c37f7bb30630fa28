"""Dense encoder/decoder networks.

Counterpart of ``gpvae_tpu/nets.py:35-93``: the reference's ReLU MLPs
15 -> 32 -> 32 -> 16 -> 8 -> Z and back, truncated-normal(0.1) weights
(cut at two standard deviations, as flax's initializer is) and 0.1
biases.  Decoders return Bernoulli logits.  A float32 matmul runs in full
float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
(PyTorch's default), the counterpart of the JAX package's
``precision=HIGHEST``.  The conv nets are ROADMAP slice 3.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# Reference dense hidden schedule (src/Models/syndata/GP_VAE_syn_data.py:15-39)
DENSE_HIDDEN = (32, 32, 16, 8)
W_STD = 0.1
B_INIT = 0.1


def _linear(n_in: int, n_out: int, generator: torch.Generator | None):
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=W_STD, a=-2 * W_STD,
                              b=2 * W_STD, generator=generator)
        layer.bias.fill_(B_INIT)
    return layer


def _mlp(widths: Sequence[int], generator) -> nn.ModuleList:
    return nn.ModuleList(
        _linear(a, b, generator) for a, b in zip(widths[:-1], widths[1:])
    )


class DenseEncoder(nn.Module):
    """15 -> 32 -> 32 -> 16 -> 8 -> Z ReLU MLP with a linear mean head.
    Modules ``dense.0..3`` and ``mean_head`` are flax's ``Dense_0..3`` and
    ``mean_head`` (see :mod:`gpvae_tpu_torch.convert`)."""

    def __init__(self, in_dim: int, latent_dim: int,
                 hidden: Sequence[int] = DENSE_HIDDEN, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = _mlp((in_dim, *hidden), generator)
        self.mean_head = _linear(hidden[-1], latent_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.dense:
            h = torch.relu(layer(h))
        return self.mean_head(h)


class DenseDecoder(nn.Module):
    """Z -> 8 -> 16 -> 32 -> 32 -> obs_dim, returning Bernoulli logits.
    Modules ``dense.0..3`` and ``logits_head``."""

    def __init__(self, latent_dim: int, obs_dim: int,
                 hidden: Sequence[int] = tuple(reversed(DENSE_HIDDEN)), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = _mlp((latent_dim, *hidden), generator)
        self.logits_head = _linear(hidden[-1], obs_dim, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.dense:
            h = torch.relu(layer(h))
        return self.logits_head(h)
