"""ELBO assembly: reconstruction NLLs and the β schedule.

Counterpart of ``gpvae_tpu/elbo.py``.  The Bernoulli NLL is taken from
logits in the stable ``softplus(l) - x l`` form, with no probability clamp.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _reduce(elem: torch.Tensor, mask, feature_mask) -> torch.Tensor:
    """``[S, B, T, ...]`` elementwise terms -> per-sequence ``[B]``: masked
    sum over features and steps, mean over the S samples."""
    if feature_mask is not None:
        elem = elem * feature_mask.to(elem.dtype)[None]
    reduce_dims = tuple(range(3, elem.dim()))
    per_t = torch.sum(elem, dim=reduce_dims) if reduce_dims else elem
    if mask is not None:
        per_t = per_t * mask.to(per_t.dtype)[None]
    return torch.mean(torch.sum(per_t, dim=-1), dim=0)


def bernoulli_nll(
    logits: torch.Tensor,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    feature_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-sequence Bernoulli NLL -> ``[B]``.

    ``logits [S, B, T, ...]``, ``x [B, T, ...]`` in [0, 1], ``mask
    [B, T]`` observed steps, ``feature_mask [B, T, ...]`` observed
    features.
    """
    elem = torch.logaddexp(torch.zeros_like(logits), logits) - x[None] * logits
    return _reduce(elem, mask, feature_mask)


def gaussian_nll(
    mean: torch.Tensor,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    feature_mask: torch.Tensor | None = None,
    log_var: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """Per-sequence Gaussian NLL -> ``[B]``."""
    log_var = torch.as_tensor(log_var, dtype=mean.dtype, device=mean.device)
    elem = 0.5 * (
        torch.exp(-log_var) * (x[None] - mean) ** 2
        + log_var
        + math.log(2.0 * math.pi)
    )
    return _reduce(elem, mask, feature_mask)


@dataclasses.dataclass(frozen=True)
class BetaSchedule:
    """Constant ``init`` until ``start_step``, then ``+= rate`` per step,
    clamped at ``max_value``.  Evaluated on the host in float32, as the JAX
    package evaluates it on the device, so the training loop never waits
    for the device to know β."""
    init: float = 1e-3
    rate: float = 1e-7
    start_step: int = 20_000
    max_value: float = 1.0

    def __call__(self, step: int) -> float:
        f32 = np.float32
        ramp = f32(max(int(step) - self.start_step, 0))
        beta = np.minimum(f32(self.init) + f32(self.rate) * ramp,
                          f32(self.max_value))
        return float(beta)


CONSTANT_BETA = BetaSchedule(init=1.0, rate=0.0, start_step=0)
