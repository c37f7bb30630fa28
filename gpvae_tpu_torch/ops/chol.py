"""Cholesky reverse mode from the factor, on the inverse route.

Counterpart of ``gpvae_tpu/ops/chol.py:492-496`` (``_phi``), the dense
branch of ``_tri_sandwich`` (``chol.py:536-543``) and
``cholesky_bwd_from_l`` (``chol.py:581-602``).  The port has one route,
the one the JAX package takes on a TPU: a single triangular inverse
``X = L^{-1}`` (``ops.tri_inv``, the CUDA kernel on a CUDA tensor), then
``K_bar = X^T w X`` by matmuls.  The blocked ``T % 256 == 0`` branches
belong to the large-T path (ROADMAP slice 2).
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch.ops.tri_inv import tri_inv


def _phi(m: torch.Tensor) -> torch.Tensor:
    """Lower-triangular part with halved diagonal (Murray 2016)."""
    return torch.tril(m) - 0.5 * torch.tril(torch.triu(m))


def _tri_sandwich(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X^T w X`` for lower-triangular ``x`` and symmetric ``w``."""
    return x.transpose(-1, -2) @ w @ x


def cholesky_bwd_from_l(l: torch.Tensor, l_bar: torch.Tensor) -> torch.Tensor:
    """Standard Cholesky reverse mode: ``K_bar`` from ``(L, L_bar)``.

    ``K_bar = L^{-T} sym(phi(L^T L_bar)) L^{-1}``, symmetric (the
    convention of ``jnp.linalg.cholesky`` and ``torch.linalg.cholesky``).
    """
    x = tri_inv(l)
    p = _phi(l.transpose(-1, -2) @ l_bar)
    return _tri_sandwich(x, 0.5 * (p + p.transpose(-1, -2)))
