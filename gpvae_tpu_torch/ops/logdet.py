"""Log-determinants from the Cholesky diagonal.

Counterpart of ``gpvae_tpu/ops/logdet.py:21-39``: ``logdet K =
2 sum log diag L``, no determinant is ever formed.  Only the diagonal read
is ported; the ``diag_extract`` kernel that the JAX package uses at
T >= 256 belongs to the large-T path (ROADMAP slice 2), and below that a
strided diagonal view is all the read needs.
"""
from __future__ import annotations

import torch


def logdet_from_chol(l: torch.Tensor) -> torch.Tensor:
    """``logdet(K)`` for ``K = L L^T``; L ``[..., T, T]`` -> ``[...]``.

    Identity-padded (masked) rows have ``L_ii = 1`` and contribute 0.
    """
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag), dim=-1)
