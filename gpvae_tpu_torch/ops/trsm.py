"""Batched triangular solves.

Counterpart of ``gpvae_tpu/ops/trsm.py:33-80``.  Two routes, split as the
JAX package splits them by default (``via_inverse=None``; True or False
takes one route on any device, as there):

* a lower-triangular ``A`` of side <= ``INV_ROUTE_MAX_T`` on a CUDA tensor:
  the explicit inverse ``op(A)^{-1}`` from ``ops.tri_inv`` (the
  hand-written ``tri_inv.cu`` at its base), then one ``torch.matmul``.
  The triangles solved here are jittered gram factors, cond(L) =
  sqrt(cond(K)), so the inverse costs about an ulp of amplification;
* everything else, and every CPU tensor: ``torch.linalg.
  solve_triangular``, as the JAX package leaves it to XLA's
  ``triangular_solve`` (no Pallas kernel there either).

Both routes are differentiable.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch.ops import dispatch
from gpvae_tpu_torch.ops.tri_inv import tri_inv

# above this side the [.., T, T] inverse's memory and extra work outgrow
# the substitution it replaces (the JAX package's threshold)
INV_ROUTE_MAX_T = 2048


def solve_triangular(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    left_side: bool = True,
    lower: bool = True,
    transpose_a: bool = False,
    via_inverse: bool | None = None,
) -> torch.Tensor:
    """Solve ``op(A) X = B`` (``left_side``) or ``X op(A) = B``, ``A``
    triangular, batched over leading dims; ``op(A) = A^T`` when
    ``transpose_a``.  ``via_inverse`` forces (True) or refuses (False)
    the inverse route; None takes it for a lower ``A`` of side <=
    ``INV_ROUTE_MAX_T`` on a CUDA tensor.  Either way an upper ``A`` or a
    larger side takes the substitution."""
    if via_inverse is None:
        via_inverse = dispatch.on_cuda(a)
    if via_inverse and lower and a.shape[-1] <= INV_ROUTE_MAX_T:
        inv = tri_inv(a)
        op = inv.mT if transpose_a else inv
        return op @ b if left_side else b @ op
    return torch.linalg.solve_triangular(
        a.mT if transpose_a else a, b, upper=lower == transpose_a,
        left=left_side)
