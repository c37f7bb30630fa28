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
  ``triangular_solve`` (no Pallas kernel there either).  A float32
  triangle on a CUDA tensor is solved in float64, one matrix at a time
  (the float64 copies of a [B, Z, 4096, 4096] bank would double
  evaluate's peak memory), and the result rounded back: the library's
  float32 solve on an H100 put ``sparse_t4096``'s T=4096 posterior mean
  6.7e-3 of its largest entry from float64, 15x the CPU library's
  float32 (4.6e-4), whichever factor it was given (the port's,
  cuSOLVER's or the CPU's); in float64, 9.5e-5.

:func:`cho_solve_by_inverse` solves with ``L L^T`` by two products with
one inverse, each refined by its residual.

Both routes are differentiable.  The inverse route's reverse mode is the
triangular solve's, with ``X`` in place of the solves (:class:`_ByInverse`):
autograd through the inverse would multiply by ``X`` twice, which cost
FITC's lengthscale gradient at T=4096 on an H100 ~50x the substitution's
float32 error.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch.ops import dispatch
from gpvae_tpu_torch.ops.tri_inv import tri_inv

# above this side the [.., T, T] inverse's memory and extra work outgrow
# the substitution it replaces (the JAX package's threshold)
INV_ROUTE_MAX_T = 2048


class _ByInverse(torch.autograd.Function):
    """``y = op(X) b`` (``left_side``) or ``b op(X)`` with ``X = A^{-1}``
    from ``tri_inv``, ``op(X) = X^T`` when ``transpose_a``.  Backward, the
    reverse mode of the solve it stands for, each line one product with
    ``X``: ``b_bar = op(X)^T y_bar`` (or ``y_bar op(X)^T``) and ``A_bar =
    -tril`` of ``b_bar y^T``, ``y b_bar^T``, ``y^T b_bar`` or ``b_bar^T y``
    for the four forms, summed over broadcast batch dims.  ``x``, when
    given, is ``tri_inv(a)`` already taken; no gradient flows through it."""

    @staticmethod
    def forward(ctx, a, b, left_side, transpose_a, x=None):
        if x is None:
            x = tri_inv(a)
        op = x.mT if transpose_a else x
        y = op @ b if left_side else b @ op
        ctx.save_for_backward(x, y)
        ctx.form = left_side, transpose_a
        ctx.shapes = a.shape, b.shape
        return y

    @staticmethod
    def backward(ctx, y_bar):
        x, y = ctx.saved_tensors
        left_side, transpose_a = ctx.form
        op = x.mT if transpose_a else x
        b_bar = op.mT @ y_bar if left_side else y_bar @ op.mT
        a_bar = None
        if ctx.needs_input_grad[0]:
            if left_side:
                outer = y @ b_bar.mT if transpose_a else b_bar @ y.mT
            else:
                outer = b_bar.mT @ y if transpose_a else y.mT @ b_bar
            a_bar = -torch.tril(outer).sum_to_size(ctx.shapes[0])
        return a_bar, b_bar.sum_to_size(ctx.shapes[1]), None, None, None


def inverse_route(a: torch.Tensor, via_inverse: bool | None = None) -> bool:
    """Whether :func:`solve_triangular` solves with the lower ``a`` by
    its explicit inverse: ``via_inverse``, or when None a CUDA tensor, and
    a side of at most ``INV_ROUTE_MAX_T``."""
    if via_inverse is None:
        via_inverse = dispatch.on_cuda(a)
    return via_inverse and a.shape[-1] <= INV_ROUTE_MAX_T


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
    if lower and inverse_route(a, via_inverse):
        return _ByInverse.apply(a, b, left_side, transpose_a)
    op, upper = (a.mT if transpose_a else a), lower == transpose_a
    if not (a.is_cuda and torch.promote_types(a.dtype, b.dtype)
            == torch.float32):
        return torch.linalg.solve_triangular(op, b, upper=upper,
                                             left=left_side)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    ops = op.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    bs = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    x = torch.stack([torch.linalg.solve_triangular(
        ai.double(), bi.double(), upper=upper, left=left_side).float()
        for ai, bi in zip(ops, bs)])
    return x.reshape(*batch, *b.shape[-2:])


def solve_by_inverse(a: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """``A^{-1} B`` for lower ``a`` as ``x @ b``, ``x = tri_inv(a)`` taken
    by the caller, with the triangular solve's reverse mode
    (:class:`_ByInverse`): a second solve with a factor already inverted
    takes no second ``tri_inv``."""
    return _ByInverse.apply(a, b, True, False, x)


def cho_solve_by_inverse(l: torch.Tensor, b: torch.Tensor,
                         x_inv: torch.Tensor | None = None) -> torch.Tensor:
    """``(L L^T)^{-1} B`` for lower ``l [..., T, T]`` and ``b [..., T,
    C]`` (batch dims broadcast) from ONE ``tri_inv`` of ``L``: ``U = L^{-1}
    B``, then ``X = L^{-T} U``, each product with the explicit inverse
    refined once by its residual, ``U += L^{-1} (B - L U)``.  Unrefined,
    the inverse's own float32 rounding reaches the result: on an H100 it
    put ``t1024_toeplitz``'s T=1024 posterior mean 1.2e-3 of its largest
    entry from float64, 7x the library's float32 substitution; refined,
    1.8e-4, the float32 factor's own limit (``python3 t4096_solve_probe.py
    --preset t1024_toeplitz``).  For a few columns the refinement costs
    a few matrix-vector products.  ``x_inv``, when given, is ``tri_inv(l)``
    already taken."""
    if x_inv is None:
        x_inv = tri_inv(l)
    u = x_inv @ b
    u = u + x_inv @ (b - l @ u)
    x = x_inv.mT @ u
    return x + x_inv.mT @ (u - l.mT @ x)
