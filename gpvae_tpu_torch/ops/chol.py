"""The differentiable Cholesky of a pre-built matrix, and its reverse mode
from the factor on the inverse route.

Counterpart of ``gpvae_tpu/ops/chol.py``:

* ``cholesky`` :616-640 with ``method="auto"``: the forward is
  ``ops.blocked.cholesky_inplace`` at every T (one ``chol_block`` launch
  up to T = 128, the blocked factorization with ``hist_panel`` above),
  where the TPU picks among three routes by T (:453-465);
* ``_phi`` :492, ``_phi_w_blocks`` :497, ``_tri_sandwich`` and
  ``_tri_sandwich_blocks`` :526-578, and ``cholesky_bwd_from_l`` :581-602
  on the route the JAX package takes on a TPU: one triangular inverse
  ``X = L^{-1}`` (``ops.tri_inv``), then ``K_bar = X^T w X`` by matmuls,
  in 2x2 blocks that skip the structural zeros when T % 256 == 0.

Its diagonal-block factorizations (``chol_and_inv`` :75, ``chol_inv_parts``
:128, ``chol_parts`` :162, ``chol_wide`` :181) have no counterpart here:
the blocked factorization's diagonal blocks are at most 128 wide, and one
launch of ``ops.chol_block`` factors such a block whole, in place.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch.ops.blocked import cholesky_inplace
from gpvae_tpu_torch.ops.tri_inv import tri_inv


def _phi(m: torch.Tensor) -> torch.Tensor:
    """Lower-triangular part with halved diagonal (Murray 2016)."""
    return torch.tril(m) - 0.5 * torch.tril(torch.triu(m))


def _phi_w_blocks(l: torch.Tensor, l_bar: torch.Tensor):
    """2x2 blocks ``(w11, w21, w22)`` of ``w = sym(phi(L^T L_bar))``: the
    (1,2) block of the product is never needed, so 4 half-size matmuls
    instead of 8 (``chol.py:497-523``; T % 256 == 0)."""
    h = l.shape[-1] // 2
    l11, l21, l22 = l[..., :h, :h], l[..., h:, :h], l[..., h:, h:]
    b11, b21, b22 = l_bar[..., :h, :h], l_bar[..., h:, :h], l_bar[..., h:, h:]
    p11 = _phi(l11.mT @ b11 + l21.mT @ b21)
    p22 = _phi(l22.mT @ b22)
    return (0.5 * (p11 + p11.mT), 0.5 * (l22.mT @ b21),
            0.5 * (p22 + p22.mT))


def _tri_sandwich(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X^T w X`` for lower-triangular ``x`` and symmetric ``w`` (the
    dense product; T % 256 == 0 takes :func:`_tri_sandwich_blocks`)."""
    return x.mT @ w @ x


def _tri_sandwich_blocks(x, w11, w21, w22) -> torch.Tensor:
    """:func:`_tri_sandwich` with ``w`` as its (11, 21, 22) blocks: 11
    half-size matmuls instead of 16, the structural zeros of ``x`` and the
    upper half of the symmetric result skipped (``chol.py:549-578``)."""
    h = x.shape[-1] // 2
    x11, x21, x22 = x[..., :h, :h], x[..., h:, :h], x[..., h:, h:]
    w12 = w21.mT
    t11 = x11.mT @ w11 + x21.mT @ w21
    t12 = x11.mT @ w12 + x21.mT @ w22
    t21 = x22.mT @ w21
    t22 = x22.mT @ w22
    k11 = t11 @ x11 + t12 @ x21
    k21 = t21 @ x11 + t22 @ x21
    k22 = t22 @ x22
    k11 = 0.5 * (k11 + k11.mT)
    k22 = 0.5 * (k22 + k22.mT)
    return torch.cat([torch.cat([k11, k21.mT], dim=-1),
                      torch.cat([k21, k22], dim=-1)], dim=-2)


def cholesky_bwd_from_l(l: torch.Tensor, l_bar: torch.Tensor) -> torch.Tensor:
    """Standard Cholesky reverse mode: ``K_bar`` from ``(L, L_bar)``.

    ``K_bar = L^{-T} sym(phi(L^T L_bar)) L^{-1}``, symmetric (the
    convention of ``jnp.linalg.cholesky`` and ``torch.linalg.cholesky``).
    """
    x = tri_inv(l)
    if l.shape[-1] % 256 == 0:
        return _tri_sandwich_blocks(x, *_phi_w_blocks(l, l_bar))
    p = _phi(l.mT @ l_bar)
    return _tri_sandwich(x, 0.5 * (p + p.mT))


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k):
        t = k.shape[-1]
        l = cholesky_inplace(k.reshape(-1, t, t)).reshape(k.shape)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, l_bar):
        (l,) = ctx.saved_tensors
        return cholesky_bwd_from_l(l, l_bar)


def cholesky(k: torch.Tensor) -> torch.Tensor:
    """Differentiable batched lower Cholesky factor of SPD ``k [..., T,
    T]`` (only its lower triangle is read; ``k`` is never written).  A
    matrix that is not positive definite in its dtype gives NaN entries,
    never an exception.  The gradient is symmetric, the convention of
    ``jnp.linalg.cholesky``."""
    return _Cholesky.apply(k)
