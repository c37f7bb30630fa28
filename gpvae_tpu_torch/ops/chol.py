"""The differentiable Cholesky of a pre-built matrix, and its reverse mode
from the factor on the inverse route.

Counterpart of ``gpvae_tpu/ops/chol.py``:

* ``cholesky`` :616-640 and its method menu ``_cholesky_fwd_impl``
  :453-489 (:data:`METHODS`).  ``"auto"`` is ``ops.blocked.
  cholesky_inplace`` at every T (one ``chol_block`` launch up to T = 128,
  the left-looking blocked factorization with ``hist_panel`` above),
  where the TPU picks among three routes by T with crossovers timed on
  its v5e (:442-465), which are not carried over;
* ``_phi`` :492, ``_phi_w_blocks`` :497, ``_tri_sandwich`` and
  ``_tri_sandwich_blocks`` :526-578, and ``cholesky_bwd_from_l`` :581-602
  on the route the JAX package takes on a TPU: one triangular inverse
  ``X = L^{-1}`` (``ops.tri_inv``), then ``K_bar = X^T w X`` by matmuls,
  in 2x2 blocks that skip the structural zeros when T % 256 == 0.  On a
  CUDA float32 bank whose side is a multiple of 128 the products are
  ``ops.chol_bwd``'s kernel instead (three passes that skip the
  triangles' zero tiles, 3xTF32 on the tensor cores).

Its diagonal-block factorizations (``chol_and_inv`` :75, ``chol_inv_parts``
:128, ``chol_parts`` :162, ``chol_wide`` :181) have no counterpart here:
the blocked factorization's diagonal blocks are at most 128 wide, and one
launch of ``ops.chol_block`` factors such a block whole, in place.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch.ops import chol_block, chol_bwd
from gpvae_tpu_torch.ops.blocked import (
    cholesky_blocked_fused, cholesky_inplace,
)
from gpvae_tpu_torch.ops.tri_inv import tri_inv

# every method name of the JAX package's cholesky (chol.py:453-489)
METHODS = ("auto", "xla", "pallas", "blocked", "blocked_left",
           "blocked_left_streamed", "blocked_inplace", "blocked_inplace_128",
           "blocked_fused", "blocked_fused_64")
# the largest side of method="pallas" (pallas_chol.chol_small_batched)
PALLAS_MAX_T = 64


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


def cholesky_bwd_from_l(l: torch.Tensor, l_bar: torch.Tensor | None,
                        logdet_bar: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Standard Cholesky reverse mode: ``K_bar`` from ``(L, L_bar)``.

    ``K_bar = L^{-T} sym(phi(L^T L_bar)) L^{-1}``, symmetric (the
    convention of ``jnp.linalg.cholesky`` and ``torch.linalg.cholesky``).

    ``logdet_bar [...]`` (one per matrix, optional) is the cotangent of
    ``logdet K = 2 sum log diag L``.  Its ``L_bar = diag(2 g / L_ii)``
    gives ``phi(L^T L_bar) = g I``, so ``g`` is added to the diagonal of
    ``sym(phi(L^T L_bar))`` (``K_bar`` gains ``g K^{-1}``) and no dense
    diagonal ``L_bar`` is formed.  ``l_bar`` is None when only the
    logdet is used.

    With a cotangent, a CUDA float32 bank whose side is a multiple of 128
    takes ``ops.chol_bwd``'s kernel for the products
    (:func:`ops.chol_bwd.engaged`).
    """
    x = tri_inv(l)
    if l_bar is None:
        return logdet_bar[..., None, None] * (x.mT @ x)
    if chol_bwd.engaged(l, l_bar):
        return chol_bwd.chol_bwd_cuda(l, l_bar, x, logdet_bar)
    g = None if logdet_bar is None else logdet_bar[..., None]
    if l.shape[-1] % 256 == 0:
        w11, w21, w22 = _phi_w_blocks(l, l_bar)
        if g is not None:
            w11.diagonal(dim1=-2, dim2=-1).add_(g)
            w22.diagonal(dim1=-2, dim2=-1).add_(g)
        return _tri_sandwich_blocks(x, w11, w21, w22)
    p = _phi(l.mT @ l_bar)
    w = 0.5 * (p + p.mT)
    if g is not None:
        w.diagonal(dim1=-2, dim2=-1).add_(g)
    return _tri_sandwich(x, w)


def _cholesky_fwd(k: torch.Tensor, method: str) -> torch.Tensor:
    if method == "xla":
        # the library (chol_block's plain version), made row-major: its
        # factor is column-major on the card
        return chol_block.chol_block_plain(k)[0].contiguous()
    t = k.shape[-1]
    if method == "pallas" and t > PALLAS_MAX_T:
        raise ValueError(f"T={t} > {PALLAS_MAX_T}; use a blocked method for "
                         f"large T")
    kb = k.reshape(-1, t, t)
    if method in ("blocked", "blocked_fused"):
        lb = cholesky_blocked_fused(kb)
    elif method == "blocked_fused_64":
        lb = cholesky_blocked_fused(kb, block_size=64)
    else:  # left-looking; one chol_block launch up to T = 128
        lb = cholesky_inplace(kb)
    return lb.reshape(k.shape)


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, method):
        l = _cholesky_fwd(k, method)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, l_bar):
        (l,) = ctx.saved_tensors
        return cholesky_bwd_from_l(l, l_bar), None


def cholesky(k: torch.Tensor, *, method: str = "auto") -> torch.Tensor:
    """Differentiable batched lower Cholesky factor of SPD ``k [..., T,
    T]`` (only its lower triangle is read; ``k`` is never written).  A
    matrix that is not positive definite in its dtype gives NaN entries,
    never an exception.  The gradient is symmetric, the convention of
    ``jnp.linalg.cholesky``, and the same for every method.

    ``method`` takes every name of the JAX package (``ValueError`` on any
    other):

    * ``"auto"``, ``"blocked_left"``, ``"blocked_left_streamed"``,
      ``"blocked_inplace"``, ``"blocked_inplace_128"``: the left-looking
      blocked factorization these names compute, at the port's one block
      width of 128 (``ops.blocked.cholesky_inplace``);
    * ``"blocked_fused"`` and ``"blocked"`` (on the TPU the same
      right-looking explicit-inverse algorithm with its update at the XLA
      level): ``ops.blocked.cholesky_blocked_fused`` with blocks of 128,
      ``"blocked_fused_64"`` with blocks of 64;
    * ``"pallas"``: one ``chol_block`` launch, T <= 64;
    * ``"xla"``: the library, ``torch.linalg.cholesky_ex``.
    """
    if method not in METHODS:
        raise ValueError(f"unknown cholesky method {method!r}")
    return _Cholesky.apply(k, method)
