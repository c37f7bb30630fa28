"""GP machinery of the main path: the differentiable factored gram bank,
the GP KL on the inverse route, and correlated latent sampling.

Counterpart of four pieces of ``gpvae_tpu/gp.py``: ``_tri_tri_frob2``
(:60-92), ``chol_gram_bank`` with its custom gradient and its two
forward routes (:108-232), ``gp_kl`` on its inverse route (:270-302) and
``gp_sample`` (:526-557).  The port has a single route for each: on a
CUDA tensor the factors come from the hand-written kernels (T <= 64:
``gram_chol``; larger T: the blocked ``ops.blocked`` factorization) and
the KL's inverse from ``ops.tri_inv``, on a CPU tensor from their plain
versions.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops import gram_chol
from gpvae_tpu_torch.ops.blocked import cholesky_gram_inplace
from gpvae_tpu_torch.ops.chol import cholesky_bwd_from_l
from gpvae_tpu_torch.ops.gram_chol import flat_bank, gram_chol_fused
from gpvae_tpu_torch.ops.logdet import logdet_from_chol
from gpvae_tpu_torch.ops.tri_inv import tri_inv


def _tri_tri_frob2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``||P Q||_F^2`` over the last two axes for lower-triangular P, Q.

    For T % 256 == 0 one level of 2x2 blocking skips the zero blocks: 4
    half-size matmuls instead of the dense product's 8, the norm summed
    per block (``gp.py:60-92``).
    """
    t = p.shape[-1]
    if t % 256 != 0:
        a = p @ q
        return torch.sum(a * a, dim=(-2, -1))
    h = t // 2
    p11, p21, p22 = p[..., :h, :h], p[..., h:, :h], p[..., h:, h:]
    q11, q21, q22 = q[..., :h, :h], q[..., h:, :h], q[..., h:, h:]
    a11 = p11 @ q11
    a21 = p21 @ q11 + p22 @ q21
    a22 = p22 @ q22
    return (torch.sum(a11 * a11, dim=(-2, -1))
            + torch.sum(a21 * a21, dim=(-2, -1))
            + torch.sum(a22 * a22, dim=(-2, -1)))


def _gram_chol_blocked(times, lengthscales, mask, variance, kernel, noise):
    """Large-T route (``gp.py:108-136``): the bank flattened to N = B*Z
    matrices, matrix index ``b * Z + z``, and factored by the blocked
    in-place factorization with the gram built in-kernel."""
    b, t = times.shape
    z = lengthscales.shape[-1]
    tt, mk, ls, var = flat_bank(times, lengthscales, mask, variance,
                                dtype=times.dtype)
    l = cholesky_gram_inplace(tt, ls, mk, var, kernel=kernel, noise=noise)
    return l.reshape(b, z, t, t)


# ---------------------------------------------------------------------------
# Differentiable fused gram-bank Cholesky
# ---------------------------------------------------------------------------

class _CholGramBank(torch.autograd.Function):
    """Forward: the fused gram + Cholesky (``gp.py:139-148``: one kernel
    for T <= 64, the blocked factorization above).  Backward
    (``gp.py:158-183``): ``K_bar`` from :func:`cholesky_bwd_from_l`, then
    the pullback of the gram construction to ``lengthscales`` and
    ``variance``.  The times get no gradient: they are data in every model
    of the package."""

    @staticmethod
    def forward(ctx, times, lengthscales, mask, variance, kernel, noise):
        if times.shape[-1] <= gram_chol.MAX_T:
            l = gram_chol_fused(times, lengthscales, mask=mask,
                                kernel=kernel, noise=noise,
                                variance=variance)
        else:
            l = _gram_chol_blocked(times, lengthscales, mask, variance,
                                   kernel, noise)
        ctx.save_for_backward(times, lengthscales, mask, variance, l)
        ctx.kernel, ctx.noise = kernel, noise
        return l

    @staticmethod
    def backward(ctx, l_bar):
        times, lengthscales, mask, variance, l = ctx.saved_tensors
        k_bar = cholesky_bwd_from_l(l, l_bar)
        with torch.enable_grad():
            ls = lengthscales.detach().requires_grad_(True)
            var = variance.detach().requires_grad_(True)
            k = kernels_lib.gram_bank(times, ls, kernel=ctx.kernel,
                                      noise=ctx.noise, variance=var,
                                      mask=mask)
            ls_bar, var_bar = torch.autograd.grad(k, (ls, var), k_bar)
        return None, ls_bar, None, var_bar, None, None


def chol_gram_bank(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    diff_times: bool = False,
) -> torch.Tensor:
    """Cholesky factors ``L [B, Z, T, T]`` of the per-latent gram bank,
    differentiable with respect to ``lengthscales`` and ``variance``.

    On a CUDA tensor the gram is built inside the kernels that factor it
    and never reaches device memory.  ``diff_times=True`` (a times
    gradient) is not ported yet.
    """
    if diff_times:
        raise NotImplementedError(
            "chol_gram_bank(diff_times=True): ROADMAP slice 3"
        )
    if kernel not in kernels_lib.KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}; available: "
            f"{sorted(kernels_lib.KERNELS)}"
        )
    variance = torch.as_tensor(variance, dtype=times.dtype,
                               device=times.device)
    return _CholGramBank.apply(times, lengthscales, mask, variance, kernel,
                               noise)


# ---------------------------------------------------------------------------
# KL divergence
# ---------------------------------------------------------------------------

def gp_kl(
    mu: torch.Tensor,
    l_q: torch.Tensor,
    l_p: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """KL( N(mu, K_q) || N(0, K_p) ) per (sequence, latent) -> ``[B, Z]``.

        KL = 1/2 [ ||L_p^{-1} L_q||_F^2 + ||L_p^{-1} mu||^2 - T
                   + logdet K_p - logdet K_q ]

    from ONE triangular inverse of ``L_p``, applied by matmuls to both the
    trace and the quadratic term.  With identity-padded factors and zeroed
    masked means each masked step contributes ``1 - 1 = 0``, so the static
    ``T`` is exact.

    * ``mu`` ``[B, T, Z]`` posterior means,
    * ``l_q`` / ``l_p`` ``[B, Z, T, T]`` factors; a leading dim of 1 is a
      factor shared across the batch.
    """
    if mask is not None:
        mu = mu * mask.to(mu.dtype)[..., None]
    b, t = mu.shape[0], mu.shape[-2]
    inv_p = tri_inv(l_p)
    tr = _tri_tri_frob2(inv_p, l_q)                  # ||L_p^{-1} L_q||_F^2
    if inv_p.shape[0] == 1 and b > 1:  # shared fixed-grid factor
        v = torch.einsum("zij,bjz->bzi", inv_p[0], mu)
    else:
        v = torch.einsum("bzij,bjz->bzi", inv_p, mu)
    quad = torch.sum(v * v, dim=-1)
    ld_p = logdet_from_chol(l_p)
    ld_q = logdet_from_chol(l_q)
    return 0.5 * (tr.expand_as(quad) + quad - t
                  + (ld_p - ld_q).expand_as(quad))


# ---------------------------------------------------------------------------
# Reparameterized sampling
# ---------------------------------------------------------------------------

def gp_sample(
    mu: torch.Tensor,
    l_q: torch.Tensor,
    num_samples: int = 1,
    mask: torch.Tensor | None = None,
    *,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Correlated reparameterized samples ``z = mu + L eps`` -> [S, B, T, Z].

    The noise is ``eps [S, B, Z, T]`` when given (tests feed the JAX
    package's own draws), else standard normal from ``generator`` on the
    device of ``mu``.  ``l_q`` with leading dim 1 is shared across the
    batch.
    """
    b = mu.shape[0]
    _, z, t, _ = l_q.shape
    if eps is None:
        eps = torch.randn((num_samples, b, z, t), generator=generator,
                          dtype=mu.dtype, device=mu.device)
    elif eps.shape != (num_samples, b, z, t):
        raise ValueError(
            f"eps must be {(num_samples, b, z, t)}, got {tuple(eps.shape)}"
        )
    if l_q.shape[0] == 1 and b > 1:
        corr = torch.einsum("zij,sbzj->sbiz", l_q[0], eps)
    else:
        corr = torch.einsum("bzij,sbzj->sbiz", l_q, eps)
    out = mu[None] + corr
    if mask is not None:
        out = out * mask.to(out.dtype)[None, :, :, None]
    return out
