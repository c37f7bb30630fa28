"""GP machinery: the differentiable factored gram bank, the GP KL on the
inverse route, correlated latent sampling, and GP-posterior conditioning.

Counterpart of these pieces of ``gpvae_tpu/gp.py``: ``_tri_tri_frob2``
(:60-92), ``chol_gram_bank`` with its custom gradient, its two forward
routes, ``diff_times`` and ``impl`` (:98-232), ``gp_kl`` and
``gp_prior_diag_kl`` on their inverse routes (:235-365), the
Toeplitz-prior KLs ``gp_kl_toeplitz_prior`` and
``gp_prior_diag_kl_toeplitz`` (:368-461, on ``toeplitz.py``),
``standard_kl``, ``recog_gp_kl`` and ``_batch_diag`` (:464-520), the
samplers ``gp_sample``, ``diag_sample``, ``recog_sample`` and
``prior_sample`` (:526-619) and the imputation path, ``GPPosterior``,
``posterior_conditional`` and ``posterior_sample`` (:626-721).  On a
CUDA tensor the factors come from the hand-written kernels (T <= 64:
``gram_chol``; larger T: the blocked ``ops.blocked`` factorization; a
pre-built gram: ``ops.chol.cholesky``), the inverses from ``ops.tri_inv``
and the Toeplitz prior's Durbin recursion from ``ops.durbin``, on a CPU
tensor from their plain versions; ``chol_gram_bank(impl="xla")`` is the
library baseline.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch import toeplitz
from gpvae_tpu_torch.ops import gram_chol
from gpvae_tpu_torch.ops.blocked import cholesky_gram_inplace
from gpvae_tpu_torch.ops.chol import cholesky, cholesky_bwd_from_l
from gpvae_tpu_torch.ops.gram_chol import flat_bank, gram_chol_fused
from gpvae_tpu_torch.ops.logdet import diag_logdet, logdet_from_chol
from gpvae_tpu_torch.ops.tri_inv import tri_inv
from gpvae_tpu_torch.ops.trsm import (
    cho_solve_by_inverse, inverse_route, solve_by_inverse, solve_triangular,
)


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
    for T <= 64, the blocked factorization above), and with
    ``with_logdet`` the logdet of every factor as a second output ``[B,
    Z]`` (:func:`ops.logdet.diag_logdet`: one launch over the whole bank
    where the kernel takes it).  Backward (``gp.py:158-183``): ``K_bar``
    from :func:`cholesky_bwd_from_l`, the logdet's cotangent folded in,
    then the pullback of the gram construction to ``lengthscales`` and
    ``variance``, and to the times with ``diff_times`` (else they get no
    gradient: they are data in every model of the package)."""

    @staticmethod
    def forward(ctx, times, lengthscales, mask, variance, kernel, noise,
                with_logdet, diff_times):
        if times.shape[-1] <= gram_chol.MAX_T:
            l = gram_chol_fused(times, lengthscales, mask=mask,
                                kernel=kernel, noise=noise,
                                variance=variance)
        else:
            l = _gram_chol_blocked(times, lengthscales, mask, variance,
                                   kernel, noise)
        ctx.save_for_backward(times, lengthscales, mask, variance, l)
        ctx.kernel, ctx.noise, ctx.diff_times = kernel, noise, diff_times
        # an output nobody uses gets None, not a zero-filled [B, Z, T, T]
        ctx.set_materialize_grads(False)
        if with_logdet:
            return l, diag_logdet(l)
        return l

    @staticmethod
    def backward(ctx, l_bar, ld_bar=None):
        if l_bar is None and ld_bar is None:
            return (None,) * 8
        times, lengthscales, mask, variance, l = ctx.saved_tensors
        k_bar = cholesky_bwd_from_l(l, l_bar, logdet_bar=ld_bar)
        with torch.enable_grad():
            tt = times.detach().requires_grad_(ctx.diff_times)
            ls = lengthscales.detach().requires_grad_(True)
            var = variance.detach().requires_grad_(True)
            k = kernels_lib.gram_bank(tt, ls, kernel=ctx.kernel,
                                      noise=ctx.noise, variance=var,
                                      mask=mask)
            wrt = (tt, ls, var) if ctx.diff_times else (ls, var)
            grads = torch.autograd.grad(k, wrt, k_bar)
        times_bar = grads[0] if ctx.diff_times else None
        ls_bar, var_bar = grads[-2:]
        return times_bar, ls_bar, None, var_bar, None, None, None, None


def _check_kernel(kernel: str) -> None:
    if kernel not in kernels_lib.KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}; available: "
            f"{sorted(kernels_lib.KERNELS)}"
        )


def chol_gram_bank(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    diff_times: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Cholesky factors ``L [B, Z, T, T]`` of the per-latent gram bank,
    differentiable with respect to ``lengthscales`` and ``variance``.

    ``impl`` (``gp.py:189-232``): ``"auto"`` and ``"fused"`` build the
    gram inside the kernels that factor it, so on a CUDA tensor it never
    reaches device memory; ``"xla"`` is the composed baseline,
    ``kernels.gram_bank`` then the library's ``cholesky(method="xla")``,
    differentiable by autograd (the times too).  On the fused routes the
    times get a gradient only with ``diff_times=True`` (``gp.py:167-183``;
    the JAX package returns an explicit zero without it, the port none).
    """
    if impl not in ("auto", "fused", "xla"):
        raise ValueError("impl must be auto, fused, or xla")
    _check_kernel(kernel)
    variance = torch.as_tensor(variance, dtype=times.dtype,
                               device=times.device)
    if impl == "xla":
        k = kernels_lib.gram_bank(times, lengthscales, kernel=kernel,
                                  noise=noise, variance=variance, mask=mask)
        return cholesky(k, method="xla")
    return _CholGramBank.apply(times, lengthscales, mask, variance, kernel,
                               noise, False, diff_times)


def _chol_gram_bank_logdet(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`chol_gram_bank` on its fused route, and ``logdet K [B, Z]``
    of every factor from the same autograd node: the training step's KL
    takes both halves of its stacked bank from one ``diag_logdet`` launch,
    and their gradient joins the Cholesky backward as ``g K^{-1}`` instead
    of a dense diagonal ``L_bar`` per half.  (The JAX package computes the
    same logdets from ``L``; XLA fuses its diagonal gradient away.)"""
    _check_kernel(kernel)
    variance = torch.as_tensor(variance, dtype=times.dtype,
                               device=times.device)
    return _CholGramBank.apply(times, lengthscales, mask, variance, kernel,
                               noise, True, False)


# ---------------------------------------------------------------------------
# KL divergence
# ---------------------------------------------------------------------------

def _apply_inverse(inv: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``inv [B or 1, Z, T, T]`` applied to each latent's means ``mu [B, T,
    Z]`` -> ``[B, Z, T]``; a leading 1 is shared across the batch."""
    if inv.shape[0] == 1 and mu.shape[0] > 1:
        return torch.einsum("zij,bjz->bzi", inv[0], mu)
    return torch.einsum("bzij,bjz->bzi", inv, mu)


def gp_kl(
    mu: torch.Tensor,
    l_q: torch.Tensor,
    l_p: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    logdet_q: torch.Tensor | None = None,
    logdet_p: torch.Tensor | None = None,
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
      factor shared across the batch;
    * ``logdet_q`` / ``logdet_p``: ``logdet K`` of each factor when the
      caller has it (``_chol_gram_bank_logdet``), else taken from the
      factor by ``logdet_from_chol``.
    """
    if mask is not None:
        mu = mu * mask.to(mu.dtype)[..., None]
    t = mu.shape[-2]
    inv_p = tri_inv(l_p)
    tr = _tri_tri_frob2(inv_p, l_q)                  # ||L_p^{-1} L_q||_F^2
    v = _apply_inverse(inv_p, mu)
    quad = torch.sum(v * v, dim=-1)
    ld_p = logdet_p if logdet_p is not None else logdet_from_chol(l_p)
    ld_q = logdet_q if logdet_q is not None else logdet_from_chol(l_q)
    return 0.5 * (tr.expand_as(quad) + quad - t
                  + (ld_p - ld_q).expand_as(quad))


def gp_prior_diag_kl(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    l_p: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    logdet_p: torch.Tensor | None = None,
) -> torch.Tensor:
    """KL( N(mu, diag v) || N(0, K_p) ) per (sequence, latent) -> ``[B,
    Z]`` (``gp.py:305-365``):

        KL = 1/2 [ sum_i v_i d_i + ||L_p^{-1} mu||^2 - T
                   + logdet K_p - sum_i log v_i ]

    with ``d = diag(K_p^{-1})``, the column sums of squares of ONE
    triangular inverse ``W = L_p^{-1}`` that also gives the quadratic
    term.  Masked steps take v = 1 and mu = 0 and contribute 0.  ``l_p``
    with leading dim 1 is shared across the batch; ``logdet_p`` as in
    :func:`gp_kl`."""
    if mask is not None:
        m = mask.to(mu.dtype)[..., None]
        mu = mu * m
        log_var = log_var * m            # masked -> log v = 0 -> v = 1
    t = mu.shape[-2]
    w = tri_inv(l_p)
    y = _apply_inverse(w, mu)
    quad = torch.sum(y * y, dim=-1)
    dinv = torch.sum(w * w, dim=-2)      # diag(K_p^{-1}) [B or 1, Z, T]
    tr = torch.sum(dinv * torch.exp(log_var).mT, dim=-1)
    ld_p = logdet_p if logdet_p is not None else logdet_from_chol(l_p)
    sum_log_v = torch.sum(log_var, dim=-2)
    return 0.5 * (tr + quad - t + ld_p.expand_as(tr) - sum_log_v)


def gp_kl_toeplitz_prior(
    mu: torch.Tensor,
    l_q: torch.Tensor,
    prior_row: torch.Tensor,
    *,
    logdet_q: torch.Tensor | None = None,
) -> torch.Tensor:
    """KL( N(mu, K_q) || N(0, K_p) ) with a Toeplitz prior -> ``[B, Z]``
    (``gp.py:368-429``), on a uniform grid shared by the batch (no mask).

    One Durbin recursion of the prior's first rows ``prior_row [Z, T]``
    gives ``logdet K_p`` and ``K_p^{-1} = (A A^T - B B^T) / e``
    (:func:`toeplitz.durbin_gs_factors`), so

        tr(K_p^{-1} K_q) = (||A^T L_q||_F^2 - ||B^T L_q||_F^2) / e,
        mu^T K_p^{-1} mu = (||A^T mu||^2 - ||B^T mu||^2) / e,

    each pair from ONE forward FFT of its operand (the difference of two
    large terms: both come from the same transform).  ``l_q [B or 1, Z,
    T, T]`` the posterior factors (a leading 1 shared), ``mu [B, T, Z]``;
    ``logdet_q`` as in :func:`gp_kl`."""
    t = mu.shape[-2]
    ld_p, a_col, b_col, e = toeplitz.durbin_gs_factors(prior_row)
    m = toeplitz._fft_len(t)
    fa = torch.conj(torch.fft.rfft(a_col, n=m, dim=-1))     # [Z, M/2+1]
    fb = torch.conj(torch.fft.rfft(b_col, n=m, dim=-1))

    def both_sq(y):
        """(||A^T y||^2, ||B^T y||^2) over the last two axes of ``y [...,
        Z, T, C]``, sharing one forward FFT."""
        fy = torch.fft.rfft(y, n=m, dim=-2)
        ya = torch.fft.irfft(fa[..., :, None] * fy, n=m, dim=-2)[..., :t, :]
        yb = torch.fft.irfft(fb[..., :, None] * fy, n=m, dim=-2)[..., :t, :]
        return (torch.sum(ya * ya, dim=(-2, -1)),
                torch.sum(yb * yb, dim=(-2, -1)))

    tr_a, tr_b = both_sq(l_q)                               # [B or 1, Z]
    qa, qb = both_sq(mu.mT[..., None])                      # [B, Z]
    tr = (tr_a - tr_b) / e
    quad = (qa - qb) / e
    ld_q = logdet_q if logdet_q is not None else logdet_from_chol(l_q)
    return 0.5 * (tr.expand_as(quad) + quad - t
                  + (ld_p[None] - ld_q).expand_as(quad))


def gp_prior_diag_kl_toeplitz(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    prior_row: torch.Tensor,
) -> torch.Tensor:
    """KL( N(mu, diag v) || N(0, K_p) ) with a Toeplitz prior -> ``[B,
    Z]`` (``gp.py:432-461``), all O(T^2): ``diag(K_p^{-1})_i =
    (cumsum(a^2)_i - cumsum(b^2)_i) / e`` since A and B are
    lower-triangular Toeplitz, and the quadratic term two FFT matvecs."""
    t = mu.shape[-2]
    ld_p, a_col, b_col, e = toeplitz.durbin_gs_factors(prior_row)
    dinv = (torch.cumsum(a_col * a_col, dim=-1)
            - torch.cumsum(b_col * b_col, dim=-1)) / e[..., None]  # [Z, T]
    tr = torch.sum(dinv[None] * torch.exp(log_var).mT, dim=-1)    # [B, Z]
    mu_c = mu.mT[..., None]                                 # [B, Z, T, 1]
    ya = toeplitz.tri_toeplitz_matvec_t(a_col, mu_c)
    yb = toeplitz.tri_toeplitz_matvec_t(b_col, mu_c)
    quad = (torch.sum(ya * ya, dim=(-2, -1))
            - torch.sum(yb * yb, dim=(-2, -1))) / e
    sum_log_v = torch.sum(log_var, dim=-2)
    return 0.5 * (tr + quad - t + ld_p[None] - sum_log_v)


def standard_kl(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """KL( N(mu, diag v) || N(0, I) ) summed over latents and observed
    steps -> ``[B]`` (``gp.py:464-479``)."""
    kl_t = torch.sum(-0.5 * (1.0 + log_var - mu * mu - torch.exp(log_var)),
                     dim=-1)
    if mask is not None:
        kl_t = kl_t * mask.to(kl_t.dtype)
    return torch.sum(kl_t, dim=-1)


def recog_gp_kl(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    l_q: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The exact KL of the recognition model's sampling distribution,
    ``z = mu + C eps`` with ``C = L_q + diag(sqrt v)``, against N(0, I)
    -> ``[B, Z]`` (``gp.py:482-514``):

        KL = 1/2 [ ||C||_F^2 + ||mu||^2 - T - 2 sum_i log C_ii ]

    Masked rows of ``C`` are the identity rows of ``L_q``."""
    t = mu.shape[-2]
    sqrt_v = torch.exp(0.5 * log_var)
    if mask is not None:
        m = mask.to(mu.dtype)[..., None]
        mu = mu * m
        sqrt_v = sqrt_v * m
    c = l_q + _batch_diag(sqrt_v.mT)
    fro = torch.sum(c * c, dim=(-2, -1))
    quad = torch.sum(mu * mu, dim=-2)
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(c, dim1=-2, dim2=-1)),
                         dim=-1)
    return 0.5 * (fro + quad - t - ld)


def _batch_diag(v: torch.Tensor) -> torch.Tensor:
    """``[..., T] -> [..., T, T]`` diagonal embedding (``gp.py:517``)."""
    return torch.diag_embed(v)


# ---------------------------------------------------------------------------
# Reparameterized sampling
# ---------------------------------------------------------------------------

def _noise(shape: tuple, like: torch.Tensor, eps: torch.Tensor | None,
           generator: torch.Generator | None) -> torch.Tensor:
    """``eps`` when given (tests feed the JAX package's own draws; its
    shape is checked), else standard normal of ``shape`` from
    ``generator`` on the device of ``like``."""
    if eps is None:
        return torch.randn(shape, generator=generator, dtype=like.dtype,
                           device=like.device)
    if eps.shape != shape:
        raise ValueError(f"eps must be {shape}, got {tuple(eps.shape)}")
    return eps


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

    The noise is ``eps [S, B, Z, T]`` when given, else standard normal
    from ``generator`` on the device of ``mu``.  ``l_q`` with leading dim
    1 is shared across the batch.
    """
    b = mu.shape[0]
    _, z, t, _ = l_q.shape
    eps = _noise((num_samples, b, z, t), mu, eps, generator)
    if l_q.shape[0] == 1 and b > 1:
        corr = torch.einsum("zij,sbzj->sbiz", l_q[0], eps)
    else:
        corr = torch.einsum("bzij,sbzj->sbiz", l_q, eps)
    out = mu[None] + corr
    if mask is not None:
        out = out * mask.to(out.dtype)[None, :, :, None]
    return out


def diag_sample(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    num_samples: int = 1,
    mask: torch.Tensor | None = None,
    *,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``z = mu + sqrt(v) eps`` -> ``[S, B, T, Z]`` (``gp.py:560-575``).
    The noise is ``eps [S, B, T, Z]`` (the layout of ``mu``, as the JAX
    package draws it), else drawn from ``generator``."""
    eps = _noise((num_samples,) + tuple(mu.shape), mu, eps, generator)
    out = mu[None] + torch.exp(0.5 * log_var)[None] * eps
    if mask is not None:
        out = out * mask.to(out.dtype)[None, :, :, None]
    return out


def recog_sample(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    l_q: torch.Tensor,
    num_samples: int = 1,
    mask: torch.Tensor | None = None,
    *,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The recognition sampler ``z = mu + (L_q + diag(sqrt v)) eps`` ->
    ``[S, B, T, Z]`` (``gp.py:578-603``).  ``l_q`` with leading dim 1 is
    shared and broadcasts against each sequence's ``diag(sqrt v)``; the
    noise is ``eps [S, B, Z, T]``, else drawn from ``generator``."""
    b = mu.shape[0]
    _, z, t, _ = l_q.shape
    c = l_q + _batch_diag(torch.exp(0.5 * log_var.mT))
    eps = _noise((num_samples, b, z, t), mu, eps, generator)
    out = mu[None] + torch.einsum("bzij,sbzj->sbiz", c, eps)
    if mask is not None:
        out = out * mask.to(out.dtype)[None, :, :, None]
    return out


def prior_sample(
    l_p: torch.Tensor,
    num_samples: int = 1,
    *,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Latent trajectories from the GP prior, ``z = L_p eps`` -> ``[S, B,
    T, Z]``; ``eps [S, B, Z, T]`` or drawn from ``generator``."""
    b, z, t, _ = l_p.shape
    eps = _noise((num_samples, b, z, t), l_p, eps, generator)
    return torch.einsum("bzij,sbzj->sbiz", l_p, eps)


# ---------------------------------------------------------------------------
# GP posterior conditioning (imputation)
# ---------------------------------------------------------------------------

class GPPosterior(NamedTuple):
    mean: torch.Tensor         # [B, Tq, Z]
    cov: torch.Tensor | None   # [B, Z, Tq, Tq], None without the covariance


def _jitter(dtype: torch.dtype) -> float:
    """The diagonal added before a factorization: float32 needs about 1e-5
    of headroom on near-singular RBF grams, 1e-6 is a float64 habit."""
    return 1e-6 if dtype.itemsize >= 8 else 1e-5


def posterior_conditional(
    times_obs: torch.Tensor,
    z_obs: torch.Tensor,
    times_query: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask_obs: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    jitter: float | None = None,
    with_cov: bool = True,
) -> GPPosterior:
    """Batched GP conditioning ``p(z(t_query) | z(t_obs))`` per latent dim:

        L   = chol(K_oo + jitter I)
        A   = L^{-1} K_oq
        m*  = A^T L^{-1} z_obs
        S*  = K_qq - A^T A

    Masked observations are identity rows of ``K_oo`` and zero rows of
    ``K_oq`` and ``z_obs``, contributing nothing.  ``times_obs [B, To]``,
    ``z_obs [B, To, Z]``, ``times_query [B, Tq]``.  ``with_cov=False``
    skips ``K_qq`` and ``S*`` and returns ``cov=None``.

    By substitution ``A`` and ``L^{-1} z`` come from ONE solve against the
    columns of ``[K_oq, z]`` (the JAX package solves twice and leaves XLA
    to merge the two).  Where the solve would take ``L``'s explicit
    inverse (``ops.trsm.inverse_route``: CUDA, To <= 2048) the mean is
    ``K_qo (L L^T)^{-1} z`` instead, from the single column ``z``
    (``ops.trsm.cho_solve_by_inverse``: one ``tri_inv``, each product
    refined by its residual), and ``A`` is taken only for ``S*``, by the
    same inverse: the inverse's float32 rounding in ``A`` cost
    ``t1024_toeplitz``'s T=1024 mean 7x the library's substitution error
    on an H100.  (By substitution
    the mean keeps ``A^T L^{-1} z``: at T=4096, cond(K) ~ 1e6, the float32
    rounding of ``(L L^T)^{-1} z`` would cost more than the solve.)
    """
    if jitter is None:
        jitter = _jitter(times_obs.dtype)
    k_oo = kernels_lib.gram_bank(times_obs, lengthscales, kernel=kernel,
                                 noise=noise, variance=variance,
                                 mask=mask_obs)
    t_o = times_obs.shape[-1]
    k_oo = k_oo + jitter * torch.eye(t_o, dtype=k_oo.dtype,
                                     device=k_oo.device)
    k_oq = kernels_lib.cross_gram(times_obs, times_query, lengthscales,
                                  kernel=kernel, noise=noise,
                                  variance=variance, mask_a=mask_obs)
    l = cholesky(k_oo)
    z_bz = z_obs.mT[..., None]                          # [B, Z, To, 1]
    if mask_obs is not None:
        z_bz = z_bz * mask_obs.to(z_bz.dtype)[:, None, :, None]
    if inverse_route(l):
        x_inv = tri_inv(l)
        w = cho_solve_by_inverse(l, z_bz, x_inv)        # K_oo^{-1} z
        mean = (k_oq.mT @ w)[..., 0].mT                 # [B, Tq, Z]
        if not with_cov:
            return GPPosterior(mean=mean, cov=None)
        a = solve_by_inverse(l, k_oq, x_inv)            # L^{-1} K_oq
    else:
        t_q = times_query.shape[-1]
        solved = solve_triangular(l, torch.cat([k_oq, z_bz], dim=-1))
        a, alpha = solved[..., :t_q], solved[..., t_q:]  # L^-1 K_oq, L^-1 z
        mean = (a.mT @ alpha)[..., 0].mT                 # [B, Tq, Z]
        if not with_cov:
            return GPPosterior(mean=mean, cov=None)
    k_qq = kernels_lib.gram_bank(times_query, lengthscales, kernel=kernel,
                                 noise=noise, variance=variance)
    return GPPosterior(mean=mean, cov=k_qq - a.mT @ a)


def posterior_sample(
    post: GPPosterior,
    num_samples: int = 1,
    jitter: float | None = None,
    *,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Trajectories from a conditioned posterior (with its covariance) ->
    ``[S, B, Tq, Z]``; ``eps [S, B, Z, Tq]`` or drawn from ``generator``.
    Where ``S* + jitter I`` is not positive definite in its dtype the
    factor, and so the draw, holds NaN."""
    b, z, tq, _ = post.cov.shape
    if jitter is None:
        jitter = _jitter(post.cov.dtype)
    cov = post.cov + jitter * torch.eye(tq, dtype=post.cov.dtype,
                                        device=post.cov.device)
    l = cholesky(cov)
    eps = _noise((num_samples, b, z, tq), post.mean, eps, generator)
    return post.mean[None] + torch.einsum("bzij,sbzj->sbiz", l, eps)
