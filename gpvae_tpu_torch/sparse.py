"""The sparse inducing-point GP prior (FITC) for long sequences.

Counterpart of ``gpvae_tpu/sparse.py:34-196`` (BASELINE config 4: T=4096
sequences under an m=64 inducing-point prior).  The prior is

    p(z) = N(0, Q + D),  Q = K_tm K_mm^{-1} K_mt,  D = diag(K_tt - diag Q)

(plus the noise on D's diagonal), and its KL against a diagonal posterior
takes O(T m^2) through the whitened ``B = I + V0 V0^T``,
``V0 = L_mm^{-1} K_mt D^{-1/2}``: I + PSD, so its Cholesky keeps positive
definiteness in float32, where ``A = K_mm + K_mt D^{-1} K_tm`` does not.
No T x T matrix is formed.  Masked steps get d = 1, zero ``K_tm`` rows and
neutral mu and v, and contribute exactly zero.

The factors come from ``ops.chol.cholesky`` (one ``chol_block`` launch for
a side m <= 128 on a CUDA tensor) and the solves from
``ops.trsm.solve_triangular`` (``tri_inv`` and one matmul on a CUDA
tensor), as the JAX package routes them to its Pallas kernels.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.gp import _noise
from gpvae_tpu_torch.ops.chol import cholesky
from gpvae_tpu_torch.ops.logdet import logdet_from_chol
from gpvae_tpu_torch.ops.trsm import solve_triangular


def _resolve_jitter(jitter: float | None, dtype: torch.dtype) -> float:
    """The diagonal that keeps chol(K_mm) finite: RBF inducing grams are
    badly conditioned, and float32 needs ~1e-4 where float64 takes 1e-6
    (``sparse.py:39-46``)."""
    if jitter is not None:
        return jitter
    return 1e-6 if dtype.itemsize >= 8 else 1e-4


def uniform_inducing_times(t_min: float, t_max: float, m: int, *,
                           dtype: torch.dtype = torch.float32,
                           device: torch.device | str | None = None
                           ) -> torch.Tensor:
    """The default inducing grid: ``m`` points spread over
    ``[t_min, t_max]``."""
    return torch.linspace(t_min, t_max, m, dtype=dtype, device=device)


def fitc_prior_parts(
    times: torch.Tensor,
    inducing_times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    jitter: float | None = None,
):
    """``(l_mm [B, Z, m, m], k_tm [B, Z, T, m], d [B, Z, T])``: the
    factor of ``K_mm + jitter I``, the cross-covariance and FITC's
    diagonal.  ``times [B, T]``; ``inducing_times [m]`` (shared) or ``[B,
    m]``.  Every covariance is the signal part of the gram (its ``1 -
    noise`` scale); the noise returns on D's diagonal."""
    b = times.shape[0]
    jitter = _resolve_jitter(jitter, times.dtype)
    s = (inducing_times[None].expand(b, -1) if inducing_times.dim() == 1
         else inducing_times)
    m = s.shape[-1]
    gram = dict(kernel=kernel, noise=noise, variance=variance)
    k_mm = kernels_lib.cross_gram(s, s, lengthscales, **gram) + jitter * (
        torch.eye(m, dtype=times.dtype, device=times.device))
    k_tm = kernels_lib.cross_gram(times, s, lengthscales, mask_a=mask, **gram)
    l_mm = cholesky(k_mm)
    # diag(Q) = row-wise ||L_mm^{-1} k_m(t_i)||^2
    v_m = solve_triangular(l_mm, k_tm.mT)                     # [B, Z, m, T]
    q_diag = torch.sum(v_m * v_m, dim=-2)                     # [B, Z, T]
    variance = torch.as_tensor(variance, dtype=q_diag.dtype,
                               device=q_diag.device)
    if variance.dim() == 1:
        k_tt_diag = (1.0 - noise) * variance[None, :, None]
    else:
        k_tt_diag = ((1.0 - noise) * variance).expand_as(q_diag)
    d = torch.clamp(k_tt_diag - q_diag, min=0.0) + noise
    if mask is not None:
        mm = mask.to(d.dtype)[:, None, :]
        d = d * mm + (1.0 - mm)  # masked -> d = 1
    return l_mm, k_tm, d


def fitc_diag_kl(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    times: torch.Tensor,
    inducing_times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    jitter: float | None = None,
) -> torch.Tensor:
    """``KL(N(mu, diag v) || N(0, Q + D))`` -> ``[B, Z]`` in O(T m^2),
    the sparse counterpart of ``gp.gp_prior_diag_kl``; ``mu`` and
    ``log_var`` are ``[B, T, Z]``.  With ``Wt = L_B^{-1} V0 D^{-1/2}``:
    ``logdet(Q + D) = logdet B + sum log d``, ``(Q + D)^{-1} = D^{-1} -
    Wt^T Wt``."""
    t = mu.shape[-2]
    jitter = _resolve_jitter(jitter, times.dtype)
    if mask is not None:
        m_ = mask.to(mu.dtype)[..., None]
        mu = mu * m_
        log_var = log_var * m_  # masked -> v = 1
    l_mm, k_tm, d = fitc_prior_parts(
        times, inducing_times, lengthscales, mask=mask, kernel=kernel,
        noise=noise, variance=variance, jitter=jitter)
    mu_bz = mu.mT                                             # [B, Z, T]
    v_bz = torch.exp(log_var.mT)
    d_inv = 1.0 / d
    d_isqrt = torch.sqrt(d_inv)
    # the second solve against L_mm is the JAX package's (it solves in
    # fitc_prior_parts and again here)
    v0 = solve_triangular(l_mm, k_tm.mT) * d_isqrt[..., None, :]  # [B,Z,m,T]
    m = v0.shape[-2]
    b_mat = torch.eye(m, dtype=v0.dtype, device=v0.device) + v0 @ v0.mT
    l_b = cholesky(b_mat)
    w = solve_triangular(l_b, v0) * d_isqrt[..., None, :]     # Wt [B,Z,m,T]

    ld_p = logdet_from_chol(l_b) + torch.sum(torch.log(d), dim=-1)
    # tr((Q + D)^{-1} diag v)
    tr = torch.sum(v_bz * d_inv, dim=-1) - torch.sum(
        torch.sum(w * w, dim=-2) * v_bz, dim=-1)
    wmu = (w @ mu_bz[..., None])[..., 0]                      # [B, Z, m]
    quad = torch.sum(mu_bz * mu_bz * d_inv, dim=-1) - torch.sum(
        wmu * wmu, dim=-1)
    sum_log_v = torch.sum(log_var.mT, dim=-1)
    return 0.5 * (tr + quad - t + ld_p - sum_log_v)


def fitc_prior_sample(
    times: torch.Tensor,
    inducing_times: torch.Tensor,
    lengthscales: torch.Tensor,
    num_samples: int = 1,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    jitter: float | None = None,
    eps_m: torch.Tensor | None = None,
    eps_t: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """A draw from the FITC prior in O(T m), ``z = K_tm L_mm^{-T} eps_m +
    sqrt(D) eps_t`` -> ``[S, B, T, Z]``.  The noise is ``eps_m [S, B, Z,
    m]`` and ``eps_t [S, B, Z, T]`` where given (the JAX package draws
    them from the two halves of its key), else standard normal from
    ``generator`` on the device of ``times``, ``eps_m`` first."""
    l_mm, k_tm, d = fitc_prior_parts(
        times, inducing_times, lengthscales, mask=mask, kernel=kernel,
        noise=noise, variance=variance, jitter=jitter)
    b, z, t, m = k_tm.shape
    eps_m = _noise((num_samples, b, z, m), d, eps_m, generator)
    eps_t = _noise((num_samples, b, z, t), d, eps_t, generator)
    # K_tm L_mm^{-T} = (L_mm^{-1} K_mt)^T
    v_m = solve_triangular(l_mm, k_tm.mT)                     # [B, Z, m, T]
    low_rank = torch.einsum("bzmt,sbzm->sbzt", v_m, eps_m)
    out = low_rank + torch.sqrt(d)[None] * eps_t
    return out.mT                                             # [S, B, T, Z]

