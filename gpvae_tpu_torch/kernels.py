"""Stationary GP kernel functions and batched gram construction.

Counterpart of ``gpvae_tpu/kernels.py:42-258``.  The gram keeps the JAX
package's semantics exactly: ``K = (1 - noise) * variance * k(dt) +
noise * I``, and with a mask (True = observed) masked rows and columns
become identity, ``K = M K M + (I - diag m)``, so the factorization stays
well-posed and masked steps contribute nothing to a logdet or a KL.  On a
uniform grid the gram is Toeplitz: ``toeplitz_row`` gives its first row
(the Toeplitz prior's O(T) form), ``toeplitz_to_dense`` the matrix.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

# Diagonal jitter / noise weight of the reference (sigma_n = 1e-3)
DEFAULT_NOISE = 1e-3

KernelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def rbf(dt: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Squared-exponential kernel ``exp(-dt^2 / (2 l^2))``."""
    z = dt / lengthscale
    return torch.exp(-0.5 * z * z)


def matern12(dt: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Matérn ν=1/2 (Ornstein–Uhlenbeck / exponential)."""
    return torch.exp(-torch.abs(dt) / lengthscale)


def matern32(dt: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Matérn ν=3/2."""
    z = math.sqrt(3.0) * torch.abs(dt) / lengthscale
    return (1.0 + z) * torch.exp(-z)


def matern52(dt: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Matérn ν=5/2."""
    z = math.sqrt(5.0) * torch.abs(dt) / lengthscale
    return (1.0 + z + z * z / 3.0) * torch.exp(-z)


def cauchy(dt: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Rational-quadratic / Cauchy kernel ``1 / (1 + (dt / l)^2)``."""
    z = dt / lengthscale
    return 1.0 / (1.0 + z * z)


def cosine(dt: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Cosine kernel ``cos(dt / l)`` (the toy generator's second latent)."""
    return torch.cos(dt / lengthscale)


KERNELS: dict[str, KernelFn] = {
    "rbf": rbf,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
    "cauchy": cauchy,
    "cosine": cosine,
}

# integer code of each kernel family in csrc/gram.cuh (enum KernelCode)
KERNEL_CODES: dict[str, int] = {name: i for i, name in enumerate(KERNELS)}


def get_kernel(name: str) -> KernelFn:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None


def _masked_identity(k: torch.Tensor, mask: torch.Tensor | None,
                     noise: float) -> torch.Tensor:
    """``(1 - noise) k + noise I``, then masked rows/cols to identity."""
    t = k.shape[-1]
    eye = torch.eye(t, dtype=k.dtype, device=k.device)
    k = (1.0 - noise) * k + noise * eye
    if mask is not None:
        m = mask.to(k.dtype)
        mm = m[..., :, None] * m[..., None, :]
        k = k * mm + (1.0 - m[..., :, None]) * eye
    return k


def gram(
    times: torch.Tensor,
    lengthscale: torch.Tensor | float,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gram matrix ``K [..., T, T]`` over a time vector ``times [..., T]``."""
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dt = times[..., :, None] - times[..., None, :]
    k = variance * kfn(dt, torch.as_tensor(lengthscale, dtype=dt.dtype,
                                           device=dt.device))
    return _masked_identity(k, mask, noise)


def gram_bank(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched per-latent gram bank ``K [B, Z, T, T]``.

    * ``times``        ``[B, T]`` per-sequence observation times,
    * ``lengthscales`` ``[Z]`` or ``[B, Z]``,
    * ``variance``     scalar or ``[Z]``,
    * ``mask``         ``[B, T]`` bool, True where observed.

    Returns the bank in the dtype of ``times``.
    """
    if times.dim() != 2:
        raise ValueError(f"times must be [B, T], got {tuple(times.shape)}")
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dt = times[:, None, :, None] - times[:, None, None, :]  # [B,1,T,T]
    if lengthscales.dim() == 1:
        ls = lengthscales[None, :, None, None]
    elif lengthscales.dim() == 2:
        ls = lengthscales[:, :, None, None]
    else:
        raise ValueError(
            f"lengthscales must be [Z] or [B, Z], got "
            f"{tuple(lengthscales.shape)}"
        )
    variance = torch.as_tensor(variance, dtype=dt.dtype, device=dt.device)
    if variance.dim() == 1:  # per-latent variance
        variance = variance[None, :, None, None]
    k = variance * kfn(dt, ls.to(dt.dtype))
    return _masked_identity(
        k, None if mask is None else mask[:, None, :], noise
    )


def cross_gram(
    times_a: torch.Tensor,
    times_b: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rectangular cross-covariance ``K [B, Z, Ta, Tb]`` between the grids
    ``times_a [B, Ta]`` and ``times_b [B, Tb]``: ``(1 - noise) * variance
    * k(dt)``, the signal part of the square gram with no noise diagonal.
    Masked rows (``mask_a``) and columns (``mask_b``) are zero."""
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dt = times_a[:, None, :, None] - times_b[:, None, None, :]  # [B,1,Ta,Tb]
    if lengthscales.dim() == 1:
        ls = lengthscales[None, :, None, None]
    else:
        ls = lengthscales[:, :, None, None]
    variance = torch.as_tensor(variance, dtype=dt.dtype, device=dt.device)
    if variance.dim() == 1:
        variance = variance[None, :, None, None]
    k = (1.0 - noise) * variance * kfn(dt, ls.to(dt.dtype))
    if mask_a is not None:
        k = k * mask_a.to(k.dtype)[:, None, :, None]
    if mask_b is not None:
        k = k * mask_b.to(k.dtype)[:, None, None, :]
    return k


def toeplitz_row(
    t: int,
    step: torch.Tensor | float,
    lengthscales: torch.Tensor,
    *,
    kernel: str | KernelFn = "rbf",
    noise: float = DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """First rows ``[Z, T]`` of the per-latent Toeplitz grams of a
    *uniform* grid with spacing ``step`` (``kernels.py:225-250``): lag
    ``k`` holds ``(1 - noise) * variance * k(k * step) + noise * [k ==
    0]``, returned in ``dtype`` (float32 by default, as the JAX
    package's), on the device of ``lengthscales``.

    The row is computed in float64 from ``step``, ``lengthscales`` and
    ``variance`` as given and rounded to ``dtype`` once, as
    ``csrc/gram.cuh`` builds the dense grams on the card: the Durbin
    recursion takes the row in float64, and a KL between a dense
    posterior and this prior compares the two grams, whose float32
    roundings should then agree (a row built in float32 beside the
    card's exactly rounded posterior gram left a learned prior's
    lengthscale gradients 4-6x the CPU's float32 error on an H100)."""
    kfn = get_kernel(kernel) if isinstance(kernel, str) else kernel
    dev = lengthscales.device
    f64 = torch.float64
    lags = torch.arange(t, dtype=f64, device=dev) * torch.as_tensor(
        step, device=dev).to(f64)
    variance = torch.as_tensor(variance, device=dev).to(f64)
    if variance.dim() == 1:
        variance = variance[:, None]
    row = variance * kfn(lags[None, :], lengthscales[:, None].to(f64))
    unit = torch.zeros(t, dtype=f64, device=dev)
    unit[0] = 1.0
    return ((1.0 - noise) * row + noise * unit[None, :]).to(dtype)


def toeplitz_to_dense(row: torch.Tensor) -> torch.Tensor:
    """The symmetric Toeplitz matrices ``[..., T, T]`` of first rows
    ``row [..., T]`` (``kernels.py:253-258``)."""
    t = row.shape[-1]
    idx = torch.arange(t, device=row.device)
    return row[..., (idx[:, None] - idx[None, :]).abs()]
