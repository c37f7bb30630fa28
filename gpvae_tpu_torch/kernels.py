"""Stationary GP kernel functions and batched gram construction.

Counterpart of ``gpvae_tpu/kernels.py:42-183``.  The gram keeps the JAX
package's semantics exactly: ``K = (1 - noise) * variance * k(dt) +
noise * I``, and with a mask (True = observed) masked rows and columns
become identity, ``K = M K M + (I - diag m)``, so the factorization stays
well-posed and masked steps contribute nothing to a logdet or a KL.
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

# integer code of each kernel family in csrc/gram_chol.cu (enum KernelCode)
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
