"""Device dispatch for the ops that own a hand-written kernel.

The JAX package decides per traced computation whether it targets a TPU
(``gpvae_tpu/ops/dispatch.py``).  PyTorch runs eagerly and every tensor
knows its device, so the port has exactly one rule: a tensor on a CUDA
device goes to the kernel, a tensor on the CPU goes to the plain PyTorch
version of the same function.  There is no fallback between the two: a
CUDA tensor that the kernel cannot take raises.
"""
from __future__ import annotations

import torch


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the CUDA kernel."""
    return t.is_cuda


def check_kernel_input(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless ``t`` is what a kernel of this package takes: a
    contiguous float32 CUDA tensor of ``ndim`` dimensions."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(
            f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
