"""Fused gram-bank construction + batched Cholesky, ``L [B, Z, T, T]``.

Counterpart of ``gpvae_tpu/ops/pallas_chol.py:716-794``
(``gram_chol_fused``).  A CUDA tensor goes through the hand-written kernel
``csrc/gram_chol.cu``, which replaces the TPU kernel
``pallas_chol._make_gram_chol_kernel``; a CPU tensor goes through
:func:`gram_chol_plain`.  Both take the same arguments and broadcast them
onto the same flat bank of N = B*Z matrices, matrix index ``b * Z + z``.

Forward only: the differentiable entry point is
``gpvae_tpu_torch.gp.chol_gram_bank``.
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops import _build, dispatch

MAX_T = 64
# launches of csrc/gram_chol.cu in this process (callers may reset it):
# lets a run show that its main path went through the kernel
LAUNCHES = 0

_ENTRY_POINTS = {
    "gpvae_gram_chol_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ],
}


def build() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    use)."""
    _build.load("gram_chol", _ENTRY_POINTS)


def gram_chol_plain(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version: ``cholesky(gram_bank(...))``, any dtype."""
    k = kernels_lib.gram_bank(times, lengthscales, kernel=kernel,
                              noise=noise, variance=variance, mask=mask)
    return torch.linalg.cholesky(k)


def flat_bank(times, lengthscales, mask, variance, dtype=torch.float32):
    """Broadcast the arguments onto the flat bank (``pallas_chol.py:
    747-762``): ``times, mask [N, T]`` and ``ls, var [N]`` in ``dtype``,
    contiguous, with ``N = B * Z`` and matrix index ``b * Z + z``."""
    b, t = times.shape
    z = lengthscales.shape[-1]
    n = b * z
    f32 = dtype
    tt = times.to(f32)[:, None, :].expand(b, z, t).reshape(n, t)
    if lengthscales.dim() == 1:
        ls = lengthscales.to(f32)[None, :].expand(b, z).reshape(n)
    else:
        ls = lengthscales.to(f32).reshape(n)
    if mask is None:
        mk = torch.ones((n, t), dtype=f32, device=times.device)
    else:
        mk = mask.to(f32)[:, None, :].expand(b, z, t).reshape(n, t)
    var = torch.as_tensor(variance, dtype=f32, device=times.device)
    if var.dim() == 0:
        var = var.expand(n)
    else:
        var = var[None, :].expand(b, z).reshape(n)
    return tuple(a.contiguous() for a in (tt, mk, ls, var))


def gram_chol_cuda(times, mask, ls, var, *, kernel: str = "rbf",
                   noise: float = kernels_lib.DEFAULT_NOISE) -> torch.Tensor:
    """Launch ``csrc/gram_chol.cu`` on a flat bank (``times, mask [N, T]``,
    ``ls, var [N]``: float32, contiguous, CUDA, T <= 64) on the current
    stream; returns ``L [N, T, T]``."""
    global LAUNCHES
    dispatch.check_kernel_input(times, "gram_chol times", 2)
    dispatch.check_kernel_input(mask, "gram_chol mask", 2)
    dispatch.check_kernel_input(ls, "gram_chol ls", 1)
    dispatch.check_kernel_input(var, "gram_chol var", 1)
    n, t = times.shape
    if mask.shape != (n, t) or ls.shape != (n,) or var.shape != (n,):
        raise ValueError(
            f"gram_chol: inconsistent bank shapes times {tuple(times.shape)}"
            f" mask {tuple(mask.shape)} ls {tuple(ls.shape)}"
            f" var {tuple(var.shape)}"
        )
    if len({times.device, mask.device, ls.device, var.device}) != 1:
        raise ValueError("gram_chol: all inputs must be on one device")
    if t > MAX_T:
        raise ValueError(f"gram_chol: the kernel takes T <= {MAX_T}, got {t}"
                         " (larger T: gp.chol_gram_bank's blocked route)")
    if kernel not in kernels_lib.KERNEL_CODES:
        raise ValueError(
            f"gram_chol: the kernel takes {sorted(kernels_lib.KERNEL_CODES)},"
            f" got {kernel!r}"
        )
    out = torch.empty((n, t, t), dtype=torch.float32, device=times.device)
    if n == 0:
        return out
    lib = _build.load("gram_chol", _ENTRY_POINTS)
    with torch.cuda.device(times.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_gram_chol_f32(
            times.data_ptr(), mask.data_ptr(), ls.data_ptr(), var.data_ptr(),
            out.data_ptr(), n, t, kernels_lib.KERNEL_CODES[kernel],
            float(noise), 1.0 - float(noise), stream,
        )
    _build.check_status(lib, status, "gram_chol")
    LAUNCHES += 1
    return out


def gram_chol_fused(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
    variance: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """Cholesky factors ``L [B, Z, T, T]`` of the masked gram bank.

    * ``times`` ``[B, T]``, ``mask`` ``[B, T]`` bool or None,
    * ``lengthscales`` ``[Z]`` or ``[B, Z]``,
    * ``variance`` scalar or ``[Z]``.

    On CUDA the gram is built and factored inside one kernel and never
    reaches device memory; the result is float32.
    """
    if times.dim() != 2:
        raise ValueError(f"times must be [B, T], got {tuple(times.shape)}")
    if not dispatch.on_cuda(times):
        return gram_chol_plain(times, lengthscales, mask=mask, kernel=kernel,
                               noise=noise, variance=variance)
    b, t = times.shape
    z = lengthscales.shape[-1]
    tt, mk, ls, var = flat_bank(times, lengthscales, mask, variance)
    l = gram_chol_cuda(tt, mk, ls, var, kernel=kernel, noise=noise)
    return l.reshape(b, z, t, t)
