"""Fused gram-bank construction + batched Cholesky, ``L [B, Z, T, T]``.

Counterpart of ``gpvae_tpu/ops/pallas_chol.py:716-794``
(``gram_chol_fused``).  A CUDA tensor goes through the hand-written kernel
``csrc/gram_chol.cu``, which replaces the TPU kernel
``pallas_chol._make_gram_chol_kernel``; a CPU tensor goes through
:func:`gram_chol_plain`.  Matrix ``b * Z + z`` of the bank is latent ``z``
of sequence ``b``.  The kernel reads the arguments as
:func:`gram_chol_fused` receives them (times and mask ``[B, T]``, ls and
variance at their strides), so a call is one launch; :func:`gram_chol_cuda`
takes a flat bank, the case Z = 1.

Forward only: the differentiable entry point is
``gpvae_tpu_torch.gp.chol_gram_bank``.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops import _build, dispatch

MAX_T = 64
# launches of csrc/gram_chol.cu in this process (callers may reset it):
# lets a run show that its main path went through the kernel
LAUNCHES = 0

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ENTRY_POINTS = {
    "gpvae_gram_chol_f32": [_P, _LL, _P, _LL, _I, _P, _LL, _LL, _P, _LL,
                            _LL, _F, _P, _I, _I, _I, _I, _F, _F, _P],
}
# how the kernel reads the mask: none (all observed), bool bytes, float32
_NO_MASK, _BOOL_MASK, _FLOAT_MASK = 0, 1, 2


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


def _check_kernel(t: int, kernel: str) -> None:
    if t > MAX_T:
        raise ValueError(f"gram_chol: the kernel takes T <= {MAX_T}, got {t}"
                         " (larger T: gp.chol_gram_bank's blocked route)")
    if kernel not in kernels_lib.KERNEL_CODES:
        raise ValueError(
            f"gram_chol: the kernel takes {sorted(kernels_lib.KERNEL_CODES)},"
            f" got {kernel!r}"
        )


def _launch(out, times, mask, mask_kind, ls, ls_strides, var, var_strides,
            var_value, z, kernel, noise) -> None:
    """One launch of ``csrc/gram_chol.cu`` on the current stream: ``out
    [N, T, T]``, ``times [B, T]`` and ``mask`` at their row strides (unit
    column stride), element ``(b, z)`` of ls and var at ``b * strides[0]
    + z * strides[1]`` (var None: ``var_value``)."""
    global LAUNCHES
    n, t = out.shape[0], out.shape[-1]
    lib = _build.load("gram_chol", _ENTRY_POINTS)
    with torch.cuda.device(times.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_gram_chol_f32(
            times.data_ptr(), times.stride(0),
            None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.stride(0), mask_kind,
            ls.data_ptr(), *ls_strides,
            None if var is None else var.data_ptr(), *var_strides,
            float(var_value), out.data_ptr(), n, z, t,
            kernels_lib.KERNEL_CODES[kernel], float(noise),
            1.0 - float(noise), stream,
        )
    _build.check_status(lib, status, "gram_chol")
    LAUNCHES += 1


def gram_chol_cuda(times, mask, ls, var, *, kernel: str = "rbf",
                   noise: float = kernels_lib.DEFAULT_NOISE) -> torch.Tensor:
    """Launch ``csrc/gram_chol.cu`` on a flat bank (``times, mask [N, T]``,
    ``ls, var [N]``: float32, contiguous, CUDA, T <= 64) on the current
    stream; returns ``L [N, T, T]``."""
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
    _check_kernel(t, kernel)
    out = torch.empty((n, t, t), dtype=torch.float32, device=times.device)
    if n:
        _launch(out, times, mask, _FLOAT_MASK, ls, (1, 0), var, (1, 0), 0.0,
                1, kernel, noise)
    return out


def _rows(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype`` with unit column stride: itself when it is."""
    x = x.to(dtype)
    return x if x.stride(-1) == 1 else x.contiguous()


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

    On CUDA the gram is built and factored inside one kernel launch and
    never reaches device memory; the result is float32.
    """
    if times.dim() != 2:
        raise ValueError(f"times must be [B, T], got {tuple(times.shape)}")
    if not dispatch.on_cuda(times):
        return gram_chol_plain(times, lengthscales, mask=mask, kernel=kernel,
                               noise=noise, variance=variance)
    b, t = times.shape
    z = lengthscales.shape[-1]
    _check_kernel(t, kernel)
    f32 = torch.float32
    tt = _rows(times, f32)
    if mask is None:
        mk, mask_kind = None, _NO_MASK
    elif mask.dtype == torch.bool:
        mk, mask_kind = _rows(mask, torch.bool), _BOOL_MASK
    else:
        mk, mask_kind = _rows(mask, f32), _FLOAT_MASK
    if mk is not None and mk.shape != (b, t):
        raise ValueError(f"mask must be {(b, t)}, got {tuple(mk.shape)}")
    ls = lengthscales.to(f32)
    if ls.shape == (z,):
        ls_strides = (0, ls.stride(0))
    elif ls.shape == (b, z):
        ls_strides = (ls.stride(0), ls.stride(1))
    else:
        raise ValueError(f"lengthscales must be [Z] or [B, Z], got "
                         f"{tuple(lengthscales.shape)}")
    if isinstance(variance, numbers.Real):
        var, var_strides, var_value = None, (0, 0), float(variance)
    else:
        var = torch.as_tensor(variance, dtype=f32, device=tt.device)
        if var.dim() == 0 or var.shape == (1,):
            var_strides = (0, 0)
        elif var.shape == (z,):
            var_strides = (0, var.stride(0))
        else:
            raise ValueError(f"variance must be a scalar or [Z], got "
                             f"{tuple(var.shape)}")
        var_value = 0.0
    if any(x.device != tt.device for x in (ls, mk, var) if x is not None):
        raise ValueError("gram_chol: all inputs must be on one device")
    out = torch.empty((b, z, t, t), dtype=f32, device=tt.device)
    if b * z:
        _launch(out.view(b * z, t, t), tt, mk, mask_kind, ls, ls_strides,
                var, var_strides, var_value, z, kernel, noise)
    return out
