"""Differentiable batched lower-triangular inverse, ``X = L^{-1}``.

Counterpart of ``gpvae_tpu/ops/pallas_tri.py:180-231`` (``tri_inv`` and
``tri_inv_small_batched``).  A CUDA tensor goes through the hand-written
kernel ``csrc/tri_inv.cu``, which replaces the TPU kernel
``pallas_tri._tri_inv_kernel``; a CPU tensor goes through
:func:`tri_inv_plain`.  Supported side: T <= 64 on CUDA.

The gradient is the analytic rule of ``pallas_tri.py:215-222``:
``L_bar = -tril(X^T X_bar X^T)``, two matmuls.
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch.ops import _build, dispatch

MAX_T = 64
# launches of csrc/tri_inv.cu in this process (callers may reset it): lets
# a run show that its main path went through the kernel
LAUNCHES = 0

_ENTRY_POINTS = {
    "gpvae_tri_inv_f32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p],
}


def build() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    use)."""
    _build.load("tri_inv", _ENTRY_POINTS)


def tri_inv_plain(l: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``solve_triangular(L, I)``, any dtype."""
    t = l.shape[-1]
    eye = torch.eye(t, dtype=l.dtype, device=l.device).expand_as(l)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def tri_inv_cuda(l: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/tri_inv.cu`` on ``l [N, T, T]`` (float32, contiguous,
    CUDA, T <= 64) on the current stream; returns ``X [N, T, T]``."""
    global LAUNCHES
    dispatch.check_kernel_input(l, "tri_inv", 3)
    n, t, t2 = l.shape
    if t != t2:
        raise ValueError(
            f"tri_inv: matrices must be square, got {tuple(l.shape)}"
        )
    if t > MAX_T:
        raise NotImplementedError("large-T covariance path: ROADMAP slice 2")
    out = torch.empty_like(l)
    if n == 0:
        return out
    lib = _build.load("tri_inv", _ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_tri_inv_f32(l.data_ptr(), out.data_ptr(), n, t,
                                       stream)
    _build.check_status(lib, status, "tri_inv")
    LAUNCHES += 1
    return out


class _TriInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l):
        t = l.shape[-1]
        if dispatch.on_cuda(l):
            flat = l.reshape(-1, t, t).contiguous()
            x = tri_inv_cuda(flat).reshape(l.shape)
        else:
            x = tri_inv_plain(l)
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        (x,) = ctx.saved_tensors
        xt = x.transpose(-1, -2)
        return -torch.tril(xt @ x_bar @ xt)


def tri_inv(l: torch.Tensor) -> torch.Tensor:
    """Differentiable lower-triangular inverse ``[..., T, T]``."""
    return _TriInv.apply(l)
