"""Differentiable batched lower-triangular inverse, ``X = L^{-1}``.

Counterpart of ``gpvae_tpu/ops/pallas_tri.py:59-231``.  The base case, a
side of at most 64, is the hand-written kernel ``csrc/tri_inv.cu`` on a
CUDA tensor (it replaces the TPU kernel ``pallas_tri._tri_inv_kernel``)
and :func:`tri_inv_plain` on a CPU tensor.  Larger sides are built from
it with plain matmuls, as the JAX package builds them with XLA einsums
around its kernel, and with the same routing (``pallas_tri.py:194-207``):

* :func:`tri_inv_flat` inverts ALL diagonal 64-blocks of all matrices in
  one base call and merges pairs of blocks level by level,
  ``X21 = -X22 L21 X11``, identity-padding T up to 64 * 2^k;
* :func:`tri_inv_blocked`, the 64-aligned halving recursion, where that
  padding would cost more than 2x the merge work (T = 100: 2.1x).

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
        raise ValueError(f"tri_inv: the kernel takes T <= {MAX_T}, got {t}")
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


def tri_inv_small(l: torch.Tensor) -> torch.Tensor:
    """The base case, ``l [N, T, T]`` with T <= 64: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if dispatch.on_cuda(l):
        return tri_inv_cuda(l.contiguous())
    return tri_inv_plain(l)


def tri_inv_blocked(l: torch.Tensor) -> torch.Tensor:
    """``l [N, T, T]`` inverted by halving at a multiple of 64 down to the
    base (``pallas_tri.py:59-96``):
    ``inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]``."""
    n, t, _ = l.shape
    if t <= MAX_T:
        return tri_inv_small(l)
    h = max(MAX_T, ((t // 2 + MAX_T - 1) // MAX_T) * MAX_T)
    if h >= t:  # t in (64, 128): split at 64
        h = MAX_T
    x = l.new_zeros((n, t, t))
    ia = tri_inv_blocked(l[:, :h, :h])
    ic = tri_inv_blocked(l[:, h:, h:])
    x[:, :h, :h] = ia
    x[:, h:, h:] = ic
    x[:, h:, :h] = -(ic @ (l[:, h:, :h] @ ia))
    return x


def _block_diag_extract(l: torch.Tensor, s: int) -> torch.Tensor:
    """``[N, T, T] -> [N, T//s, s, s]``: a VIEW of the diagonal s-blocks
    (``pallas_tri.py:99-111`` gathers them with a selection einsum), so a
    write through it lands in ``l``."""
    n, t, _ = l.shape
    c = t // s
    return torch.diagonal(l.view(n, c, s, c, s), dim1=1,
                          dim2=3).permute(0, 3, 1, 2)


def _pad_side(t: int) -> int:
    """The next 64 * 2^k at or above ``t``."""
    t_pad = MAX_T
    while t_pad < t:
        t_pad *= 2
    return t_pad


def tri_inv_flat(l: torch.Tensor) -> torch.Tensor:
    """``l [N, T, T]`` inverted level by level (``pallas_tri.py:114-168``):
    every diagonal 64-block of every matrix in ONE base call, then at
    level s each pair of adjacent s-blocks merges with two batched
    matmuls, ``X21 = -X22 (L21 X11)``, written into place.  T is
    identity-padded to 64 * 2^k (the inverse of blockdiag(L, I) is
    blockdiag(L^-1, I))."""
    n, t, _ = l.shape
    if t <= MAX_T:
        return tri_inv_small(l)
    t_pad = _pad_side(t)
    if t_pad == t:
        lp = l.contiguous()
    else:
        lp = l.new_zeros((n, t_pad, t_pad))
        lp[:, :t, :t] = l
        lp.diagonal(dim1=1, dim2=2)[:, t:] = 1.0
    x = torch.zeros_like(lp)
    c = t_pad // MAX_T
    base = tri_inv_small(
        _block_diag_extract(lp, MAX_T).reshape(n * c, MAX_T, MAX_T))
    _block_diag_extract(x, MAX_T).copy_(base.view(n, c, MAX_T, MAX_T))
    s = MAX_T
    while s < t_pad:
        lb = _block_diag_extract(lp, 2 * s)    # [N, pairs, 2s, 2s] views
        xb = _block_diag_extract(x, 2 * s)
        xb[:, :, s:, :s] = -(xb[:, :, s:, s:] @ (lb[:, :, s:, :s]
                                                  @ xb[:, :, :s, :s]))
        s *= 2
    return x[:, :t, :t] if t_pad != t else x


def _flat_pad_overhead(t: int) -> float:
    """FLOP multiplier of :func:`tri_inv_flat`'s padding at ``t`` (1.0 when
    t is already 64 * 2^k)."""
    return (_pad_side(t) / t) ** 3


def _tri_inv_any(l: torch.Tensor) -> torch.Tensor:
    """``l [N, T, T]`` by the JAX package's routing (``pallas_tri.py:
    194-207``)."""
    t = l.shape[-1]
    if t <= MAX_T:
        return tri_inv_small(l)
    if _flat_pad_overhead(t) <= 2.0:
        return tri_inv_flat(l)
    return tri_inv_blocked(l)


class _TriInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l):
        t = l.shape[-1]
        x = _tri_inv_any(l.reshape(-1, t, t)).reshape(l.shape)
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
