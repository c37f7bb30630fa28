"""The Cholesky backward's products, ``K_bar = X^T W X``, on the card.

``csrc/chol_bwd.cu`` takes the float32 products of
:func:`ops.chol.cholesky_bwd_from_l` from the library's SIMT SGEMMs to
the tensor cores in 3xTF32 (never single-pass TF32), in three passes that
walk only the tiles the triangles and the symmetric results need:

1. ``W = 1/2 L^T L_bar`` on the lower tiles, mirrored, ``g`` on the
   diagonal: ``sym(phi(L^T L_bar)) + g I``;
2. ``M = X^T W``;
3. ``K_bar = M X`` on the lower tiles, mirrored,

about 2 T^3 a matrix where the 2 x 2 blocks of ``ops.chol`` take 3.5 T^3,
in 3 launches where they take 14 products and their elementwise passes.

It replaces no Pallas kernel: it takes the matmuls of the JAX package's
``gpvae_tpu/ops/chol.py:497-578`` (``_phi_w_blocks``,
``_tri_sandwich_blocks``), which XLA runs there.  ``X = L^{-1}`` is
``ops.tri_inv``'s, unchanged.

The kernel takes CUDA float32 banks with T a multiple of 128 and a
cotangent of the factor (:func:`engaged`); every other call keeps
``ops.chol``'s products.  At T=128 it is one tile a matrix, and still
ahead of the dense products it replaces there (0.168 against 0.225 ms at
N=256 on an H100).
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch.ops import _build, dispatch

TILE = 128  # the kernel's output tile: T is a multiple of it
# launches of csrc/chol_bwd.cu in this process, 3 a backward (callers may
# reset it): lets a run show that its main path went through the kernel
LAUNCHES = 0

_ENTRY_POINTS = {
    "gpvae_chol_bwd_f32": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p],
}


def build() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    use)."""
    _build.load("chol_bwd", _ENTRY_POINTS)


def engaged(l: torch.Tensor, l_bar: torch.Tensor | None) -> bool:
    """Whether ``cholesky_bwd_from_l`` takes the kernel: a cotangent of the
    factor, and a CUDA float32 bank whose side is a multiple of 128."""
    return (l_bar is not None and dispatch.on_cuda(l)
            and l.dtype == torch.float32 and l.shape[-1] % TILE == 0)


def chol_bwd_plain(l: torch.Tensor, l_bar: torch.Tensor | None,
                   x: torch.Tensor,
                   logdet_bar: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the three passes, any dtype and side:
    ``K_bar`` from the factor ``l [..., T, T]``, its cotangent ``l_bar``
    (None: zero), ``x = L^{-1}`` and the logdet's cotangent ``logdet_bar
    [...]`` (None: zero)."""
    if l_bar is None:
        w = torch.zeros_like(l)
    else:
        p = l.mT @ l_bar
        w = 0.5 * (torch.tril(p) + torch.tril(p, -1).mT)
    if logdet_bar is not None:
        w.diagonal(dim1=-2, dim2=-1).add_(logdet_bar[..., None])
    k = (x.mT @ w) @ x
    return 0.5 * (k + k.mT)


def chol_bwd_cuda(l: torch.Tensor, l_bar: torch.Tensor, x: torch.Tensor,
                  logdet_bar: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/chol_bwd.cu``'s three passes on the current stream:
    ``l``, ``l_bar``, ``x`` ``[..., T, T]`` float32 on one CUDA device
    (made contiguous), T a multiple of 128; ``logdet_bar [...]`` or None.
    Returns ``K_bar`` with ``l``'s shape."""
    global LAUNCHES
    shape, t = l.shape, l.shape[-1]
    if t % TILE != 0 or l.shape[-2] != t:
        raise ValueError(f"chol_bwd: the kernel takes square sides that "
                         f"are a multiple of {TILE}, got {tuple(shape)}")
    if l_bar.shape != shape or x.shape != shape:
        raise ValueError(
            f"chol_bwd: l, l_bar and x differ in shape: {tuple(shape)}, "
            f"{tuple(l_bar.shape)}, {tuple(x.shape)}")
    banks = [m.reshape(-1, t, t).contiguous() for m in (l, l_bar, x)]
    for m, name in zip(banks, ("l", "l_bar", "x")):
        dispatch.check_kernel_input(m, f"chol_bwd ({name})", 3)
        if m.data_ptr() % 16:  # the kernel's copies move 16 bytes
            raise ValueError(f"chol_bwd ({name}): expected a 16-byte "
                             f"aligned bank")
    n = banks[0].shape[0]
    g = None
    if logdet_bar is not None:
        g = logdet_bar.reshape(-1).contiguous()
        dispatch.check_kernel_input(g, "chol_bwd (logdet_bar)", 1)
        if g.shape[0] != n:
            raise ValueError(f"chol_bwd: logdet_bar has {g.shape[0]} "
                             f"entries for {n} matrices")
    lb, lbarb, xb = banks
    w = torch.empty_like(lb)
    m = torch.empty_like(lb)
    if n == 0:
        return w.reshape(shape)
    lib = _build.load("chol_bwd", _ENTRY_POINTS)
    # pass 2 writes K_bar over W, which only pass 1 reads
    passes = ((0, lb, lbarb, w), (1, xb, w, m), (2, m, xb, w))
    with torch.cuda.device(lb.device):
        stream = torch.cuda.current_stream().cuda_stream
        for pass_, a, b, out in passes:
            status = lib.gpvae_chol_bwd_f32(
                pass_, a.data_ptr(), b.data_ptr(),
                None if g is None else g.data_ptr(), out.data_ptr(), t, n,
                stream)
            _build.check_status(lib, status, f"chol_bwd pass {pass_}")
            LAUNCHES += 1
    return w.reshape(shape)
