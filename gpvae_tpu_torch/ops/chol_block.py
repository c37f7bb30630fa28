"""Cholesky factor, and on request its inverse, of a batch of SPD blocks of
side <= 128: ``csrc/chol_block.cu``.

One kernel in place of the TPU's diagonal-block machinery
(``gpvae_tpu/ops/pallas_chol.py``, ``pallas_big.py``): the 64-wide lane
factorizations ``chol_small_batched`` :205, ``chol_inv_small_batched``
:268 and ``gram_chol_inv_small`` :814, and the glue that joins two halves
into a 128-wide block, ``chol_128`` :639, ``chol_inv_128_parts`` :594,
``chol_128_parts`` :613 and ``pallas_big.gram_chol_inv_128_parts`` :928.
On the card a 128-wide block fits in one thread block's shared memory, so
there are no halves: :func:`chol_block` takes a pre-built block,
:func:`gram_chol_block` builds it from the time vectors, and either writes
the finished factor where ``out`` says, which may be inside a larger
factor at a row stride (the TPU's ``diag_parts_writeback``).  The kernel
factors in panels of 16 columns and inverts by recursive doubling
(``csrc/chol_tile.cuh``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version,
``torch.linalg.cholesky`` and ``tri_inv_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops import _build, dispatch
from gpvae_tpu_torch.ops.tri_inv import tri_inv_plain

MAX_T = 128
# launches of csrc/chol_block.cu in this process (callers may reset it):
# lets a run show that its main path went through the kernel
LAUNCHES = 0

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ENTRY_POINTS = {
    "gpvae_chol_block_f32": [_P, _LL, _I, _P, _LL, _I, _P, _I, _I, _P],
    "gpvae_gram_chol_block_f32": [_P, _P, _P, _P, _I, _I, _F, _F, _P, _LL,
                                  _I, _P, _I, _I, _P],
}


def build() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    use)."""
    _build.load("chol_block", _ENTRY_POINTS)


def _check_blocks(x: torch.Tensor, name: str) -> None:
    """A float32 CUDA ``[N, t, t]`` view with unit column stride."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"{name}: expected [N, t, t], got {tuple(x.shape)}")
    if x.shape[-1] > MAX_T:
        raise ValueError(f"{name}: the kernel takes t <= {MAX_T}, got "
                         f"{x.shape[-1]}")
    if x.stride(2) != 1 or x.stride(1) < x.shape[2]:
        raise ValueError(f"{name}: rows must be unit-stride and apart")


def _launch(lib, fn_name: str, *args) -> None:
    global LAUNCHES
    stream = torch.cuda.current_stream().cuda_stream
    status = getattr(lib, fn_name)(*args, stream)
    _build.check_status(lib, status, "chol_block")
    LAUNCHES += 1


def _outputs(like: torch.Tensor, out, inverse: bool):
    n, t = like.shape[0], like.shape[-1]
    if out is None:
        out = torch.empty((n, t, t), dtype=like.dtype, device=like.device)
    elif out.shape != (n, t, t):
        raise ValueError(f"out must be {(n, t, t)}, got {tuple(out.shape)}")
    inv = (torch.empty((n, t, t), dtype=like.dtype, device=like.device)
           if inverse else None)
    return out, inv


def chol_block_plain(d: torch.Tensor, *, inverse: bool = False,
                     out: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`chol_block`: ``torch.linalg.
    cholesky_ex`` (which reads the lower triangle) and ``tri_inv_plain``,
    any dtype and device.  A matrix that is not positive definite comes
    back all NaN, as ``jnp.linalg.cholesky`` returns it, where
    ``torch.linalg.cholesky`` would raise."""
    l, info = torch.linalg.cholesky_ex(d)
    l = torch.where((info == 0)[..., None, None], l, float("nan"))
    inv = tri_inv_plain(l) if inverse else None
    if out is None:
        return l, inv
    out.copy_(l)
    return out, inv


def chol_block(d: torch.Tensor, *, inverse: bool = False,
               out: torch.Tensor | None = None):
    """``(L, L^{-1} or None)`` of the SPD blocks ``d [N, t, t]``; only the
    lower triangle of ``d`` is read, and ``L`` has zeros above the
    diagonal.  ``L`` goes into ``out`` when given (any ``[N, t, t]`` view
    with unit column stride, ``d`` itself included); ``L^{-1}`` is a new
    contiguous tensor."""
    if not dispatch.on_cuda(d):
        return chol_block_plain(d, inverse=inverse, out=out)
    _check_blocks(d, "chol_block")
    out, inv = _outputs(d, out, inverse)
    _check_blocks(out, "chol_block out")
    n, t = d.shape[0], d.shape[-1]
    if n == 0:
        return out, inv
    lib = _build.load("chol_block", _ENTRY_POINTS)
    with torch.cuda.device(d.device):
        _launch(lib, "gpvae_chol_block_f32",
                d.data_ptr(), d.stride(0), d.stride(1),
                out.data_ptr(), out.stride(0), out.stride(1),
                inv.data_ptr() if inverse else None, n, t)
    return out, inv


def gram_chol_block_plain(times, mask, ls, var, *, kernel: str = "rbf",
                          noise: float = kernels_lib.DEFAULT_NOISE,
                          inverse: bool = False, out=None):
    """Plain PyTorch version of :func:`gram_chol_block`: ``kernels.gram``
    then :func:`chol_block_plain`."""
    k = kernels_lib.gram(times, ls[:, None, None], kernel=kernel,
                         noise=noise, variance=var[:, None, None], mask=mask)
    return chol_block_plain(k, inverse=inverse, out=out)


def gram_chol_block(times: torch.Tensor, mask: torch.Tensor,
                    ls: torch.Tensor, var: torch.Tensor, *,
                    kernel: str = "rbf",
                    noise: float = kernels_lib.DEFAULT_NOISE,
                    inverse: bool = False,
                    out: torch.Tensor | None = None):
    """:func:`chol_block` of the masked gram built from a flat bank:
    ``times, mask [N, t]`` (float mask, 1 = observed; unit column stride),
    ``ls, var [N]`` (``kernels.gram`` semantics, masked rows and columns
    identity)."""
    if not dispatch.on_cuda(times):
        return gram_chol_block_plain(times, mask, ls, var, kernel=kernel,
                                     noise=noise, inverse=inverse, out=out)
    for x, name in ((times, "times"), (mask, "mask")):
        if (x.dim() != 2 or x.stride(1) != 1 or x.dtype != torch.float32
                or not x.is_cuda):
            raise ValueError(f"gram_chol_block {name}: expected a float32 "
                             f"CUDA [N, t] view with unit column stride")
    for x in (ls, var):
        dispatch.check_kernel_input(x, "gram_chol_block ls/var", 1)
    n, t = times.shape
    if mask.shape != (n, t) or mask.stride(0) != times.stride(0) or (
            ls.shape != (n,) or var.shape != (n,)):
        raise ValueError("gram_chol_block: inconsistent bank shapes")
    if kernel not in kernels_lib.KERNEL_CODES:
        raise ValueError(f"gram_chol_block: unknown kernel {kernel!r}")
    out, inv = _outputs(times, out, inverse)
    _check_blocks(out, "gram_chol_block out")
    if n == 0:
        return out, inv
    lib = _build.load("chol_block", _ENTRY_POINTS)
    with torch.cuda.device(times.device):
        _launch(lib, "gpvae_gram_chol_block_f32",
                times.data_ptr(), mask.data_ptr(), ls.data_ptr(),
                var.data_ptr(), times.stride(0),
                kernels_lib.KERNEL_CODES[kernel], float(noise),
                1.0 - float(noise), out.data_ptr(), out.stride(0),
                out.stride(1), inv.data_ptr() if inverse else None, n, t)
    return out, inv
