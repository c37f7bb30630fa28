"""Blocked in-place Cholesky for large T: of a gram built in-kernel, and of
a pre-built gram bank, left-looking or right-looking.

Counterpart of ``gpvae_tpu/ops/pallas_big.py:1126-1253``
(``cholesky_gram_inplace``, ``_nb_for_t``) and ``:1256-1317``
(``cholesky_inplace``), of the JAX package's 64 < T < 768 route
``chol.cholesky_blocked_left_streamed`` (``chol.py:338-392``), and of what
their kernels compute: ``_gram_tile`` :489 and the TPU kernels B7, B9-B12
and B14-B21 (ROADMAP queue B).  ``L [N, T, T]`` is factored left-looking
in column blocks of ``NB`` = 128.  Per block column ``b`` at offset ``o``
and width ``w``:

* the panel ``L[:, o:, o:o+w] = K[:, o:, o:o+w] - L[:, o:, :o]
  L[:, o:o+w, :o]^T``: ``gram_panel`` (``csrc/gram_panel.cu``) with each
  ``K`` tile built from the ``O(N T)`` time vectors, so the ``[N, T, T]``
  gram never exists in device memory; ``hist_panel`` (the same tile) with
  ``K`` read from a pre-built bank, which it never writes;
* ``chol_block`` (``csrc/chol_block.cu``): the diagonal block of the
  panel factored in place;
* ``panel_solve`` (``csrc/panel_solve.cu``): the rows below it,
  ``L[:, o+w:, o:o+w] = P L_d^{-T}``, solved in place against that block
  (the TPU multiplies by the block's explicit inverse instead, which in
  float32 costs about twice the factor error), and zeros into the
  mirrored strictly upper tile.

With the gram built in-kernel, block 0 is factored straight from the time
vectors (``chol_block`` in its gram mode) and its panel has no history;
from a pre-built bank, block 0's panel is a copy of K's first column
block.  The last block may be narrower than ``NB``; nothing is padded
(the JAX drivers pad with identity).  ``L`` comes from ``torch.empty`` and
every element of it is written by one of the three kernels, the strict
upper triangle as exact zeros.

:func:`cholesky_blocked_fused` is the right-looking order of
``cholesky(method="blocked_fused")``: per block, ``chol_block`` with the
inverse, then ``ops.trail``'s panel product and trailing downdate.

A CUDA tensor goes to the kernels; a CPU tensor takes the same block loop
with each kernel's plain version, so the CPU tests exercise its indexing
too.
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops import _build, chol_block, dispatch, trail

# The block width: the widest diagonal block one thread block holds in
# shared memory.  (The JAX package takes 128 or 256 and clamps to 128 above
# T=2048 for its VMEM budget, pallas_big._nb_for_t :1244.)
NB = chol_block.MAX_T

# launches of gram_panel and hist_panel (csrc/gram_panel.cu) and of
# panel_solve (csrc/panel_solve.cu) in this process (callers may reset
# them): lets a run show that its main path went through them
PANEL_LAUNCHES = 0
SOLVE_LAUNCHES = 0
HIST_LAUNCHES = 0

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ENTRY_POINTS = {
    "gpvae_gram_panel_f32": [_P, _LL, _I, _P, _P, _P, _P, _I, _I, _F, _F,
                             _I, _I, _I, _I, _I, _P],
    "gpvae_hist_panel_f32": [_P, _LL, _I, _P, _LL, _I, _I, _I, _I, _I, _I,
                             _P],
}
_SOLVE_ENTRY_POINTS = {
    "gpvae_panel_solve_f32": [_P, _LL, _I, _I, _I, _I, _I, _P],
}


def build() -> None:
    """Compile and load the kernels now (they are otherwise built on first
    use)."""
    _build.load("gram_panel", _ENTRY_POINTS)
    _build.load("panel_solve", _SOLVE_ENTRY_POINTS)


def gram_tile(times, mask, ls, var, rows: slice, cols: slice, *,
              kernel: str = "rbf",
              noise: float = kernels_lib.DEFAULT_NOISE) -> torch.Tensor:
    """``K[:, rows, cols]`` of the masked gram bank of ``times, mask
    [N, T]`` (float mask) and ``ls, var [N]``, ``kernels.gram`` semantics:
    the identity terms sit where the global row equals the global column
    (``pallas_big._gram_tile`` :489)."""
    kfn = kernels_lib.get_kernel(kernel)
    tr, tc = times[:, rows], times[:, cols]
    mr, mc = mask[:, rows], mask[:, cols]
    r = torch.arange(times.shape[1], device=times.device)
    eye = (r[rows][:, None] == r[cols][None, :]).to(times.dtype)
    k = var[:, None, None] * kfn(tr[:, :, None] - tc[:, None, :],
                                 ls[:, None, None])
    k = (1.0 - noise) * k + noise * eye
    return k * (mr[:, :, None] * mc[:, None, :]) + (1.0 - mr[:, :, None]) * eye


def _check_factor(l: torch.Tensor) -> None:
    dispatch.check_kernel_input(l, "blocked L", 3)
    if l.shape[0] > 65535:
        raise ValueError("blocked: at most 65535 matrices a launch")


def gram_panel_plain(l, times, mask, ls, var, r0: int, o: int, w: int, *,
                     kernel: str = "rbf",
                     noise: float = kernels_lib.DEFAULT_NOISE) -> None:
    """Plain PyTorch version of :func:`gram_panel`, any dtype and
    device."""
    p = gram_tile(times, mask, ls, var, slice(r0, l.shape[1]),
                  slice(o, o + w), kernel=kernel, noise=noise)
    if o:
        p = p - l[:, r0:, :o] @ l[:, o:o + w, :o].mT
    l[:, r0:, o:o + w] = p


def gram_panel(l, times, mask, ls, var, r0: int, o: int, w: int, *,
               kernel: str = "rbf",
               noise: float = kernels_lib.DEFAULT_NOISE) -> None:
    """``L[:, r0:, o:o+w] = K[:, r0:, o:o+w] - L[:, r0:, :o]
    L[:, o:o+w, :o]^T`` in place (``r0 >= o``)."""
    global PANEL_LAUNCHES
    n, t, _ = l.shape
    if not dispatch.on_cuda(l):
        gram_panel_plain(l, times, mask, ls, var, r0, o, w, kernel=kernel,
                         noise=noise)
        return
    _check_factor(l)
    for x in (times, mask):
        dispatch.check_kernel_input(x, "gram_panel times/mask", 2)
    for x in (ls, var):
        dispatch.check_kernel_input(x, "gram_panel ls/var", 1)
    if times.shape != (n, t) or mask.shape != (n, t) or ls.shape != (n,) \
            or var.shape != (n,):
        raise ValueError("gram_panel: inconsistent bank shapes")
    if n == 0 or r0 >= t:
        return
    lib = _build.load("gram_panel", _ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_gram_panel_f32(
            l.data_ptr(), l.stride(0), l.stride(1), times.data_ptr(),
            mask.data_ptr(), ls.data_ptr(), var.data_ptr(), t,
            kernels_lib.KERNEL_CODES[kernel], float(noise),
            1.0 - float(noise), r0, o, w, t, n, stream)
    _build.check_status(lib, status, "gram_panel")
    PANEL_LAUNCHES += 1


def hist_panel_plain(l: torch.Tensor, k: torch.Tensor, r0: int, o: int,
                     w: int) -> None:
    """Plain PyTorch version of :func:`hist_panel`, any dtype and
    device."""
    p = k[:, r0:, o:o + w]
    if o:
        p = p - l[:, r0:, :o] @ l[:, o:o + w, :o].mT
    l[:, r0:, o:o + w] = p


def hist_panel(l: torch.Tensor, k: torch.Tensor, r0: int, o: int,
               w: int) -> None:
    """``L[:, r0:, o:o+w] = K[:, r0:, o:o+w] - L[:, r0:, :o]
    L[:, o:o+w, :o]^T`` in place (``r0 >= o``), with ``K [N, T, T]`` a
    pre-built bank read at its own matrix and row strides (unit column
    stride) and never written."""
    global HIST_LAUNCHES
    n, t, _ = l.shape
    if not dispatch.on_cuda(l):
        hist_panel_plain(l, k, r0, o, w)
        return
    _check_factor(l)
    if not k.is_cuda or k.dtype != torch.float32:
        raise TypeError(f"hist_panel: K must be float32 on CUDA, got "
                        f"{k.dtype} on {k.device}")
    if k.shape != l.shape or k.stride(2) != 1 or k.stride(1) < t:
        raise ValueError(f"hist_panel: K must be {tuple(l.shape)} with "
                         f"unit-stride rows apart, got {tuple(k.shape)} at "
                         f"strides {k.stride()}")
    if not 0 <= o <= r0 or w < 1 or o + w > t:
        raise ValueError(f"hist_panel: bad block r0={r0} o={o} w={w} T={t}")
    if n == 0 or r0 >= t:
        return
    lib = _build.load("gram_panel", _ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_hist_panel_f32(
            l.data_ptr(), l.stride(0), l.stride(1), k.data_ptr(),
            k.stride(0), k.stride(1), r0, o, w, t, n, stream)
    _build.check_status(lib, status, "hist_panel")
    HIST_LAUNCHES += 1


def panel_solve_plain(l: torch.Tensor, o: int, w: int) -> None:
    """Plain PyTorch version of :func:`panel_solve`, any dtype and
    device."""
    d = l[:, o:o + w, o:o + w]
    l[:, o + w:, o:o + w] = torch.linalg.solve_triangular(
        d.mT, l[:, o + w:, o:o + w], upper=True, left=False)
    l[:, o:o + w, o + w:] = 0.0


def panel_solve(l: torch.Tensor, o: int, w: int) -> None:
    """``L[:, o+w:, o:o+w] <- L[:, o+w:, o:o+w] L_d^{-T}`` in place, by
    substitution against the factored diagonal block ``L_d = L[:, o:o+w,
    o:o+w]``, and zeros into ``L[:, o:o+w, o+w:]``."""
    global SOLVE_LAUNCHES
    n, t, _ = l.shape
    if not dispatch.on_cuda(l):
        panel_solve_plain(l, o, w)
        return
    _check_factor(l)
    if w > chol_block.MAX_T:
        raise ValueError(f"panel_solve: w <= {chol_block.MAX_T}, got {w}")
    if n == 0 or o + w >= t:
        return
    lib = _build.load("panel_solve", _SOLVE_ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_panel_solve_f32(
            l.data_ptr(), l.stride(0), l.stride(1), o, w, t, n, stream)
    _build.check_status(lib, status, "panel_solve")
    SOLVE_LAUNCHES += 1


def cholesky_gram_inplace(
    times: torch.Tensor,
    lengthscales: torch.Tensor,
    mask: torch.Tensor | None,
    variance: torch.Tensor,
    kernel: str = "rbf",
    noise: float = kernels_lib.DEFAULT_NOISE,
) -> torch.Tensor:
    """``L [N, T, T]`` of the masked gram bank of ``times [N, T]``,
    ``lengthscales [N]``, ``mask [N, T]`` bool or None and ``variance
    [N]``, in the dtype of ``times`` (float32 on CUDA)."""
    n, t = times.shape
    dtype, dev = times.dtype, times.device
    times = times.contiguous()
    mk = (torch.ones((n, t), dtype=dtype, device=dev) if mask is None
          else mask.to(dtype).contiguous())
    ls = lengthscales.to(dtype).reshape(n).contiguous()
    var = torch.as_tensor(variance, dtype=dtype, device=dev).expand(
        n).contiguous()
    l = torch.empty((n, t, t), dtype=dtype, device=dev)
    gram = dict(kernel=kernel, noise=noise)
    w = min(NB, t)
    chol_block.gram_chol_block(times[:, :w], mk[:, :w], ls, var,
                               out=l[:, :w, :w], **gram)
    if w < t:
        gram_panel(l, times, mk, ls, var, w, 0, w, **gram)
        panel_solve(l, 0, w)
    for o in range(NB, t, NB):
        w = min(NB, t - o)
        gram_panel(l, times, mk, ls, var, o, o, w, **gram)
        d = l[:, o:o + w, o:o + w]
        chol_block.chol_block(d, out=d)
        if o + w < t:
            panel_solve(l, o, w)
    return l


def cholesky_inplace(k: torch.Tensor) -> torch.Tensor:
    """``L [N, T, T]`` of the pre-built SPD bank ``k [N, T, T]`` (any view
    with unit-stride rows; only its lower triangle enters ``L``, and it
    is never written), in the dtype of ``k`` (float32 on CUDA).  T <= ``NB``
    is one ``chol_block`` launch."""
    n, t, _ = k.shape
    l = torch.empty((n, t, t), dtype=k.dtype, device=k.device)
    if t <= NB:
        chol_block.chol_block(k, out=l)
        return l
    for o in range(0, t, NB):
        w = min(NB, t - o)
        hist_panel(l, k, o, o, w)
        d = l[:, o:o + w, o:o + w]
        chol_block.chol_block(d, out=d)
        if o + w < t:
            panel_solve(l, o, w)
    return l


def cholesky_blocked_fused(k: torch.Tensor,
                           block_size: int = NB) -> torch.Tensor:
    """``L [N, T, T]`` of the pre-built SPD bank ``k [N, T, T]``,
    right-looking: the counterpart of ``gpvae_tpu/ops/chol.py:395-439``
    (``cholesky(method="blocked_fused")``, ``block_size=64`` for
    ``"blocked_fused_64"``).

    ``k`` is copied into ``L`` (it is never written), and each step at
    column ``o`` works on ``L`` in place: ``chol_block`` factors the
    diagonal block and returns its inverse, ``trail.trail_panel`` turns
    the panel below it into ``X = P Ld^{-T}`` (zeros into the mirrored
    upper tile), and ``trail.trail_update`` downdates the lower tiles of
    the trailing square by ``X X^T``.  The last block, which may be
    narrower than ``block_size`` (nothing is padded; the JAX function pads
    with identity), is only factored.  Only the lower triangle of ``k``
    enters ``L``; its strict upper triangle is exact zeros.  T <=
    ``block_size`` is one ``chol_block`` launch."""
    if block_size not in trail.WIDTHS:
        raise ValueError(f"blocked_fused: block_size in {trail.WIDTHS}, "
                         f"got {block_size}")
    n, t, _ = k.shape
    l = torch.empty((n, t, t), dtype=k.dtype, device=k.device)
    if t <= block_size:
        chol_block.chol_block(k, out=l)
        return l
    l.copy_(k)
    for o in range(0, t, block_size):
        w = min(block_size, t - o)
        d = l[:, o:o + w, o:o + w]
        if o + w == t:
            chol_block.chol_block(d, out=d)
            break
        _, inv = chol_block.chol_block(d, inverse=True, out=d)
        trail.trail_panel(l, inv, o)
        trail.trail_update(l, o, w)
    return l
