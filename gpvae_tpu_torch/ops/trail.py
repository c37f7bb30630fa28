"""One step of the right-looking blocked Cholesky over a bank: the panel
times the diagonal block's explicit inverse, and the trailing downdate,
``csrc/gram_panel.cu`` (``trail_panel``, ``trail_update``).

Counterpart of the TPU kernel B23, ``gpvae_tpu/ops/pallas_trail.py:53``
``_make_kernel`` (``panel_trailing_update`` :100, ``pl.pallas_call``
:125).  For ``L [N, T, T]`` with its diagonal block ``Ld = L[:, o:o+nb,
o:o+nb]`` factored (``nb`` in {64, 128}) and ``Ld^{-1}`` given:

* :func:`trail_panel`: ``X = L[:, o+nb:, o:o+nb] Ld^{-T}`` in place, and
  zeros into the mirrored strictly upper tile ``L[:, o:o+nb, o+nb:]``;
* :func:`trail_update`: ``L[:, o+nb:, o+nb:] -= X X^T`` in place, on the
  lower-triangular 64 x 64 tiles of that square only.  The lower triangle
  of the square lies in them; the tiles above them are left as they were.

The TPU kernel does both in one grid whose row tiles run in order and
keep each finished X tile in VMEM for the later tiles' downdates.  Blocks
on the card run in no order, so the two are two launches on one stream:
X is whole before the downdate reads it.  At the T=1024, N=128 middle
step (o=384) the lower triangle of the downdate needs 4.3 GFLOP, bound by
float32 operations (0.064 ms at the H100's 67 TFLOP/s), and X 1.1 GFLOP
against 104 MB (the panel read, X and the zero tile written), bound by
bytes (0.031 ms at 3.35 TB/s).  The downdate runs the panel's tile on
the tensor cores in 3xTF32, each float32 operand split into two TF32
parts (the TPU kernel's ``split_dot`` runs at HIGHEST: float32-accurate
passes of bf16 parts on its matrix unit); X, whose product with the
inverse cancels, is plain float32 FMA in a streaming kernel that holds
``Ld^{-1}``'s lower triangle in shared memory and skips its zero half.

The explicit inverse keeps the TPU kernel's contract; in float32 it costs
the factor 3-4x the library's error (``ops/blocked.py`` solves instead),
so ``cholesky(method="auto")`` never takes this route.

A CUDA tensor goes to the kernels; a CPU tensor to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch.ops import _build, dispatch

# the block widths the kernels take
WIDTHS = (64, 128)
# the side of the downdate's tiles: only the lower ones are computed
TILE = 64

# launches of the two kernels in this process (callers may reset them):
# lets a run show that its main path went through them
PANEL_LAUNCHES = 0
UPDATE_LAUNCHES = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRY_POINTS = {
    "gpvae_trail_panel_f32": [_P, _LL, _I, _P, _I, _I, _I, _I, _P],
    "gpvae_trail_update_f32": [_P, _LL, _I, _I, _I, _I, _I, _P],
}


def build() -> None:
    """Compile and load the kernels now (they are otherwise built on first
    use)."""
    _build.load("gram_panel", _ENTRY_POINTS)


def _check(l: torch.Tensor, o: int, nb: int) -> None:
    if not l.is_cuda:
        raise ValueError(f"trail: expected a CUDA tensor, got {l.device}")
    if l.dtype != torch.float32:
        raise TypeError(f"trail: the kernels take float32, got {l.dtype}")
    if l.dim() != 3 or l.shape[1] != l.shape[2]:
        raise ValueError(f"trail: expected L [N, T, T], got {tuple(l.shape)}")
    if l.stride(2) != 1 or l.stride(1) < l.shape[2]:
        raise ValueError(f"trail: rows of L must be unit-stride and apart, "
                         f"got strides {l.stride()}")
    if l.shape[0] > 65535:
        raise ValueError("trail: at most 65535 matrices a launch")
    if nb not in WIDTHS or o < 0 or o + nb > l.shape[1]:
        raise ValueError(f"trail: bad block o={o} nb={nb} T={l.shape[1]}")


def trail_panel_plain(l: torch.Tensor, inv: torch.Tensor, o: int) -> None:
    """Plain PyTorch version of :func:`trail_panel`, any dtype and
    device; it reads only the lower triangle of ``inv``, as the kernel
    does."""
    nb = inv.shape[-1]
    l[:, o + nb:, o:o + nb] = l[:, o + nb:, o:o + nb] @ inv.tril().mT
    l[:, o:o + nb, o + nb:] = 0.0


def trail_panel(l: torch.Tensor, inv: torch.Tensor, o: int) -> None:
    """``L[:, o+nb:, o:o+nb] <- L[:, o+nb:, o:o+nb] Ld^{-T}`` in place, with
    ``inv = Ld^{-1} [N, nb, nb]`` (contiguous; only its lower triangle is
    read, the inverse of a lower-triangular block being lower triangular),
    and zeros into ``L[:, o:o+nb, o+nb:]``."""
    global PANEL_LAUNCHES
    if not dispatch.on_cuda(l):
        trail_panel_plain(l, inv, o)
        return
    n, t, _ = l.shape
    nb = inv.shape[-1]
    _check(l, o, nb)
    dispatch.check_kernel_input(inv, "trail_panel Ld^-1", 3)
    if inv.shape != (n, nb, nb):
        raise ValueError(f"trail_panel: Ld^-1 must be {(n, nb, nb)}, got "
                         f"{tuple(inv.shape)}")
    if n == 0 or o + nb >= t:
        return
    lib = _build.load("gram_panel", _ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_trail_panel_f32(
            l.data_ptr(), l.stride(0), l.stride(1), inv.data_ptr(), o, nb, t,
            n, stream)
    _build.check_status(lib, status, "trail_panel")
    PANEL_LAUNCHES += 1


def trail_update_plain(l: torch.Tensor, o: int, nb: int) -> None:
    """Plain PyTorch version of :func:`trail_update`, any dtype and device;
    it downdates the whole square, the tiles above the lower ones too."""
    x = l[:, o + nb:, o:o + nb]
    l[:, o + nb:, o + nb:] -= x @ x.mT


def trail_update(l: torch.Tensor, o: int, nb: int) -> None:
    """``L[:, o+nb:, o+nb:] -= X X^T`` in place with ``X = L[:, o+nb:,
    o:o+nb]``, on the lower-triangular ``TILE`` x ``TILE`` tiles of the
    square."""
    global UPDATE_LAUNCHES
    if not dispatch.on_cuda(l):
        trail_update_plain(l, o, nb)
        return
    _check(l, o, nb)
    n, t, _ = l.shape
    if n == 0 or o + nb >= t:
        return
    lib = _build.load("gram_panel", _ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_trail_update_f32(
            l.data_ptr(), l.stride(0), l.stride(1), o, nb, t, n, stream)
    _build.check_status(lib, status, "trail_update")
    UPDATE_LAUNCHES += 1


def lower_tiles(side: int, device=None) -> torch.Tensor:
    """``[side, side]`` bool: the lower-triangular ``TILE`` x ``TILE``
    tiles, where :func:`trail_update` defines its result.  They hold the
    lower triangle, and lie inside the TPU kernel's lower ``nb``-block
    triangle."""
    b = torch.arange(side, device=device) // TILE
    return b[None, :] <= b[:, None]


def panel_trailing_update(s: torch.Tensor, ld_inv: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``pallas_trail.panel_trailing_update``: ``s [N, R,
    R]`` the current trailing submatrix (its diagonal block factored or
    not: only the panel ``s[:, nb:, :nb]`` and the lower tiles of ``s[:,
    nb:, nb:]`` are read), ``ld_inv [N, nb, nb]`` the inverse of its
    factored diagonal block, lower triangular: only its lower triangle is
    read, where the JAX function multiplies by the whole of it.  Returns
    ``(col_x [N, R-nb, nb], s_new [N, R-nb, R-nb])``, views of one copy of
    ``s``; ``s_new`` is defined on :func:`lower_tiles` only.  ``R > nb``;
    the JAX function also wants ``R % nb == 0``."""
    nb = ld_inv.shape[-1]
    if s.dim() != 3 or s.shape[1] != s.shape[2] or s.shape[1] <= nb:
        raise ValueError(f"panel_trailing_update: s must be [N, R, R] with "
                         f"R > {nb}, got {tuple(s.shape)}")
    work = s.clone(memory_format=torch.contiguous_format)
    trail_panel(work, ld_inv.contiguous(), 0)
    trail_update(work, 0, nb)
    return work[:, nb:, :nb], work[:, nb:, nb:]
