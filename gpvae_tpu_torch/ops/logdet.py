"""Log-determinants from the Cholesky diagonal.

Counterpart of ``gpvae_tpu/ops/logdet.py:21-51`` and of
``pallas_big.diag_extract`` :271-292: ``logdet K = 2 sum log diag L``, no
determinant is ever formed.  Large factors (T >= 256, T % 128 == 0, a
[N] or [B, Z] batch of matrices: the JAX package's routing) go through
``csrc/diag_logdet.cu``, one thread block per matrix, which replaces the
TPU kernel ``pallas_big._diag_kernel`` and the log-sum after it; its
gradient puts ``2 g / L_ii`` on the diagonal (``pallas_big.py:290-292``).
Smaller ones, and every CPU tensor, take the plain strided diagonal.

The training step does not come here: ``gp._chol_gram_bank_logdet`` takes
the logdets of the whole stacked bank by :func:`diag_logdet` inside the
factorization's autograd node, and folds their gradient into its Cholesky
backward (``ops.chol.cholesky_bwd_from_l(logdet_bar=...)``), so no dense
diagonal ``L_bar`` is written.
"""
from __future__ import annotations

import ctypes

import torch

from gpvae_tpu_torch.ops import _build, dispatch
from gpvae_tpu_torch.ops.chol import cholesky

# launches of csrc/diag_logdet.cu in this process (callers may reset it):
# lets a run show that its main path went through the kernel
LAUNCHES = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRY_POINTS = {
    "gpvae_diag_logdet_f32": [_P, _LL, _LL, _I, _I, _I, _I, _P, _P],
}


def build() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    use)."""
    _build.load("diag_logdet", _ENTRY_POINTS)


def diag_logdet_plain(l: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``2 sum log diag L``, any dtype."""
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag), dim=-1)


def diag_logdet_cuda(l: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/diag_logdet.cu`` on ``l [N, T, T]`` or
    ``[N1, N2, T, T]`` (float32, CUDA, any view whose rows are
    unit-stride) on the current stream; returns ``[N]`` or ``[N1, N2]``."""
    global LAUNCHES
    if not l.is_cuda:
        raise ValueError(f"diag_logdet: expected a CUDA tensor, got "
                         f"{l.device}")
    if l.dtype != torch.float32:
        raise TypeError(f"diag_logdet: the kernel takes float32, got "
                        f"{l.dtype}")
    if l.dim() not in (3, 4) or l.shape[-1] != l.shape[-2]:
        raise ValueError(f"diag_logdet: expected [N, T, T] or "
                         f"[N1, N2, T, T], got {tuple(l.shape)}")
    if l.stride(-1) != 1:
        raise ValueError("diag_logdet: rows must be unit-stride")
    batch = l.shape[:-2]
    lv = l if l.dim() == 4 else l[:, None]
    n1, n2, t = lv.shape[0], lv.shape[1], lv.shape[-1]
    out = torch.empty(batch, dtype=torch.float32, device=l.device)
    if out.numel() == 0:
        return out
    lib = _build.load("diag_logdet", _ENTRY_POINTS)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_diag_logdet_f32(
            lv.data_ptr(), lv.stride(0), lv.stride(1), n1, n2, lv.stride(2),
            t, out.data_ptr(), stream)
    _build.check_status(lib, status, "diag_logdet")
    LAUNCHES += 1
    return out


def _takes_kernel(l: torch.Tensor) -> bool:
    """The factors whose diagonal the JAX package reads by its Pallas
    kernel (``gpvae_tpu/ops/logdet.py:30``), and the port by its own."""
    t = l.shape[-1]
    return t >= 256 and t % 128 == 0 and l.dim() in (3, 4)


def diag_logdet(l: torch.Tensor) -> torch.Tensor:
    """``2 sum log diag L``, the forward alone (no gradient rule: callers
    inside an ``autograd.Function`` supply their own):
    ``csrc/diag_logdet.cu`` on a CUDA tensor that :func:`logdet_from_chol`
    routes to the kernel, the plain version otherwise."""
    if _takes_kernel(l) and dispatch.on_cuda(l):
        return diag_logdet_cuda(l)
    return diag_logdet_plain(l)


class _DiagLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l):
        ctx.save_for_backward(l)
        return diag_logdet(l)

    @staticmethod
    def backward(ctx, g):
        (l,) = ctx.saved_tensors
        diag = torch.diagonal(l, dim1=-2, dim2=-1)
        return torch.diag_embed(2.0 * g[..., None] / diag)


def logdet_from_chol(l: torch.Tensor) -> torch.Tensor:
    """``logdet(K)`` for ``K = L L^T``; L ``[..., T, T]`` -> ``[...]``.

    Identity-padded (masked) rows have ``L_ii = 1`` and contribute 0.
    """
    if _takes_kernel(l):
        return _DiagLogdet.apply(l)
    return diag_logdet_plain(l)


def chol_logdet(k: torch.Tensor, *, method: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor SPD ``k [..., T, T]`` by ``cholesky(k, method=method)`` and
    return ``(L, logdet k)``."""
    l = cholesky(k, method=method)
    return l, logdet_from_chol(l)


def slogdet_psd(k: torch.Tensor, *, method: str = "auto") -> torch.Tensor:
    """``logdet`` of SPD ``k [..., T, T]`` through its Cholesky factor
    (``cholesky(k, method=method)``)."""
    return logdet_from_chol(cholesky(k, method=method))
