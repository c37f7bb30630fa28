"""The Durbin recursion of symmetric positive definite Toeplitz matrices.

Counterpart of ``gpvae_tpu/toeplitz.py:88-117`` and ``:386-507`` (the
``lax.scan`` and the blocked Schur/Durbin behind ``_durbin_flat``): from
normalized autocovariances ``rho [N, T-1]`` (a first row over its first
entry) it returns ``sum_k log E_k [N]``, the Yule-Walker solution ``y
[N, T-1]`` and the final prediction error ``E_{T-1} [N]``, from which
``toeplitz.durbin_logdet`` and ``toeplitz.durbin_gs_factors`` build the
logdet and the Gohberg-Semencul inverse.

Both routes run the split Schur-Levinson form of ``toeplitz.py:386-417``
in float64 whatever the input's dtype: a CUDA tensor goes to
``csrc/durbin.cu`` (one thread block a matrix, the whole chain of T - 1
steps in one launch, T <= 4096), a CPU tensor to :func:`durbin_plain`,
whose autograd gives the gradient with respect to ``rho``.  The kernel
is forward only: a CUDA tensor that requires a gradient raises (ROADMAP
A7c).  In float64 the TPU's float32 workarounds (compensated products,
the blocked schedule, its switches) have nothing to do.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gpvae_tpu_torch.ops import _build, dispatch

# the kernel's largest T (256 threads of at most 16 lags each)
MAX_T = 4096
# launches of csrc/durbin.cu's recursion in this process (callers may
# reset it): lets a run show that its main path went through the kernel
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {
    "gpvae_durbin_f64": [_P, _I, _I, _P, _P, _P, _P],
    "gpvae_durbin_chain_f64": [_I, _I, _P, _P],
}


def build() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    use)."""
    _build.load("durbin", _ENTRY_POINTS)


def clamp_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """A reflection coefficient clamped 8 ulps of its dtype inside the
    positive definite region (-1, 1) (``toeplitz.py:71-85``): the
    identity for every coefficient a positive definite matrix gives, a
    guard against rounding past 1 that would NaN the logs."""
    lim = 1.0 - 8 * torch.finfo(alpha.dtype).eps
    return torch.clamp(alpha, -lim, lim)


def durbin_plain(rho: torch.Tensor):
    """Plain PyTorch version, in ``rho``'s dtype and differentiable:
    ``rho [N, T-1]`` -> ``(sum_log_e [N], y [N, T-1], e [N])``.

    The Szego pair ``a, b`` and its rho-images ``s, t`` advance together,
    ``x = (s, a)`` and ``z = (t, b)``: ``x' = x + alpha Z z``, ``z' = Z z +
    alpha x``, with ``alpha_k = -s[k] / t[k-1]`` and ``log E_k`` summed as
    ``log1p(-alpha^2)``: the kernel's arithmetic, step for step."""
    n, t1 = rho.shape
    one = torch.ones((n, 1), dtype=rho.dtype, device=rho.device)
    rho_full = torch.cat([one, rho], dim=-1)                  # [N, T]
    unit = F.pad(one, (0, t1))                                # e_0
    x = torch.stack([rho_full, unit])                         # (s, a)
    z = x
    log_e = torch.zeros(n, dtype=rho.dtype, device=rho.device)
    acc = log_e
    for k in range(1, t1 + 1):
        alpha = clamp_alpha(-x[0, :, k] / z[0, :, k - 1])
        al = alpha[None, :, None]
        zz = F.pad(z[..., :-1], (1, 0))                       # Z z
        x, z = x + al * zz, zz + al * x
        log_e = log_e + torch.log1p(-alpha * alpha)
        acc = acc + log_e
    return acc, x[1, :, 1:], torch.exp(log_e)


def durbin_cuda(rho: torch.Tensor):
    """Launch ``csrc/durbin.cu`` on ``rho [N, T-1]`` (float64, contiguous,
    CUDA, T <= ``MAX_T``) on the current stream; returns ``(sum_log_e
    [N], y [N, T-1], e [N])``, float64."""
    global LAUNCHES
    if not rho.is_cuda:
        raise ValueError(f"durbin: expected a CUDA tensor, got {rho.device}")
    if rho.dtype != torch.float64:
        raise TypeError(f"durbin: the kernel takes float64, got {rho.dtype}")
    if rho.dim() != 2 or not rho.is_contiguous():
        raise ValueError(f"durbin: expected a contiguous [N, T-1] tensor, "
                         f"got shape {tuple(rho.shape)}")
    n, t1 = rho.shape
    if t1 + 1 > MAX_T:
        raise ValueError(f"durbin: the kernel takes T <= {MAX_T}, got "
                         f"T={t1 + 1}")
    opts = dict(dtype=torch.float64, device=rho.device)
    sum_log_e, y, e = (torch.empty(n, **opts), torch.empty(n, t1, **opts),
                       torch.empty(n, **opts))
    if n == 0:
        return sum_log_e, y, e
    lib = _build.load("durbin", _ENTRY_POINTS)
    with torch.cuda.device(rho.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_durbin_f64(rho.data_ptr(), n, t1,
                                      sum_log_e.data_ptr(), y.data_ptr(),
                                      e.data_ptr(), stream)
    _build.check_status(lib, status, "durbin")
    LAUNCHES += 1
    return sum_log_e, y, e


def chain_floor_cuda(n: int, t: int, device) -> torch.Tensor:
    """Launch the kernel's chain alone (``durbin_chain_kernel``: the same
    T - 1 barriers and broadcasts at the same block size, no arithmetic)
    over ``n`` blocks: the floor of the recursion's time on the card.  Not
    counted in ``LAUNCHES``."""
    out = torch.empty(n, dtype=torch.float64, device=device)
    lib = _build.load("durbin", _ENTRY_POINTS)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gpvae_durbin_chain_f64(n, t - 1, out.data_ptr(), stream)
    _build.check_status(lib, status, "durbin chain")
    return out


def durbin(rho: torch.Tensor):
    """The recursion on ``rho [N, T-1]`` in float64 (whatever ``rho``'s
    dtype; the results are float64): ``csrc/durbin.cu`` on a CUDA tensor,
    which must not require a gradient, :func:`durbin_plain` on a CPU
    tensor."""
    rho = rho.to(torch.float64)
    if not dispatch.on_cuda(rho):
        return durbin_plain(rho)
    if rho.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "durbin: the CUDA kernel is forward only; a gradient with "
            "respect to the Toeplitz row (a learnable Toeplitz prior) is "
            "ROADMAP A7c")
    return durbin_cuda(rho.contiguous())
