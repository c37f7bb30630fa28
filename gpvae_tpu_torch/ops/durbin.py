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
``csrc/durbin.cu`` through :class:`DurbinFunction`, whose backward is the
kernel's reverse; up to T = 4096 one thread block a matrix runs the whole
chain of T - 1 steps in one launch (``durbin_bwd_kernel`` likewise),
above it the long route advances a window of 32 steps a launch over
tiles of lags spread across the card (two launches a window in reverse),
with no cap on T but the scratch it allocates; a CPU tensor goes to
:func:`durbin_plain`, whose autograd gives the gradient with respect to
``rho``.  In float64 the TPU's float32 workarounds (compensated
products, the blocked schedule, its switches) have nothing to do.

The reverse needs the state before each step.  The forward keeps, when a
gradient is needed, each step's reflection coefficient, its numerator
and denominator and the top lag of ``t`` (``steps [N, 4, T-1]``), and the
inputs of its last step (``last [N, 2, T]``); the reverse starts there
and walks every other step back by its inverse,

    x = (x' - alpha z') / (1 - alpha^2),   Z z = (z' - alpha x') / (1 - alpha^2).

It divides by ``1 - alpha^2`` at every step, yet on one lag pair a lag
(see :func:`durbin_bwd_plain`) its gradient stays within 2.3e-12 of
float64 autograd at the model's noise 1e-3, the near-singular T=4096 rows
included; at noise 1e-6 one of them drifts to 5.1e-7, where exact states
give 6.9e-10 (``python3 durbin_probe.py accuracy``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gpvae_tpu_torch.ops import _build, dispatch

# calls that launched csrc/durbin.cu's recursion and its reverse in this
# process, and the kernels those calls launched, as the C code counts them
# at each launch (one a call up to T = 4096; above it a window's kernels
# and the finishing ones): callers may reset them, to show that a main
# path went through the kernels
LAUNCHES = 0
BWD_LAUNCHES = 0
KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {
    "gpvae_durbin_f64": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "gpvae_durbin_bwd_f64": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "gpvae_durbin_work_f64": [_I, _I, _I, _P],
    "gpvae_durbin_launched": [_I],
    "gpvae_durbin_chain_f64": [_I, _I, _P, _P],
    "gpvae_durbin_bwd_chain_f64": [_I, _I, _P, _P],
}


def build() -> None:
    """Compile and load the kernels now (they are otherwise built on first
    use)."""
    _build.load("durbin", _ENTRY_POINTS)


def clamp_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """A reflection coefficient clamped 8 ulps of its dtype inside the
    positive definite region (-1, 1) (``toeplitz.py:71-85``): the
    identity for every coefficient a positive definite matrix gives, a
    guard against rounding past 1 that would NaN the logs."""
    lim = 1.0 - 8 * torch.finfo(alpha.dtype).eps
    return torch.clamp(alpha, -lim, lim)


def durbin_plain(rho: torch.Tensor, save: bool = False):
    """Plain PyTorch version, in ``rho``'s dtype and differentiable:
    ``rho [N, T-1]`` -> ``(sum_log_e [N], y [N, T-1], e [N])``, and with
    ``save`` also what the reverse needs, ``(steps, last)`` (detached;
    see :func:`durbin_bwd_plain`).

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
    if save:
        steps = rho.new_empty(n, 4, t1)
        last = rho.new_zeros(n, 2, t1 + 1)
    for k in range(1, t1 + 1):
        num, den = x[0, :, k], z[0, :, k - 1]
        alpha = clamp_alpha(-num / den)
        al = alpha[None, :, None]
        zz = F.pad(z[..., :-1], (1, 0))                       # Z z
        if save:
            with torch.no_grad():
                steps[:, :, k - 1] = torch.stack(
                    [alpha, num, den, z[0, :, t1]], dim=-1)
                if k == t1:  # its inputs (a, Z b): lags <= k, all of them
                    last[:, 0], last[:, 1] = x[1], zz[1]
        x, z = x + al * zz, zz + al * x
        log_e = log_e + torch.log1p(-alpha * alpha)
        acc = acc + log_e
    out = (acc, x[1, :, 1:], torch.exp(log_e))
    return (*out, (steps, last)) if save else out


def durbin_bwd_plain(steps: torch.Tensor, last: torch.Tensor,
                     g_sum_log_e: torch.Tensor | None,
                     g_y: torch.Tensor | None,
                     g_e: torch.Tensor | None,
                     states=None) -> torch.Tensor:
    """Plain version of ``durbin_bwd_kernel``, the same reverse arithmetic
    step for step: the gradient ``[N, T-1]`` with respect to ``rho`` of
    ``sum_log_e . g_sum_log_e + y . g_y + e . g_e`` (a ``None`` cotangent
    is zero), from what the forward kept (``durbin_plain(rho, save=True)``
    or :func:`durbin_cuda` with ``save``): ``steps [N, 4, T-1]`` (each
    step k's ``alpha_k``, its numerator ``s[k]``, its denominator
    ``t[k-1]`` and ``t[T-1]``, all before the step) and ``last [N, 2, T]``
    (the last step's inputs ``(X, W)``).

    Each lag holds one pair: before step k, ``(a, b)`` at lags below k
    (above them ``a`` and ``b`` are zero) and ``(s, t)`` from lag k up
    (below it ``s`` and ``t`` are rounding noise); their cotangents live
    on the same lags, but for one more, ``t``'s at lag k - 1 (``extra``).
    Reverse step k, from the state after it: the inputs ``(x, w = Z z)``
    by the inverse step (``last`` at the last step), then

        abar_k = sum_m (xbar'[m] w[m] + zbar'[m] x[m]) + extra s[k]
                 - 2 alpha_k / (1 - alpha_k^2) ((T - k) S_bar + e_bar e),
        xbar = xbar' + alpha zbar',   wbar = zbar' + alpha xbar',
        zbar[m] = wbar[m + 1],

    and, where alpha_k was not clamped, ``g = abar_k / t[k-1]`` enters
    ``sbar[k] -= g`` and ``tbar[k-1] -= g alpha_k`` (through ``s[k] = -
    alpha_k t[k-1]``); at the end ``rho_bar[j] = sbar[j] + tbar[j]``.

    ``states``, if given, is a function of k returning step k's inputs
    ``(X, W)`` ``[N, T]`` each, which it uses instead of the inverse step:
    the same reverse with states taken from elsewhere (``durbin_probe.py
    accuracy`` feeds it the forward's exact ones)."""
    alpha, num, den, top = steps.unbind(1)
    n, t1 = alpha.shape
    t = t1 + 1
    opts = dict(dtype=steps.dtype, device=steps.device)
    lim = 1.0 - 8 * torch.finfo(steps.dtype).eps
    raw = -num / den
    passes = (raw >= -lim) & (raw <= lim)
    rden = torch.where(passes, 1.0 / den, torch.zeros_like(den))
    inv = 1.0 / (1.0 - alpha * alpha)
    e = torch.exp(torch.log1p(-alpha * alpha).sum(-1))
    g_s = torch.zeros(n, **opts) if g_sum_log_e is None else g_sum_log_e
    g_ee = torch.zeros(n, **opts) if g_e is None else g_e * e
    weight = t - torch.arange(1, t, **opts)                   # T - k
    coef = -2.0 * alpha * inv * (weight * g_s[:, None] + g_ee[:, None])
    x = z = torch.zeros(n, t, **opts)
    xb = torch.zeros(n, t, **opts)
    if g_y is not None:
        xb[:, 1:] = g_y
    zb = torch.zeros(n, t, **opts)
    extra = torch.zeros(n, **opts)
    zero = torch.zeros(n, 1, **opts)
    for k in range(t1, 0, -1):
        j = k - 1
        al = alpha[:, j:j + 1]
        if states is not None:
            xi, w = states(k)
        elif k == t1:
            xi, w = last.unbind(1)
        else:
            iv = inv[:, j:j + 1]
            xi, w = (x - al * z) * iv, (z - al * x) * iv
        abar = ((xb * w + zb * xi).sum(-1) + extra * num[:, j]
                + coef[:, j])
        g = abar * rden[:, j]
        xb_in, wb = xb + al * zb, zb + al * xb
        x = torch.cat([xi[:, :k], num[:, j:j + 1], xi[:, k + 1:]], dim=1)
        z = torch.cat([w[:, 1:], top[:, j:j + 1]], dim=1)
        xb = torch.cat([xb_in[:, :k], (al[:, 0] * extra - g)[:, None],
                        xb_in[:, k + 1:]], dim=1)
        zb = torch.cat([wb[:, 1:], zero], dim=1)
        extra = extra - g * al[:, 0]
    return xb[:, 1:] + zb[:, 1:]


def _check_rows(rho: torch.Tensor, what: str) -> None:
    if not rho.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {rho.device}")
    if rho.dtype != torch.float64:
        raise TypeError(f"{what}: the kernel takes float64, got {rho.dtype}")
    if rho.dim() != 2 or not rho.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous [N, T-1] tensor, "
                         f"got shape {tuple(rho.shape)}")


def _work(lib, n: int, t1: int, bwd: bool, device) -> torch.Tensor | None:
    """The float64 scratch the kernels need at ``n``, ``t1`` (the long
    route's states, cotangents and partial sums; none up to T = 4096)."""
    count = ctypes.c_longlong(0)
    _build.check_status(lib, lib.gpvae_durbin_work_f64(
        n, t1, int(bwd), ctypes.addressof(count)), "durbin scratch")
    if not count.value:
        return None
    return torch.empty(count.value, dtype=torch.float64, device=device)


def durbin_cuda(rho: torch.Tensor, save: bool = False):
    """Launch ``csrc/durbin.cu`` on ``rho [N, T-1]`` (float64, contiguous,
    CUDA) on the current stream; returns ``(sum_log_e [N], y [N, T-1], e
    [N])``, float64, and with ``save`` also ``(steps, last)`` for
    :func:`durbin_bwd_cuda`."""
    global LAUNCHES, KERNEL_LAUNCHES
    _check_rows(rho, "durbin")
    n, t1 = rho.shape
    opts = dict(dtype=torch.float64, device=rho.device)
    sum_log_e, y, e = (torch.empty(n, **opts), torch.empty(n, t1, **opts),
                       torch.empty(n, **opts))
    steps = torch.empty(n, 4, t1, **opts) if save else None
    last = torch.empty(n, 2, t1 + 1, **opts) if save else None
    if n:
        lib = _build.load("durbin", _ENTRY_POINTS)
        work = _work(lib, n, t1, False, rho.device)
        before = lib.gpvae_durbin_launched(0)
        with torch.cuda.device(rho.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.gpvae_durbin_f64(
                rho.data_ptr(), n, t1, sum_log_e.data_ptr(), y.data_ptr(),
                e.data_ptr(), steps.data_ptr() if save else None,
                last.data_ptr() if save else None,
                None if work is None else work.data_ptr(), stream)
        _build.check_status(lib, status, "durbin")
        LAUNCHES += 1
        KERNEL_LAUNCHES += (lib.gpvae_durbin_launched(0) - before) % 2**32
    return (sum_log_e, y, e, (steps, last)) if save else (sum_log_e, y, e)


def durbin_bwd_cuda(steps: torch.Tensor, last: torch.Tensor,
                    g_sum_log_e: torch.Tensor | None,
                    g_y: torch.Tensor | None,
                    g_e: torch.Tensor | None) -> torch.Tensor:
    """Launch ``durbin_bwd_kernel`` of ``csrc/durbin.cu``: the gradient
    ``[N, T-1]`` with respect to ``rho``, as :func:`durbin_bwd_plain`
    computes it, from the forward's ``(steps, last)`` (float64, CUDA) and
    the cotangents (``None``: zero)."""
    global BWD_LAUNCHES, BWD_KERNEL_LAUNCHES
    if not steps.is_cuda:
        raise ValueError(f"durbin_bwd: expected CUDA tensors, got "
                         f"{steps.device}")
    n, _, t1 = steps.shape
    want = {"steps": (steps, (n, 4, t1)), "last": (last, (n, 2, t1 + 1))}
    for name, g, shape in (("g_sum_log_e", g_sum_log_e, (n,)),
                           ("g_y", g_y, (n, t1)), ("g_e", g_e, (n,))):
        if g is not None:
            want[name] = (g, shape)
    for name, (v, shape) in want.items():
        if v.device != steps.device or v.dtype != torch.float64:
            raise TypeError(f"durbin_bwd: {name} must be float64 on "
                            f"{steps.device}, got {v.dtype} on {v.device}")
        if tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"durbin_bwd: {name} must be a contiguous "
                             f"{shape}, got {tuple(v.shape)}")
    g_rho = torch.empty(n, t1, dtype=torch.float64, device=steps.device)
    if n:
        lib = _build.load("durbin", _ENTRY_POINTS)
        work = _work(lib, n, t1, True, steps.device)
        before = lib.gpvae_durbin_launched(1)

        def ptr(v):
            return None if v is None else v.data_ptr()

        with torch.cuda.device(steps.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.gpvae_durbin_bwd_f64(
                steps.data_ptr(), last.data_ptr(), ptr(g_sum_log_e),
                ptr(g_y), ptr(g_e), n, t1, g_rho.data_ptr(), ptr(work),
                stream)
        _build.check_status(lib, status, "durbin_bwd")
        BWD_LAUNCHES += 1
        BWD_KERNEL_LAUNCHES += (lib.gpvae_durbin_launched(1) - before) % 2**32
    return g_rho


def _chain(entry: str, n: int, t: int, device) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.float64, device=device)
    lib = _build.load("durbin", _ENTRY_POINTS)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(n, t - 1, out.data_ptr(), stream)
    _build.check_status(lib, status, entry)
    return out


def chain_floor_cuda(n: int, t: int, device) -> torch.Tensor:
    """Launch the forward's chain alone over ``n`` matrices: up to T = 4096
    ``durbin_chain_kernel`` (the same T - 1 barriers and broadcasts at the
    same block size, no arithmetic), above it the long route's launches
    with each window's front and tile steps as dependent shuffles and no
    arithmetic (``durbin_window_chain_kernel``): the floor of the
    recursion's time on the card.  Not counted in ``LAUNCHES``."""
    return _chain("gpvae_durbin_chain_f64", n, t, device)


def bwd_chain_floor_cuda(n: int, t: int, device) -> torch.Tensor:
    """Launch the reverse's chain alone over ``n`` matrices: up to T = 4096
    ``durbin_bwd_chain_kernel`` (the same T - 1 warp reductions, barriers
    and sums of the warps' parts at the same block size, no other
    arithmetic), above it the long route's two launches a window with
    each step a warp reduction and a shuffle.  Not counted in
    ``BWD_LAUNCHES``."""
    return _chain("gpvae_durbin_bwd_chain_f64", n, t, device)


class DurbinFunction(torch.autograd.Function):
    """:func:`durbin_cuda` with :func:`durbin_bwd_cuda` as its backward:
    the forward keeps ``(steps, last)`` only when ``rho`` needs a
    gradient; an output that no loss reaches passes its cotangent as
    ``None`` (the kernel reads no zeros for it)."""

    @staticmethod
    def forward(ctx, rho):
        ctx.set_materialize_grads(False)
        if ctx.needs_input_grad[0]:
            sum_log_e, y, e, saved = durbin_cuda(rho, save=True)
            ctx.save_for_backward(*saved)
        else:
            sum_log_e, y, e = durbin_cuda(rho)
        return sum_log_e, y, e

    @staticmethod
    @once_differentiable
    def backward(ctx, g_sum_log_e, g_y, g_e):
        if g_sum_log_e is None and g_y is None and g_e is None:
            return None
        steps, last = ctx.saved_tensors
        return durbin_bwd_cuda(
            steps, last, *(None if g is None else g.contiguous()
                           for g in (g_sum_log_e, g_y, g_e)))


def durbin(rho: torch.Tensor):
    """The recursion on ``rho [N, T-1]`` in float64 (whatever ``rho``'s
    dtype; the results are float64): ``csrc/durbin.cu`` on a CUDA tensor
    (its reverse kernel for the gradient), :func:`durbin_plain` on a CPU
    tensor."""
    rho = rho.to(torch.float64)
    if not dispatch.on_cuda(rho):
        return durbin_plain(rho)
    return DurbinFunction.apply(rho.contiguous())
