"""Structured covariance of uniform time grids: the Toeplitz path.

Counterpart of ``gpvae_tpu/toeplitz.py``.  On a uniform grid each
latent's gram is symmetric Toeplitz, described by its first row
(``kernels.toeplitz_row``), so the *prior* side of the long-sequence
model (BASELINE config 3, T=1024) needs no ``[Z, T, T]`` matrix:

* :func:`durbin_logdet` and :func:`durbin_gs_factors` -- the logdet and
  the Gohberg-Semencul inverse ``K^{-1} = (A A^T - B B^T) / e`` from one
  Durbin recursion in O(T^2) (``ops.durbin``: ``csrc/durbin.cu`` on a CUDA
  tensor, its plain version on the CPU, both in float64);
* :func:`tri_toeplitz_matvec` and :func:`tri_toeplitz_matvec_t` -- the
  triangular Toeplitz factors applied by FFT in O(T log T) a column;
* :func:`circulant_prior_sample` -- exact prior draws on the grid by
  circulant embedding, O(T log T).

The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX package leaves
them to XLA.
"""
from __future__ import annotations

import torch

from gpvae_tpu_torch.ops.durbin import durbin


def _durbin_rows(row: torch.Tensor):
    """``row [..., T]`` flattened to ``[N, T]`` in float64, and the
    recursion on its normalized form: ``(flat, sum_log_e, y, e)``, all
    float64 whatever ``row``'s dtype."""
    t = row.shape[-1]
    flat = row.reshape(-1, t).to(torch.float64)
    sum_log_e, y, e = durbin(flat[:, 1:] / flat[:, :1])
    return flat, sum_log_e, y, e


def durbin_logdet(row: torch.Tensor) -> torch.Tensor:
    """logdet of the symmetric positive definite Toeplitz matrices with
    first rows ``row [..., T]`` -> ``[...]`` in O(T^2)
    (``toeplitz.py:510-530``): ``T log r_0 + sum_k log E_k``, computed in
    float64 and returned in ``row``'s dtype."""
    batch, t = row.shape[:-1], row.shape[-1]
    flat, sum_log_e, _, _ = _durbin_rows(row)
    return (t * torch.log(flat[:, 0]) + sum_log_e).reshape(batch).to(
        row.dtype)


def durbin_gs_factors(row: torch.Tensor):
    """The logdet and the Gohberg-Semencul inverse of the symmetric
    positive definite Toeplitz matrices with first rows ``row [..., T]``
    (``toeplitz.py:544-586``): ``(logdet [...], a [..., T], b [..., T], e
    [...])`` with

        K^{-1} = (1/e) (A A^T - B B^T),

    ``A``, ``B`` the lower-triangular Toeplitz matrices of first columns
    ``a = (1, y)`` and ``b = (0, rev y)``, ``y`` the Yule-Walker solution
    and ``e`` the final unnormalized prediction error.  Computed in
    float64, returned in ``row``'s dtype."""
    batch, t = row.shape[:-1], row.shape[-1]
    flat, sum_log_e, y, e = _durbin_rows(row)
    r0 = flat[:, 0]
    logdet = t * torch.log(r0) + sum_log_e
    a = torch.cat([torch.ones_like(r0)[:, None], y], dim=1)
    b = torch.cat([torch.zeros_like(r0)[:, None], y.flip(-1)], dim=1)
    return tuple(v.to(row.dtype) for v in (
        logdet.reshape(batch), a.reshape(*batch, t), b.reshape(*batch, t),
        (r0 * e).reshape(batch)))


def tri_toeplitz(col: torch.Tensor) -> torch.Tensor:
    """Dense lower-triangular Toeplitz matrices ``[..., T, T]`` of first
    columns ``col [..., T]`` (``toeplitz.py:533-540``)."""
    t = col.shape[-1]
    idx = torch.arange(t, device=col.device)
    diff = idx[:, None] - idx[None, :]
    return torch.where(diff >= 0, col[..., diff.clamp(min=0)],
                       torch.zeros((), dtype=col.dtype, device=col.device))


def _fft_len(t: int) -> int:
    """The power-of-two FFT length >= 2T - 1 (``toeplitz.py:589-594``)."""
    m = 1
    while m < 2 * t - 1:
        m *= 2
    return m


def tri_toeplitz_matvec_t(col: torch.Tensor, y: torch.Tensor
                          ) -> torch.Tensor:
    """``A^T y`` for the lower-triangular Toeplitz ``A`` of first column
    ``col [Z, T]``, applied to ``y [..., Z, T, C]`` along T by FFT
    correlation (``toeplitz.py:597-618``): ``(A^T y)_i = sum_{j >= i}
    col_{j-i} y_j``, ``irfft(conj(rfft(col)) rfft(y))[:T]``."""
    t = col.shape[-1]
    m = _fft_len(t)
    fc = torch.conj(torch.fft.rfft(col, n=m, dim=-1))
    fy = torch.fft.rfft(y, n=m, dim=-2)
    out = torch.fft.irfft(fc[..., :, None] * fy, n=m, dim=-2)[..., :t, :]
    return out.to(y.dtype)


def tri_toeplitz_matvec(col: torch.Tensor, y: torch.Tensor
                        ) -> torch.Tensor:
    """``A y`` (a causal convolution) for the lower-triangular Toeplitz
    ``A`` of first column ``col [Z, T]``, ``y [..., Z, T, C]``
    (``toeplitz.py:621-632``)."""
    t = col.shape[-1]
    m = _fft_len(t)
    fc = torch.fft.rfft(col, n=m, dim=-1)
    fy = torch.fft.rfft(y, n=m, dim=-2)
    out = torch.fft.irfft(fc[..., :, None] * fy, n=m, dim=-2)[..., :t, :]
    return out.to(y.dtype)


def circulant_prior_sample(row: torch.Tensor, num_samples: int = 1, *,
                           eps: torch.Tensor | None = None,
                           generator: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Exact stationary GP draws on a uniform grid in O(T log T)
    (``toeplitz.py:636-667``): the Toeplitz grams of first rows ``row [Z,
    T]`` embedded in circulants of size ``M = 2(T-1)``, whose FFT
    eigenvalues (negative ones clamped to 0) filter white noise ``eps [S,
    Z, M]`` -- given, or drawn from ``generator`` on ``row``'s device.
    Returns ``[S, Z, T]``."""
    z, t = row.shape
    m = 2 * (t - 1)
    circ = torch.cat([row, row[:, 1:-1].flip(-1)], dim=-1)   # [Z, M]
    lam = torch.fft.rfft(circ, dim=-1).real.clamp(min=0.0)
    shape = (num_samples, z, m)
    if eps is None:
        eps = torch.randn(shape, generator=generator, dtype=row.dtype,
                          device=row.device)
    elif tuple(eps.shape) != shape:
        raise ValueError(f"eps must be {shape}, got {tuple(eps.shape)}")
    spec = torch.fft.rfft(eps, dim=-1)
    filtered = spec * torch.sqrt(lam / m)[None]
    draw = torch.fft.irfft(filtered, n=m, dim=-1) * (m ** 0.5)
    return draw[..., :t]
