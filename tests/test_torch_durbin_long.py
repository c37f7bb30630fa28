"""The Durbin recursion past T = 4096, on the CPU.

* The port's CPU route (``ops.durbin.durbin_plain`` under
  ``toeplitz.durbin_gs_factors`` and ``durbin_logdet``) against the JAX
  package's scan at T in {4097, 4500} on the ``t1024_toeplitz`` prior's
  two rows (the CLI's grid 0 .. 60, lengthscales 9 and 3), in float64, to
  ``FP64_REL``.  JAX's blocked Schur/Durbin is switched off
  (``GPVAE_DURBIN_BLOCK=0``): it jits for minutes above T=512.
* The card's long route (``csrc/durbin.cu``'s windowed forward and
  reverse, above T = 4096 on the card) emulated on the CPU by
  ``tests/durbin_windows.py`` with its window and tile widths lowered, so
  that many windows and tiles, ragged last ones included, run at T <= 600:
  held against ``durbin_plain``, ``durbin_bwd_plain`` and the plain
  forward's autograd to ``SCHEDULE_REL``, on the preset's rows and on a
  row whose last coefficient clamps (``tests/durbin_rows.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import toeplitz as jtoeplitz
from gpvae_tpu_torch import kernels, toeplitz
from gpvae_tpu_torch.ops import durbin

import durbin_windows
from durbin_rows import clamped_rows

FP64_REL = 1e-9
# the schedule reorders the plain version's float64 sums (the tiles'
# partial sums of each abar_k, a window's steps split between tiles and
# front): rounding, far below the kernels' 1e-9 band
SCHEDULE_REL = 1e-10
# (T, steps a window, lags a tile): the kernel's widths at T=300, 10
# windows (the last of 11 steps) over tiles of 256 lags (the forward's:
# two tiles of 224 exact lags) or of 128 (the reverse's: 96 exact), and
# lowered widths: T=17 in windows of 4 over tiles of 8 exact lags, T=100 in
# 25 windows of 4 over 17 tiles of 6 (a ragged last one), T=600 in 38
# windows of 16 (the last of 7) over 13 tiles of 48 (the last of 24)
SCHEDULES = [(17, 4, 12), (100, 4, 10), (300, 32, 256), (300, 32, 128),
             (600, 16, 64)]


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _preset_rows(t):
    """``t1024_toeplitz``'s prior rows ``[2, T]`` on the CLI's grid 0 ..
    60 at T, float64."""
    return kernels.toeplitz_row(t, 60.0 / (t - 1), torch.tensor(
        [9.0, 3.0], dtype=torch.float64), dtype=torch.float64)


@pytest.mark.parametrize("t", [4097, 4500])
def test_durbin_past_4096_matches_jax_scan(t, monkeypatch):
    """``durbin_gs_factors`` (logdet, a, b, e) and ``durbin_logdet`` of
    the preset's rows past the card's one-block range, against JAX's
    scan."""
    monkeypatch.setenv("GPVAE_DURBIN_BLOCK", "0")
    row = _preset_rows(t)
    jrow = jnp.asarray(row.numpy())
    got = toeplitz.durbin_gs_factors(row)
    ref = jtoeplitz.durbin_gs_factors(jrow)
    for name, g, r in zip(("logdet", "a", "b", "e"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.float64
        assert _rel(g.numpy(), r) <= FP64_REL, name
    assert _rel(toeplitz.durbin_logdet(row).numpy(),
                jtoeplitz.durbin_logdet(jrow)) <= FP64_REL


def _rho(rows, t):
    if rows == "clamped":
        return clamped_rows(t)
    row = _preset_rows(t)
    return (row[:, 1:] / row[:, :1]).contiguous()


def _cotangents(n, t1, which, seed):
    gen = np.random.default_rng(seed)
    shapes = ((n,), (n, t1), (n,))
    return tuple(torch.tensor(gen.standard_normal(s)) if i in which else None
                 for i, s in enumerate(shapes))


@pytest.mark.parametrize("rows", ["preset", "clamped"])
@pytest.mark.parametrize("t,nb,span", SCHEDULES)
def test_long_route_schedule_matches_plain(t, nb, span, rows):
    """The windowed forward (every output and what it keeps for the
    reverse) against ``durbin_plain``; the windowed reverse, cotangents on
    all three outputs, against ``durbin_bwd_plain`` and autograd."""
    rho = _rho(rows, t)
    n, t1 = rho.shape
    *ref, (steps, last) = durbin.durbin_plain(rho, save=True)
    *got, (g_steps, g_last) = durbin_windows.forward(rho, nb, span,
                                                     save=True)
    for name, g, r in zip(("sum_log_e", "y", "e", "steps", "last"),
                          (*got, g_steps, g_last), (*ref, steps, last)):
        assert _rel(g.numpy(), r.numpy()) <= SCHEDULE_REL, name
    cot = _cotangents(n, t1, (0, 1, 2), seed=t)
    got = durbin_windows.backward(steps, last, *cot, nb, span)
    plain = durbin.durbin_bwd_plain(steps, last, *cot)
    r = rho.clone().requires_grad_(True)
    auto, = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(durbin.durbin_plain(r), cot)), r)
    assert _rel(got.numpy(), plain.numpy()) <= SCHEDULE_REL
    assert _rel(got.numpy(), auto.numpy()) <= SCHEDULE_REL


@pytest.mark.parametrize("which", [0, 1, 2])
def test_long_route_reverse_takes_each_output_alone(which):
    """A cotangent on one output, the others ``None``, at T=100 in windows
    of 4 over tiles of 6 exact lags."""
    rho = _rho("preset", 100)
    n, t1 = rho.shape
    *_, (steps, last) = durbin.durbin_plain(rho, save=True)
    cot = _cotangents(n, t1, (which,), seed=which)
    got = durbin_windows.backward(steps, last, *cot, 4, 10)
    ref = durbin.durbin_bwd_plain(steps, last, *cot)
    assert _rel(got.numpy(), ref.numpy()) <= SCHEDULE_REL
