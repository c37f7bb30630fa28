"""Durbin test rows shared by the CPU and the card tests."""
import torch

from gpvae_tpu_torch import kernels
from gpvae_tpu_torch.ops import durbin


def clamped_rows(t, target=1.5, device="cpu"):
    """One row ``rho [1, T-1]`` whose last reflection coefficient comes
    out as ``target`` before its clamp (|target| > 1: clamped): the grid
    0 .. 60 at lengthscale 9, its last lag moved (``s[T-1]`` is linear in
    it, with slope 1)."""
    row = kernels.toeplitz_row(t, 60.0 / (t - 1), torch.tensor(
        [9.0], dtype=torch.float64), dtype=torch.float64)
    rho = (row[:, 1:] / row[:, :1]).clone()
    _, _, _, (steps, _) = durbin.durbin_plain(rho, save=True)
    num, den = steps[0, 1, -1], steps[0, 2, -1]
    rho[0, -1] = -target * den - (num - rho[0, -1])
    return rho.to(device)
