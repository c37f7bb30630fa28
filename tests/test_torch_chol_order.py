"""The summation order of ``csrc/chol_tile.cuh`` (the panel-blocked
Cholesky and inverse inside ``gram_chol.cu`` and ``chol_block.cu``),
emulated in float32 with plain PyTorch on the CPU and held against
float64: the accuracy of the kernels' arithmetic before any card runs it.

The emulation repeats the kernels' order, not their code: panels of
``NB`` = 16 columns; the diagonal tile right-looking column by column
(``d_j = rsqrt(a_jj)``, ``L[:, j] = a[:, j] d_j``, each update one fma);
each row below it substituted in column order; the trailing update's
``NB`` products summed by fma into a fresh total that is subtracted from
the entry once.  The inverse: each diagonal tile by substitution with the
same ``d_j``; then recursive doubling, blocks of side ``NB``, ``2 NB``,
``4 NB``, ... joined in pairs, ``X_21 = -X_22 (L_21 X_11)``, where
``Y[r][c] = sum_{u=c}^{cb+side-1} L[r][u] X[u][c]`` and ``Z[r][c] =
sum_{v=rb}^{r} X[r][v] Y[v][c]`` are each a fma chain in index order from
zero.  A float32 fma is the exact product and sum rounded once (through
float64, whose 53 bits hold a float32 product exactly).  The card's
``rsqrt.approx`` is within 2^-22.9 of the exact reciprocal square root,
the rounded value used here within half an ulp.

No JAX: the reference is ``torch.linalg.cholesky`` in float64 on the same
banks as ``chip_smoke.py`` phase 3 draws them (masked, noise 1e-3).
"""
import numpy as np
import pytest
import torch

from gpvae_tpu_torch import kernels

# the band of chip_smoke.py's check_l for a kernel that factors in its own
# order: the library's float32 error, twice; and its TRI_INV_REL_FRO
L_VS_LIBRARY = 2.0
X_REL_FRO = 1e-4
N = 16  # matrices per bank
NB = 16  # the kernels' panel width


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def panel_cholesky(k, nb=NB):
    """``(L, d)`` of the float32 bank ``k [N, t, t]`` (lower triangle
    read) in the order of ``chol_tile::factor``; ``d [N, t]`` holds each
    column's ``rsqrt`` pivot."""
    a = torch.tril(k).clone()
    n, t, _ = a.shape
    d = torch.empty((n, t), dtype=torch.float32)
    for c0 in range(0, t, nb):
        c1 = min(c0 + nb, t)
        for j in range(c0, c1):  # the diagonal tile, one warp
            dj = torch.rsqrt(a[:, j, j])
            d[:, j] = dj
            a[:, j:c1, j] = a[:, j:c1, j] * dj[:, None]
            lj = a[:, j + 1:c1, j]
            a[:, j + 1:c1, j + 1:c1] = _fma(-lj[:, :, None], lj[:, None, :],
                                            a[:, j + 1:c1, j + 1:c1])
        if c1 == t:
            break
        for j in range(c0, c1):  # the rows below, one a thread
            x = a[:, c1:, j] * d[:, j, None]
            a[:, c1:, j] = x
            a[:, c1:, j + 1:c1] = _fma(-x[:, :, None],
                                       a[:, None, j + 1:c1, j],
                                       a[:, c1:, j + 1:c1])
        acc = torch.zeros((n, t - c1, t - c1), dtype=torch.float32)
        for j in range(c0, c1):  # the trailing sum, then one subtraction
            col = a[:, c1:, j]
            acc = _fma(col[:, :, None], col[:, None, :], acc)
        a[:, c1:, c1:] = a[:, c1:, c1:] - acc
    return torch.tril(a), d


def panel_inverse(l, d, nb=NB):
    """``X = L^{-1}`` in the order of ``chol_tile::invert``."""
    n, t, _ = l.shape
    x = torch.zeros_like(l)
    for qb in range(0, t, nb):  # the diagonal tiles, lane c column c
        qe = min(t, qb + nb)
        acc = torch.eye(qe - qb).expand(n, -1, -1).clone()  # [N, m, c]
        for j in range(qb, qe):
            xj = acc[:, j - qb] * d[:, j, None]
            acc[:, j - qb] = xj
            acc[:, j - qb + 1:] = _fma(-l[:, j + 1:qe, j, None],
                                       xj[:, None, :], acc[:, j - qb + 1:])
        x[:, qb:qe, qb:qe] = torch.tril(acc)
    side = nb
    while side < t:  # a level joins pairs of blocks of side `side`
        for cb in range(0, t - side, 2 * side):
            rb, ce = cb + side, cb + side
            re = min(t, rb + side)
            # X is lower triangular with zeros above, so a term past the
            # kernel's bounds adds an exact zero to the chain
            y = torch.zeros((n, re - rb, side), dtype=torch.float32)
            for u in range(cb, ce):
                y = _fma(l[:, rb:re, u, None], x[:, u, None, cb:ce], y)
            z = torch.zeros_like(y)
            for v in range(rb, re):
                z = _fma(x[:, rb:re, v, None], y[:, v - rb, None, :], z)
            x[:, rb:re, cb:ce] = -z
        side *= 2
    return x


def _bank(seed, t):
    """A masked float64 gram bank drawn as chip_smoke.py's flat_inputs
    draws phase 3's."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (N, t)), axis=-1)
    mask = rng.random((N, t)) > rng.uniform(0.0, 0.7, (N, 1))
    mask[:, 0] = True
    ls = rng.uniform(1.0, 10.0, N)
    var = rng.uniform(0.5, 1.5, N)
    return kernels.gram(torch.tensor(times), torch.tensor(ls)[:, None, None],
                        variance=torch.tensor(var)[:, None, None],
                        mask=torch.tensor(mask))


def _errors(t):
    """The emulated factor's and inverse's errors on a phase-3 bank of side
    ``t``: ``(L err, the library's float32 L err, X rel. Frobenius)``."""
    k64 = _bank(t, t)
    ref = torch.linalg.cholesky(k64)
    l, d = panel_cholesky(k64.float())
    err = (l.double() - ref).abs().max().item()
    err_lib = (torch.linalg.cholesky(k64.float()).double()
               - ref).abs().max().item()
    # the inverse of that float32 factor, against its float64 inverse
    x = panel_inverse(l, d)
    xref = torch.linalg.inv(l.double())
    rel = (torch.linalg.matrix_norm(x.double() - xref)
           / torch.linalg.matrix_norm(xref)).max().item()
    assert bool((torch.triu(x, 1) == 0).all())
    return err, err_lib, rel


@pytest.mark.parametrize("t", [45, 64, 100, 127, 128])
def test_panel_order_is_as_accurate_as_the_library(t):
    err, err_lib, rel = _errors(t)
    assert err <= L_VS_LIBRARY * err_lib, (err, err_lib)
    assert rel <= X_REL_FRO


@pytest.mark.parametrize("t", [1, 17, 33, 45, 100])
def test_emulation_factors_and_inverts(t):
    """The emulated order is a factorization and an inverse, ragged last
    panels and doubling levels included: L L^T gives K and X L gives I
    to float32 rounding; the bank is left alone."""
    k64 = _bank(1, t)
    k = k64.float()
    k_copy = k.clone()
    l, d = panel_cholesky(k)
    l64 = l.double()
    assert (l64 @ l64.mT - k64).abs().max().item() <= 1e-5
    x = panel_inverse(l, d).double()
    eye = torch.eye(t, dtype=torch.float64)
    assert (x @ l64 - eye).abs().max().item() <= 1e-3
    assert torch.equal(k, k_copy)


if __name__ == "__main__":
    # the errors PERF.md cites:
    #   PYTHONPATH=. python tests/test_torch_chol_order.py
    for t in (45, 64, 100, 127, 128):
        err, err_lib, rel = _errors(t)
        print(f"t={t}: L err {err:.3e} = {err / err_lib:.2f}x the "
              f"library's float32 error; X rel. Frobenius {rel:.2e}")
