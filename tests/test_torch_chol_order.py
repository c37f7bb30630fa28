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

The same for ``csrc/panel_solve.cu`` (the rows below a factored block,
``X = P L_d^{-T}``): per panel of 16 columns, each row substituted against
the panel's diagonal tile in column order with ``d_j = 1 / L_d[j][j]`` (a
float32 division) and ``x_j = a_j d_j``; then the columns to the right
updated by the panel's 16 products summed by fma into a fresh total that
is subtracted once.  And for ``csrc/tri_inv.cu``: a column sweep of a
given factor, ``x_j = acc_j d_j`` with ``d_j`` divided, then each row
below ``j`` one fma, step by step (``panel_inverse`` with one tile the
whole matrix): the order of the library's substitution, which it matches
to the bit, also on FITC's ill-conditioned factors, where the recursive
doubling of ``chol_tile::invert`` lost 25x the library's error.

The panel tile's history order (``csrc/gram_panel.cu``) is emulated by
``gpvae_tpu_torch.ops.split_emulation`` and held here on a near-low-rank
gram, where the order decides the factor's error.

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


def panel_solve_order(p, ld, nb=NB):
    """``X = P L_d^{-T}`` of float32 ``p [N, R, w]`` and the lower triangle
    of ``ld [N, w, w]`` in the order of ``panel_solve.cu``."""
    x = p.clone()
    w = ld.shape[-1]
    d = 1.0 / torch.diagonal(ld, dim1=-2, dim2=-1)  # IEEE float32 division
    for c0 in range(0, w, nb):
        c1 = min(c0 + nb, w)
        for j in range(c0, c1):  # (a) the panel, a row a thread
            xj = x[:, :, j] * d[:, j, None]
            x[:, :, j] = xj
            x[:, :, j + 1:c1] = _fma(-xj[:, :, None], ld[:, None, j + 1:c1, j],
                                     x[:, :, j + 1:c1])
        if c1 == w:
            break
        acc = torch.zeros_like(x[:, :, c1:])  # (b) summed, subtracted once
        for j in range(c0, c1):
            acc = _fma(x[:, :, j, None], ld[:, None, c1:, j], acc)
        x[:, :, c1:] = x[:, :, c1:] - acc
    return x


def _bank(seed, t, n=N):
    """A masked float64 gram bank drawn as chip_smoke.py's flat_inputs
    draws phase 3's."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (n, t)), axis=-1)
    mask = rng.random((n, t)) > rng.uniform(0.0, 0.7, (n, 1))
    mask[:, 0] = True
    ls = rng.uniform(1.0, 10.0, n)
    var = rng.uniform(0.5, 1.5, n)
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


def _solve_errors(t, o, w, n):
    """The emulated panel_solve's error and the library's float32
    ``solve_triangular``'s on the rows below block ``(o, w)`` of a phase-3
    bank's factorization, each against the float64 solve of the same
    float32 inputs: ``L_d`` the float64 factor's block, ``P`` the panel as
    the factorization hands it over, ``L[o+w:, o:o+w] L_d^T``."""
    l64 = torch.linalg.cholesky(_bank(t + w, t, n))
    d = l64[:, o:o + w, o:o + w]
    p = (l64[:, o + w:, o:o + w] @ d.mT).float()
    d = d.float()
    ref = torch.linalg.solve_triangular(d.double().mT, p.double(),
                                        upper=True, left=False)
    lib = torch.linalg.solve_triangular(d.mT, p, upper=True, left=False)
    got = panel_solve_order(p, d)
    return ((got.double() - ref).abs().max().item(),
            (lib.double() - ref).abs().max().item())


def sweep_inverse(l):
    """``X = L^{-1}`` in the order of ``tri_inv.cu``'s column sweep, with
    ``d_j = 1 / L[j][j]``."""
    d = 1.0 / torch.diagonal(l, dim1=-2, dim2=-1)
    return panel_inverse(l, d, nb=max(1, l.shape[-1]))


def _inverse_errors(l):
    """``(the sweep's X, the library's)`` rel. Frobenius error against the
    float64 inverse of the float32 factor ``l``."""
    x = sweep_inverse(l)
    assert bool((torch.triu(x, 1) == 0).all())
    lib = torch.linalg.solve_triangular(
        l, torch.eye(l.shape[-1]).expand_as(l), upper=False)
    xref = torch.linalg.inv(l.double())
    return tuple((torch.linalg.matrix_norm(y.double() - xref)
                  / torch.linalg.matrix_norm(xref)).max().item()
                 for y in (x, lib))


def _tri_inv_error(t):
    """``tri_inv.cu``'s inverse of a phase-3 factor (the emulated
    factorization's): rel. Frobenius error against the float64 inverse of
    the same float32 factor."""
    l, _ = panel_cholesky(_bank(2 * t, t).float())
    return _inverse_errors(l)[0]


def _fitc_factors(seed, b=2, z=4, m=64, t=4096):
    """The factors ``[b z, m, m]`` of FITC's ``K_mm + 1e-4 I`` and ``B = I
    + V0 V0^T`` as ``sparse_t4096`` builds them (64 inducing points over
    [0, 4096], lengthscales near its 256, a unit grid of T=4096), in
    float32 from float64 matrices."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64)
    s = torch.linspace(0.0, float(t), m, **f64)[None].expand(b, -1)
    times = torch.arange(t, **f64)[None].expand(b, -1)
    ls = torch.tensor(rng.uniform(128.0, 384.0, z), **f64)
    k_mm = kernels.cross_gram(s, s, ls) + 1e-4 * torch.eye(m, **f64)
    k_tm = kernels.cross_gram(times, s, ls)
    v = torch.linalg.solve_triangular(torch.linalg.cholesky(k_mm), k_tm.mT,
                                      upper=False)
    d = torch.clamp(0.999 - (v * v).sum(-2), min=0.0) + 1e-3
    v0 = v / torch.sqrt(d)[..., None, :]
    b_mat = torch.eye(m, **f64) + v0 @ v0.mT
    return [torch.linalg.cholesky(k.float()).reshape(-1, m, m)
            for k in (k_mm, b_mat)]


# (t, o, w, n): a T=256 and the T=1024 middle step at w=128, and a ragged w
SOLVE_CASES = [(256, 0, 128, N), (1024, 512, 128, 4), (256, 0, 100, N)]


@pytest.mark.parametrize("t,o,w,n", SOLVE_CASES)
def test_panel_solve_order_is_as_accurate_as_the_library(t, o, w, n):
    err, err_lib = _solve_errors(t, o, w, n)
    assert err <= L_VS_LIBRARY * err_lib, (err, err_lib)


@pytest.mark.parametrize("t", [1, 15, 16, 17, 45, 64])
def test_tri_inv_order_stays_in_its_band(t):
    assert _tri_inv_error(t) <= X_REL_FRO


@pytest.mark.parametrize("seed", [10, 11])
def test_tri_inv_order_on_fitc_factors_is_the_librarys(seed):
    """FITC's factors (cond(L_B) ~ 1e3): the sweep's error is the
    library's float32 substitution's, far inside the band."""
    for l in _fitc_factors(seed):
        err, err_lib = _inverse_errors(l)
        assert err <= 1.01 * err_lib and err <= X_REL_FRO / 10, (err,
                                                                 err_lib)


@pytest.mark.parametrize("t", [512, 768])
def test_panel_tile_order_on_a_near_low_rank_gram(t):
    """``gram_panel.cu``'s history order (its first 32 columns by fma,
    added last; the rest 3xTF32 from the last stage back) in the blocked
    factorization of a gram like ``sparse_t4096``'s evaluate's
    (lengthscale 256 over the toy grid 0..60, half the steps kept): under
    the library's float32 error, where the first-column-first order is
    above it (``ops.split_emulation``; at T=4096 its ``--t4096``)."""
    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch
    from gpvae_tpu_torch.ops import split_emulation as se

    batch = toy_to_masked_batch(generate_toy_data(np.random.default_rng(3),
                                                  1, t=t))
    kept = batch["mask"] & (np.random.default_rng(10).random((1, t)) >= 0.5)
    k64 = (kernels.gram_bank(torch.tensor(batch["times"], dtype=torch.float64),
                             torch.tensor([256.0], dtype=torch.float64),
                             mask=torch.tensor(kept))
           + 1e-5 * torch.eye(t, dtype=torch.float64)).reshape(1, t, t)
    l64 = torch.linalg.cholesky(k64).numpy()
    k32 = k64.float().numpy()
    err_lib = np.abs(torch.linalg.cholesky(torch.from_numpy(k32)).numpy()
                     - l64).max()
    errs = {order: np.abs(se.factor(k32, lambda a, b, order=order:
                                    se.product_3xtf32(a, b, order=order))
                          - l64).max() / err_lib
            for order in ("tile", "forward")}
    assert errs["tile"] < min(1.0, errs["forward"]), errs


# seeds of the kernel's arithmetic at T=256: 5 and 9 gave the largest W
# errors over ten seeds, 5 with its rounding every k-step (1.98x the FMA
# loop's), 9 with a stage's twelve products in one accumulator (3.06x)
@pytest.mark.parametrize("seed", [5, 9])
def test_chol_bwd_arithmetic_stays_within_twice_the_fma_loop(seed):
    """``csrc/chol_bwd.cu``'s arithmetic (``ops.split_emulation``'s
    ``kernel`` route: 3xTF32 stages first column first, W's sums rounded
    into the total every 8-deep k-step) at T=256, N=2: each pass's largest
    error from float64 within 2x the float32 FMA loop's, on the same
    float32 inputs."""
    from gpvae_tpu_torch.ops import split_emulation as se

    routes = {name: se.BACKWARD_ROUTES[name] for name in ("fma", "kernel")}
    ratio = se.backward_errors(seed, routes, t=256, n=2)["ratio"]["kernel"]
    assert all(ratio[p] <= 2.0 for p in ("w", "m", "k")), ratio


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
    for t, o, w, n in SOLVE_CASES:
        err, err_lib = _solve_errors(t, o, w, n)
        print(f"panel_solve T={t} o={o} w={w}: err {err:.3e} = "
              f"{err / err_lib:.2f}x the library's float32 error")
    for t in (1, 15, 16, 17, 45, 64):
        print(f"tri_inv t={t}: X rel. Frobenius {_tri_inv_error(t):.2e}")
    for name, l in zip(("K_mm", "B"), _fitc_factors(10)):
        err, err_lib = _inverse_errors(l)
        dbl = panel_inverse(l, 1.0 / torch.diagonal(l, dim1=-2, dim2=-1))
        xref = torch.linalg.inv(l.double())
        err_dbl = (torch.linalg.matrix_norm(dbl.double() - xref)
                   / torch.linalg.matrix_norm(xref)).max().item()
        print(f"tri_inv FITC {name}: sweep {err:.2e}, library {err_lib:.2e}"
              f", recursive doubling (chol_tile::invert) {err_dbl:.2e}")
