"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from gpvae_tpu_torch import configs, gp, kernels, sparse, toeplitz, train
from gpvae_tpu_torch.data import (
    Batcher, generate_toy_data, make_healing_batch, toy_to_masked_batch,
)
from gpvae_tpu_torch.models import GPVAE
from gpvae_tpu_torch.ops import (
    _build, blocked, chol, chol_block, chol_bwd, dispatch, durbin, gram_chol,
    logdet, trail, tri_inv, trsm,
)

from durbin_rows import clamped_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bank(card, seed, b, t, z=4):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    mask = rng.random((b, t)) > 0.3
    mask[:, 0] = True
    return (torch.tensor(times, dtype=torch.float32, device=card),
            torch.tensor(rng.uniform(1.0, 10.0, z), dtype=torch.float32,
                         device=card),
            torch.tensor(mask, device=card))


# sides on both sides of the kernels' panel widths (16 and 32)
PANEL_SIDES = [1, 15, 16, 17, 31, 32, 33, 45, 63, 64]


@pytest.mark.parametrize("kernel", sorted(kernels.KERNELS))
@pytest.mark.parametrize("t", sorted(set(PANEL_SIDES) | {8}))
def test_gram_chol_kernel_matches_plain(card, kernel, t):
    times, ls, mask = _bank(card, t, 20, t)
    before = gram_chol.LAUNCHES
    l = gram_chol.gram_chol_fused(times, ls, mask=mask, kernel=kernel)
    assert gram_chol.LAUNCHES == before + 1
    ref = gram_chol.gram_chol_plain(times.double(), ls.double(), mask=mask,
                                    kernel=kernel)
    lib = gram_chol.gram_chol_plain(times, ls, mask=mask, kernel=kernel)
    torch.cuda.synchronize()
    err = (l.double() - ref).abs().max().item()
    err_lib = (lib.double() - ref).abs().max().item()
    # 5e-5, or 4x the library's own float32 error (see chip_smoke.py)
    assert err <= max(5e-5, 4.0 * err_lib)
    assert torch.all(torch.triu(l, 1) == 0)


@pytest.mark.parametrize("t", [1, 8, 45, 64])
def test_tri_inv_kernel_matches_plain(card, t):
    times, ls, mask = _bank(card, 100 + t, 20, t)
    l = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(-1, t, t)
    before = tri_inv.LAUNCHES
    x = tri_inv.tri_inv(l)
    assert tri_inv.LAUNCHES == before + 1
    ref = tri_inv.tri_inv_plain(l.double())
    torch.cuda.synchronize()
    rel = (torch.linalg.matrix_norm(x.double() - ref)
           / torch.linalg.matrix_norm(ref)).max().item()
    assert rel <= 1e-4
    assert torch.all(torch.triu(x, 1) == 0)


@pytest.mark.parametrize("t", range(1, 65))
def test_tri_inv_kernel_at_every_side(card, t):
    """Every side the kernel takes: ragged diagonal tiles of 16 and every
    doubling level of csrc/chol_tile.cuh's inverse."""
    times, ls, mask = _bank(card, 200 + t, 20, t)
    l = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(-1, t, t)
    before = tri_inv.LAUNCHES
    x = tri_inv.tri_inv_cuda(l.contiguous())
    assert tri_inv.LAUNCHES == before + 1
    ref = tri_inv.tri_inv_plain(l.double())
    torch.cuda.synchronize()
    rel = (torch.linalg.matrix_norm(x.double() - ref)
           / torch.linalg.matrix_norm(ref)).max().item()
    assert rel <= 1e-4
    assert torch.all(torch.triu(x, 1) == 0)


def test_tri_inv_kernel_takes_the_flat_routes_base_call(card):
    """N = 1,024 matrices of 64, as the T=1024 flat route hands them over
    (the diagonal blocks of N=64 factors): several blocks an SM."""
    times, ls, mask = _bank(card, 13, 256, 64)
    l = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(-1, 64, 64)
    assert l.shape[0] == 1024
    x = tri_inv.tri_inv_cuda(l.contiguous())
    ref = tri_inv.tri_inv_plain(l.double())
    torch.cuda.synchronize()
    rel = (torch.linalg.matrix_norm(x.double() - ref)
           / torch.linalg.matrix_norm(ref)).max().item()
    assert rel <= 1e-4
    assert torch.all(torch.triu(x, 1) == 0)


@pytest.mark.parametrize("t", [17, 45, 64])
def test_tri_inv_kernel_reads_only_the_lower_triangle(card, t):
    """Noise above L's diagonal changes no bit of X."""
    times, ls, mask = _bank(card, 300 + t, 20, t)
    l = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(
        -1, t, t).contiguous()
    noise = torch.triu(torch.randn(l.shape, generator=torch.Generator()
                                   .manual_seed(t)), 1).to(card) * 10.0
    assert torch.equal(tri_inv.tri_inv_cuda(l + noise),
                       tri_inv.tri_inv_cuda(l))


def test_kernels_refuse_what_they_do_not_take(card):
    with pytest.raises(ValueError, match="T <= 64"):
        gram_chol.gram_chol_cuda(*gram_chol.flat_bank(
            torch.zeros((2, 65), device=card), torch.ones(2, device=card),
            None, 1.0))
    with pytest.raises(ValueError, match="T <= 64"):
        tri_inv.tri_inv_cuda(torch.eye(65, device=card)[None])
    with pytest.raises(ValueError, match="t <= 128"):
        chol_block.chol_block(torch.eye(129, device=card)[None])
    with pytest.raises(TypeError, match="float32"):
        tri_inv.tri_inv_cuda(torch.eye(4, dtype=torch.float64,
                                       device=card)[None])
    with pytest.raises(ValueError, match="contiguous"):
        tri_inv.tri_inv_cuda(torch.eye(4, device=card)[None].transpose(1, 2)
                             .expand(2, 4, 4))


def _flat(card, seed, n, t, noise_mask=0.3):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (n, t)), axis=-1)
    mask = rng.random((n, t)) > noise_mask
    mask[:, 0] = True
    f32 = dict(dtype=torch.float32, device=card)
    return (torch.tensor(times, **f32), torch.tensor(mask, **f32),
            torch.tensor(rng.uniform(2.0, 9.0, n), **f32),
            torch.tensor(rng.uniform(0.5, 1.5, n), **f32))


def _l_band(l, ref, lib):
    """max abs error of ``l`` against the float64 ``ref``, and its band:
    5e-5, or 4x the library's own float32 factor ``lib`` (chip_smoke.py)."""
    err = (l.double() - ref).abs().max().item()
    return err, max(5e-5, 4.0 * (lib.double() - ref).abs().max().item())


def _check_chol_block(times, mask, ls, var, gram, inverse):
    """One ``chol_block`` launch in either mode against float64: L in
    ``_l_band``, L^-1 within 1e-4 (rel. Frobenius) of the float64 inverse
    of that L, both exactly zero above the diagonal."""
    k = kernels.gram(times.double(), ls.double()[:, None, None],
                     variance=var.double()[:, None, None], mask=mask)
    before = chol_block.LAUNCHES
    if gram:
        l, x = chol_block.gram_chol_block(times, mask, ls, var,
                                          inverse=inverse)
    else:
        l, x = chol_block.chol_block(k.float(), inverse=inverse)
    assert chol_block.LAUNCHES == before + 1
    ref = torch.linalg.cholesky(k)
    err, band = _l_band(l, ref, torch.linalg.cholesky(k.float()))
    assert err <= band
    assert torch.all(torch.triu(l, 1) == 0)
    if not inverse:
        assert x is None
        return
    xref = tri_inv.tri_inv_plain(l.double())
    rel = (torch.linalg.matrix_norm(x.double() - xref)
           / torch.linalg.matrix_norm(xref)).max().item()
    assert rel <= 1e-4
    assert torch.all(torch.triu(x, 1) == 0)


@pytest.mark.parametrize("t", sorted(set(PANEL_SIDES)
                                     | {37, 65, 100, 127, 128}))
@pytest.mark.parametrize("gram", [True, False])
@pytest.mark.parametrize("inverse", [True, False])
def test_chol_block_matches_plain(card, t, gram, inverse):
    _check_chol_block(*_flat(card, t, 64, t), gram, inverse)


def test_kernels_take_more_than_one_wave(card):
    """N = 1024 matrices: nearly eight waves of the 132 SMs."""
    times, ls, mask = _bank(card, 11, 256, 45)
    l = gram_chol.gram_chol_fused(times, ls, mask=mask)
    ref = gram_chol.gram_chol_plain(times.double(), ls.double(), mask=mask)
    err, band = _l_band(l, ref, gram_chol.gram_chol_plain(times, ls,
                                                          mask=mask))
    assert l.shape == (256, 4, 45, 45) and err <= band
    for gram in (True, False):
        _check_chol_block(*_flat(card, 12, 1024, 128), gram, True)


@pytest.mark.parametrize("ls_shape", ["z", "bz"])
@pytest.mark.parametrize("masked", ["bool", "float", None])
@pytest.mark.parametrize("variance",
                         ["number", "scalar", "z", "one", "host_scalar"])
def test_gram_chol_takes_the_bank_as_given(card, ls_shape, masked,
                                           variance):
    """The kernel reads the arguments of gram_chol_fused where they lie:
    [Z] or [B, Z] lengthscales, a bool or float mask or none, the
    variance as a number, a 0-dim tensor (on the card or the host), [1]
    or [Z], and times at a row stride; one launch a call, matrix
    b * Z + z."""
    rng = np.random.default_rng(13)
    b, t, z = 6, 45, 3
    big = torch.zeros((b, 2 * t), device=card)
    big[:, ::2] = torch.tensor(np.sort(rng.uniform(0.0, 60.0, (b, t)), -1),
                               dtype=torch.float32, device=card)
    times = big[:, ::2]  # row stride 2 t, column stride 2
    mk = torch.tensor(rng.random((b, t)) > 0.3, device=card)
    mk[:, 0] = True
    mask = {"bool": mk, "float": mk.float(), None: None}[masked]
    shape = (z,) if ls_shape == "z" else (b, z)
    ls = torch.tensor(rng.uniform(1.0, 9.0, shape), dtype=torch.float32,
                      device=card)
    var = {"number": 1.3,
           "scalar": torch.tensor(0.7, device=card),
           "z": torch.tensor(rng.uniform(0.5, 1.5, z), dtype=torch.float32,
                             device=card),
           "one": torch.tensor([0.8], device=card),
           "host_scalar": torch.tensor(1.1)}[variance]
    before = gram_chol.LAUNCHES
    l = gram_chol.gram_chol_fused(times, ls, mask=mask, variance=var)
    assert gram_chol.LAUNCHES == before + 1
    var64 = var.double() if torch.is_tensor(var) else var
    mask64 = None if mask is None else mask.double() if masked == "float" \
        else mask
    ref = gram_chol.gram_chol_plain(times.double(), ls.double(),
                                    mask=mask64, variance=var64)
    lib = gram_chol.gram_chol_plain(times, ls, mask=mask, variance=var)
    err, band = _l_band(l, ref, lib)
    assert l.shape == (b, z, t, t) and err <= band
    assert torch.all(torch.triu(l, 1) == 0)


def test_chol_block_gives_nan_where_not_positive_definite(card):
    """A negative pivot at column 50 of one block: NaN from that column
    on, its earlier columns finite, zeros above the diagonal, and the
    other blocks untouched."""
    times, mask, ls, var = _flat(card, 14, 4, 100)
    k = kernels.gram(times, ls[:, None, None], variance=var[:, None, None],
                     mask=mask)
    k[2, 50, 50] = -1.0
    l, x = chol_block.chol_block(k, inverse=True)
    torch.cuda.synchronize()
    low = torch.tril(torch.ones(50, 50, dtype=torch.bool, device=card))
    assert torch.isnan(l[2, 50:, 50:][low]).all()
    assert torch.isfinite(l[2, :, :50]).all()
    assert torch.all(torch.triu(l[2], 1) == 0)
    assert torch.isfinite(l[[0, 1, 3]]).all()
    assert torch.isfinite(x[[0, 1, 3]]).all()


def test_chol_block_reads_and_writes_at_a_row_stride(card):
    times, mask, ls, var = _flat(card, 5, 8, 100)
    k = kernels.gram(times, ls[:, None, None], variance=var[:, None, None],
                     mask=mask)
    big = torch.full((8, 160, 160), float("nan"), device=card)
    big[:, 30:130, 20:120] = k
    d = big[:, 30:130, 20:120]
    l, _ = chol_block.chol_block(d, out=d)
    torch.cuda.synchronize()
    assert l.data_ptr() == d.data_ptr()
    err, band = _l_band(l, torch.linalg.cholesky(k.double()),
                        torch.linalg.cholesky(k))
    assert err <= band
    outside = big.clone()
    outside[:, 30:130, 20:120] = float("nan")
    assert torch.isnan(outside).all()  # nothing written outside the block


@pytest.mark.parametrize("t", [100, 256, 300, 384, 520])
def test_blocked_factorization_matches_plain(card, t):
    times, mask, ls, var = _flat(card, t, 16, t)
    before = (chol_block.LAUNCHES, blocked.PANEL_LAUNCHES,
              blocked.SOLVE_LAUNCHES)
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    blocks = -(-t // blocked.NB)
    assert (chol_block.LAUNCHES - before[0], blocked.PANEL_LAUNCHES
            - before[1], blocked.SOLVE_LAUNCHES - before[2]) == (
                blocks, blocks - 1 + (blocks > 1), blocks - 1)
    k = kernels.gram(times.double(), ls.double()[:, None, None],
                     variance=var.double()[:, None, None], mask=mask)
    err, band = _l_band(l, torch.linalg.cholesky(k),
                        torch.linalg.cholesky(k.float()))
    assert err <= band
    assert torch.all(torch.triu(l, 1) == 0)


@pytest.mark.parametrize("t,o", [(320, 128), (300, 128), (1000, 256),
                                 (1023, 256)])
def test_panel_kernels_match_plain(card, t, o):
    """A whole row tile, ragged ones (300, 1000), and rows of L that are
    not 16-byte aligned (1023: the kernels' 4-byte copies); the history
    scaled to the depth so that a panel entry stays of the size of the
    o = 128 case."""
    w, n = 128, 8
    times, mask, ls, var = _flat(card, 9, n, t)
    rng = np.random.default_rng(3)
    l0 = torch.tensor(rng.standard_normal((n, t, t)) * np.sqrt(128 / o),
                      dtype=torch.float32, device=card)
    got, ref = l0.clone(), l0.double()
    blocked.gram_panel(got, times, mask, ls, var, o, o, w)
    blocked.gram_panel_plain(ref, times.double(), mask.double(),
                             ls.double(), var.double(), o, o, w)
    torch.cuda.synchronize()
    assert (got.double() - ref).abs().max().item() <= 1e-4
    # a well-conditioned lower diagonal block at [o, o+w)^2
    d = torch.tensor(np.tril(rng.standard_normal((n, w, w))) * 0.1
                     + 2.0 * np.eye(w), dtype=torch.float32, device=card)
    l0[:, o:o + w, o:o + w] = d
    got, ref = l0.clone(), l0.double()
    blocked.panel_solve(got, o, w)
    blocked.panel_solve_plain(ref, o, w)
    torch.cuda.synchronize()
    assert (got.double() - ref).abs().max().item() <= 1e-4
    assert torch.all(got[:, o:o + w, o + w:] == 0)


def _panel_case(card, seed, n, t, o, w):
    """``L [n, t, t]`` float32 holding, at block column ``(o, w)``, a
    factored diagonal block and the panel below it as the blocked
    factorization hands them over: ``L_d`` of a masked gram's float64
    factor, and ``P = L[o+w:, o:o+w] L_d^T``, whose solve is that factor's
    rows.  The rest of ``L`` is standard normal noise."""
    times, mask, ls, var = _flat(card, seed, n, t)
    k = kernels.gram(times.double(), ls.double()[:, None, None],
                     variance=var.double()[:, None, None], mask=mask)
    l64 = torch.linalg.cholesky(k)
    rng = np.random.default_rng(seed)
    l = torch.tensor(rng.standard_normal((n, t, t)), dtype=torch.float64,
                     device=card)
    d = l64[:, o:o + w, o:o + w]
    l[:, o:o + w, o:o + w] = d
    l[:, o + w:, o:o + w] = l64[:, o + w:, o:o + w] @ d.mT
    return l.float().contiguous()


def _panel_solve_at(view, o, w):
    """The kernel on a view of L at its own matrix and row strides (the
    wrapper takes contiguous banks only)."""
    lib = _build.load("panel_solve", blocked._SOLVE_ENTRY_POINTS)
    status = lib.gpvae_panel_solve_f32(
        view.data_ptr(), view.stride(0), view.stride(1), o, w,
        view.shape[1], view.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check_status(lib, status, "panel_solve")


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("o", [0, 3])
@pytest.mark.parametrize("w", [1, 16, 100, 128])
def test_panel_solve_matches_plain(card, n, o, w):
    """Widths from 1 to 128 (ragged last panels of 16), rows that are not
    16-byte aligned (o = 3: the kernel's 4-byte copies), 200 rows below
    the block (no multiple of a row tile), at the training path's N=128
    and evaluate's N=64; against the plain version in float64 on the same
    inputs, the zero tile exactly zero, and nothing else written."""
    t = o + w + 200
    l = _panel_case(card, 7 * w + o + n, n, t, o, w)
    got, ref = l.clone(), l.double()
    before = blocked.SOLVE_LAUNCHES
    blocked.panel_solve(got, o, w)
    assert blocked.SOLVE_LAUNCHES == before + 1
    blocked.panel_solve_plain(ref, o, w)
    torch.cuda.synchronize()
    assert (got.double() - ref).abs().max().item() <= 1e-4
    assert torch.all(got[:, o:o + w, o + w:] == 0)
    keep = torch.ones_like(l, dtype=torch.bool)
    keep[:, o + w:, o:o + w] = False
    keep[:, o:o + w, o + w:] = False
    assert torch.equal(got[keep], l[keep])


@pytest.mark.parametrize("col", [4, 5])
def test_panel_solve_works_in_place_at_a_row_stride(card, col):
    """L a view inside a larger buffer (matrix stride != t * t), its rows
    16-byte aligned (column offset 4) or not (5): the same bits as on a
    contiguous L, and nothing written outside the view."""
    n, t, o, w = 64, 300, 128, 128
    l = _panel_case(card, 21, n, t, o, w)
    want = l.clone()
    blocked.panel_solve(want, o, w)
    big = torch.full((n, t + 6, t + 16), float("nan"), device=card)
    big[:, 3:t + 3, col:t + col] = l
    view = big[:, 3:t + 3, col:t + col]
    assert view.stride(0) != t * t
    _panel_solve_at(view, o, w)
    torch.cuda.synchronize()
    assert torch.equal(view, want)
    outside = big.clone()
    outside[:, 3:t + 3, col:t + col] = float("nan")
    assert torch.isnan(outside).all()


@pytest.mark.parametrize("w", [100, 128])
def test_panel_solve_reads_only_the_lower_triangle(card, w):
    """Noise in L's strict upper triangle, L_d's included, changes no bit
    of the result; the zero tile becomes zeros and the rest of the upper
    triangle stays as it was."""
    n, t, o = 64, 400, 128
    l = torch.tril(_panel_case(card, 5, n, t, o, w))
    noisy = l + torch.triu(torch.randn(
        l.shape, generator=torch.Generator().manual_seed(w)), 1).to(card)
    got, want = noisy.clone(), l.clone()
    blocked.panel_solve(got, o, w)
    blocked.panel_solve(want, o, w)
    torch.cuda.synchronize()
    lower = torch.ones(t, t, dtype=torch.bool, device=card).tril()
    zero = torch.zeros_like(lower)
    zero[o:o + w, o + w:] = True
    assert torch.equal(got[:, lower], want[:, lower])
    assert torch.all(got[:, zero] == 0)
    upper = ~lower & ~zero
    assert torch.equal(got[:, upper], noisy[:, upper])


def test_diag_logdet_matches_plain(card):
    times, mask, ls, var = _flat(card, 11, 16, 256)
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var).reshape(
        4, 4, 256, 256)
    for view in (l.reshape(16, 256, 256), l[:, 2:]):
        before = logdet.LAUNCHES
        got = logdet.logdet_from_chol(view)
        assert logdet.LAUNCHES == before + 1
        ref = logdet.diag_logdet_plain(view.double())
        assert (got.double() - ref).abs().max().item() <= 1e-5 * (
            1.0 + ref.abs().max().item())
    g = torch.randn(4, 2, device=card)
    lv = l[:, 2:].clone().requires_grad_(True)
    logdet.logdet_from_chol(lv).backward(g)
    want = torch.diag_embed(2.0 * g[..., None] / torch.diagonal(
        lv.detach(), dim1=-2, dim2=-1))
    torch.testing.assert_close(lv.grad, want)


# sides of diag_logdet's cases: one element, less than a warp, its block
# of 256 threads and one more, the training bank's T, and past its 256 x 8
# register batch
DIAG_SIDES = [1, 31, 256, 257, 1024, 1500, 2049]


@pytest.mark.parametrize("view", ["bank", "half"])
@pytest.mark.parametrize("n", [1, 64, 128, 300])
@pytest.mark.parametrize("t", DIAG_SIDES)
def test_diag_logdet_kernel_at_every_shape(card, t, n, view):
    """The kernel against its plain version in float64, on a bank of n
    matrices and on the strided half of a 2n bank, whose entries off the
    diagonal are NaN: the kernel reads the diagonal alone."""
    shape = (n, t, t) if view == "bank" else (n, 2, t, t)
    bank = torch.full(shape, float("nan"), device=card)
    rng = np.random.default_rng(t + n)
    diag = torch.tensor(np.exp(rng.uniform(-3.0, 3.0, shape[:-1])),
                        dtype=torch.float32, device=card)
    bank.diagonal(dim1=-2, dim2=-1).copy_(diag)
    l = bank if view == "bank" else bank[:, 1:]
    before = logdet.LAUNCHES
    got = logdet.diag_logdet_cuda(l)
    assert logdet.LAUNCHES == before + 1
    assert got.shape == l.shape[:-2]
    ref = logdet.diag_logdet_plain(l.double())
    terms = 2.0 * torch.diagonal(l, dim1=-2, dim2=-1).double().log().abs(
        ).sum(-1)
    err = (got.double() - ref).abs()
    assert torch.all(err <= 1e-6 * (1.0 + terms)), err.max().item()
    del bank


def test_elbo_launches_diag_logdet_once_a_forward(card):
    """At T=256 the ELBO takes both halves' logdets from one launch over
    the stacked bank, and its backward launches none; ``sample_posterior``
    alone launches none."""
    t, b = 256, 4
    cfg = dataclasses.replace(configs.get("bench_t100").model, time_len=t)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0)).to(card)
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(1),
                                                 b, t=t))
    x, times, mask = (train.device_arrays(data, card)[k]
                      for k in ("x", "times", "mask"))
    before = logdet.LAUNCHES
    out = model(x, times, mask)
    assert logdet.LAUNCHES == before + 1
    out.loss.backward()
    model.sample_posterior(x, times, mask, 1)
    assert logdet.LAUNCHES == before + 1
    assert torch.isfinite(out.loss)


def _kl_sample_grads(times, mask, ls, var, mu, eps, fold):
    """Gradients of a KL + sample objective with respect to lengthscales
    and variance, the logdets from the factorization's node (``fold``) or
    from ``logdet_from_chol`` of each half (a dense diagonal L_bar)."""
    from gpvae_tpu_torch import gp

    z = mu.shape[-1]
    ls = ls.clone().requires_grad_(True)
    var = var.clone().requires_grad_(True)
    if fold:
        l, ld = gp._chol_gram_bank_logdet(times, ls, mask=mask, variance=var)
        given = dict(logdet_q=ld[:, :z], logdet_p=ld[:, z:])
    else:
        l, given = gp.chol_gram_bank(times, ls, mask=mask, variance=var), {}
    kl = gp.gp_kl(mu, l[:, :z], l[:, z:], mask, **given)
    draw = gp.gp_sample(mu, l[:, :z], 1, mask, eps=eps)
    (kl.sum() + 0.5 * (draw * draw).sum()).backward()
    return ls.grad.double().cpu(), var.grad.double().cpu()


@pytest.mark.parametrize("seed", [0, 1])
def test_logdet_fold_gradients_are_as_accurate_as_the_dense_route(card,
                                                                  seed):
    """T=256 on the card in float32: the lengthscale and variance
    gradients with the fold, and with ``gp_kl`` taking its logdets from
    ``logdet_from_chol``, against the same objective in float64 on the
    CPU.  The two float32 routes round differently, and their gradients
    differ by as much as each differs from float64 (1e-5 to 5e-4 on the
    CPU), so the fold's error is held to 2x the dense route's."""
    rng = np.random.default_rng(seed)
    b, t = 4, 256
    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    mask = rng.random((b, t)) > 0.3
    mask[:, 0] = True
    arrays = (times, mask, rng.uniform(2.0, 9.0, 4), rng.uniform(0.5, 1.5, 4),
              rng.standard_normal((b, t, 2)),
              rng.standard_normal((1, b, 2, t)))

    def tensors(device, dtype):
        return [torch.tensor(a, device=device) if a.dtype == bool
                else torch.tensor(a, dtype=dtype, device=device)
                for a in arrays]

    ref = _kl_sample_grads(*tensors("cpu", torch.float64), fold=True)
    before = logdet.LAUNCHES
    fold = _kl_sample_grads(*tensors(card, torch.float32), fold=True)
    assert logdet.LAUNCHES == before + 1
    dense = _kl_sample_grads(*tensors(card, torch.float32), fold=False)
    for f, d, r in zip(fold, dense, ref):
        rel_f = (torch.linalg.norm(f - r) / torch.linalg.norm(r)).item()
        rel_d = (torch.linalg.norm(d - r) / torch.linalg.norm(r)).item()
        assert rel_f <= 2.0 * max(rel_d, 1e-6), (rel_f, rel_d)


@pytest.mark.parametrize("t", [100, 192, 1024])
def test_tri_inv_large_t_matches_plain(card, t):
    times, mask, ls, var = _flat(card, t, 4, t)
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    before = tri_inv.LAUNCHES
    x = tri_inv.tri_inv(l)
    assert tri_inv.LAUNCHES > before
    ref = tri_inv.tri_inv_plain(l.double())
    torch.cuda.synchronize()
    rel = (torch.linalg.matrix_norm(x.double() - ref)
           / torch.linalg.matrix_norm(ref)).max().item()
    assert rel <= 1e-4
    assert torch.all(torch.triu(x, 1) == 0)


def test_train_step_goes_through_both_kernels(card):
    preset = configs.get("syn_data")
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(0),
                                                 100))
    model = GPVAE(preset.model, generator=torch.Generator().manual_seed(0))
    before = (gram_chol.LAUNCHES, tri_inv.LAUNCHES)
    state, log = train.fit(model, Batcher(data, 20), train.TrainConfig(
        num_steps=3, log_every=3), device=card, verbose=False)
    # per step: one factorization, one inverse in the KL, one in its
    # backward
    assert (gram_chol.LAUNCHES - before[0],
            tri_inv.LAUNCHES - before[1]) == (3, 6)
    assert np.isfinite(log.rows[-1]["loss"])


def test_bench_t100_step_goes_through_the_large_t_kernels(card):
    preset = configs.get("bench_t100")
    t = 256  # T % 256 == 0: every large-T kernel of the path
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(0),
                                                 16, t=t))
    cfg = dataclasses.replace(preset.model, time_len=t)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    counters = (chol_block, logdet, tri_inv)
    before = [m.LAUNCHES for m in counters] + [blocked.PANEL_LAUNCHES,
                                               blocked.SOLVE_LAUNCHES]
    state, log = train.fit(model, Batcher(data, 4), train.TrainConfig(
        num_steps=2, log_every=2), device=card, verbose=False)
    after = [m.LAUNCHES for m in counters] + [blocked.PANEL_LAUNCHES,
                                              blocked.SOLVE_LAUNCHES]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert np.isfinite(log.rows[-1]["loss"])


def _launches():
    return (gram_chol.LAUNCHES, tri_inv.LAUNCHES, chol_block.LAUNCHES,
            blocked.PANEL_LAUNCHES, blocked.SOLVE_LAUNCHES,
            blocked.HIST_LAUNCHES, logdet.LAUNCHES)


@pytest.mark.parametrize("t", [10, 17, 33])
def test_gram_chol_cauchy_on_a_shared_grid_matches_plain(card, t):
    """healing_mnist's bank: one row of times 0 .. T-1, no mask, N = 2Z =
    128 Cauchy factors (T=10; 17 and 33 end in ragged panels)."""
    times = torch.arange(t, dtype=torch.float32, device=card)[None]
    ls = torch.tensor(np.random.default_rng(t).uniform(0.5, 4.0, 128),
                      dtype=torch.float32, device=card)
    l = gram_chol.gram_chol_fused(times, ls, kernel="cauchy")
    ref = gram_chol.gram_chol_plain(times.double(), ls.double(),
                                    kernel="cauchy")
    lib = gram_chol.gram_chol_plain(times, ls, kernel="cauchy")
    err = (l.double() - ref).abs().max().item()
    err_lib = (lib.double() - ref).abs().max().item()
    assert err <= max(5e-5, 4.0 * err_lib)
    assert torch.all(torch.triu(l, 1) == 0)


def test_fitc_kl_on_the_card_matches_float64(card):
    """``fitc_diag_kl`` at sparse_t4096's Z=8, m=64 (T=512, B=2, unit grid)
    in float32 on the kernels against float64, both at the float32 jitter:
    the KL within 9.8e-4 of |KL| (BASELINE.md's sparse_t4096 row) or 4x
    the CPU's float32 error; ``chol_block`` twice and ``tri_inv`` three
    times forward, and two more ``tri_inv`` in the lengthscales'
    backward."""
    rng = np.random.default_rng(0)
    b, t, z = 2, 512, 8
    times = np.broadcast_to(np.arange(t, dtype=np.float64), (b, t))
    mask = rng.random((b, t)) > 0.3
    mu = rng.standard_normal((b, t, z))
    log_var = 0.3 * rng.standard_normal((b, t, z))
    s = np.linspace(0.0, float(t), 64)

    def run(device, dtype):
        ls = torch.full((z,), 32.0, dtype=dtype, device=device,
                        requires_grad=True)
        kl = sparse.fitc_diag_kl(
            *(torch.tensor(a, dtype=dtype, device=device)
              for a in (mu, log_var, times, s)), ls,
            mask=torch.tensor(mask, device=device), jitter=1e-4)
        kl.sum().backward()
        return kl.detach().double().cpu(), ls.grad.double().cpu()

    before = _launches()
    kl, g = run(card, torch.float32)
    after = _launches()
    assert [a - b_ for a, b_ in zip(after, before)] == [0, 5, 2, 0, 0, 0, 0]
    ref, g_ref = run("cpu", torch.float64)
    lib, _ = run("cpu", torch.float32)
    err = ((kl - ref).abs() / ref.abs()).max().item()
    err_lib = ((lib - ref).abs() / ref.abs()).max().item()
    assert err <= max(9.8e-4, 4.0 * err_lib)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("name", ["healing_mnist", "sparse_t4096"])
def test_baseline_preset_steps_launch_their_kernels(card, name):
    """A training step of healing_mnist (at its widths, B=4, T=10): one
    Cauchy ``gram_chol``, two ``tri_inv``; of sparse_t4096 (T=512): two
    ``chol_block``, three ``tri_inv``; nothing else."""
    cfg = configs.get(name).model
    if name == "healing_mnist":
        data = make_healing_batch(8, seed=0)
        data.pop("x_clean")
        want = (1, 2, 0, 0, 0, 0, 0)
    else:
        cfg = dataclasses.replace(cfg, time_len=512)
        data = toy_to_masked_batch(generate_toy_data(
            np.random.default_rng(0), 8, t=512, xmax=511.0))
        want = (0, 3, 2, 0, 0, 0, 0)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    before = _launches()
    state, log = train.fit(model, Batcher(data, 4), train.TrainConfig(
        num_steps=2, log_every=2), device=card, verbose=False)
    after = _launches()
    assert tuple((a - b) // 2 for a, b in zip(after, before)) == want
    assert np.isfinite(log.rows[-1]["loss"])


# -- the imputation path: the Cholesky of a pre-built bank ---------------------

def _prebuilt(card, seed, n, t):
    """A masked gram bank ``[n, t, t]`` on the card, float32 and float64."""
    times, mask, ls, var = _flat(card, seed, n, t)
    k = kernels.gram(times.double(), ls.double()[:, None, None],
                     variance=var.double()[:, None, None], mask=mask)
    return k.float(), k


@pytest.mark.parametrize("t,r0,o,w", [
    (1024, 512, 512, 128), (300, 280, 256, 44), (256, 0, 0, 128),
    (1023, 640, 512, 128), (300, 200, 200, 100), (256, 100, 37, 64)])
def test_hist_panel_matches_plain(card, t, r0, o, w):
    """At the T=1024 path's middle step, at a ragged last block with r0 > o,
    at o = 0 (a copy of K's columns), with rows of L and K that are not
    16-byte aligned (T=1023), and at history depths that are not a
    multiple of the kernel's 32-deep stage (200) or of a 16-byte copy
    (37); K read inside a larger buffer at its row stride and left
    unchanged."""
    k, k64 = _prebuilt(card, t, 8, t)
    big = torch.full((8, t + 8, t + 16), float("nan"), device=card)
    big[:, 4:t + 4, 8:t + 8] = k
    kv = big[:, 4:t + 4, 8:t + 8]
    before_k = big.clone()
    l0 = torch.linalg.cholesky(k64).float().contiguous()
    got, ref = l0.clone(), l0.double()
    before = blocked.HIST_LAUNCHES
    blocked.hist_panel(got, kv, r0, o, w)
    assert blocked.HIST_LAUNCHES == before + 1
    blocked.hist_panel_plain(ref, k.double(), r0, o, w)
    torch.cuda.synchronize()
    assert (got.double() - ref).abs().max().item() <= 1e-4
    assert torch.equal(big.isnan(), before_k.isnan())
    assert torch.equal(torch.nan_to_num(big), torch.nan_to_num(before_k))


@pytest.mark.parametrize("t", [45, 100, 128, 256, 300, 1024])
def test_cholesky_of_a_prebuilt_bank_matches_float64(card, t):
    """``ops.chol.cholesky`` on a [B, Z, T, T] bank: one ``chol_block``
    launch up to T = 128, the blocked loop with ``hist_panel`` above; within
    the band of ``_l_band``; the strict upper triangle exactly 0; K
    unchanged."""
    k, k64 = _prebuilt(card, 50 + t, 16, t)
    kb = k.reshape(8, 2, t, t)
    k_before = kb.clone()
    counts = (chol_block.LAUNCHES, blocked.HIST_LAUNCHES)
    l = chol.cholesky(kb)
    blocks = -(-t // blocked.NB)
    assert (chol_block.LAUNCHES - counts[0],
            blocked.HIST_LAUNCHES - counts[1]) == (
                blocks, blocks if blocks > 1 else 0)
    ref = torch.linalg.cholesky(k64).reshape(8, 2, t, t)
    lib = torch.linalg.cholesky(k).reshape(8, 2, t, t)
    err, band = _l_band(l, ref, lib)
    assert err <= band
    assert torch.all(torch.triu(l, 1) == 0)
    assert torch.equal(kb, k_before)


def test_cholesky_gives_nan_where_not_positive_definite(card):
    """No clamp and no exception: the matrix whose pivot goes negative
    holds NaN from that column on, the others are untouched."""
    k, _ = _prebuilt(card, 7, 4, 200)
    k[2, 150, 150] = -1.0
    l = chol.cholesky(k)
    torch.cuda.synchronize()
    assert torch.isnan(l[2, 150:, 150]).all()
    assert torch.isfinite(l[[0, 1, 3]]).all()


@pytest.mark.parametrize("t", [45, 100, 1024])
@pytest.mark.parametrize("left_side,transpose_a", [
    (True, False), (True, True), (False, False), (False, True)])
def test_solve_triangular_takes_tri_inv(card, t, left_side, transpose_a):
    k, k64 = _prebuilt(card, t, 4, t)
    a = torch.linalg.cholesky(k64).float().contiguous()
    rng = np.random.default_rng(t)
    b = torch.tensor(rng.standard_normal((4, t, 6) if left_side
                                         else (4, 6, t)),
                     dtype=torch.float32, device=card)
    before = tri_inv.LAUNCHES
    x = trsm.solve_triangular(a, b, left_side=left_side,
                              transpose_a=transpose_a)
    assert tri_inv.LAUNCHES > before
    ref = torch.linalg.solve_triangular(
        a.double().mT if transpose_a else a.double(), b.double(),
        upper=transpose_a, left=left_side)
    rel = (torch.linalg.norm(x.double() - ref) / torch.linalg.norm(ref))
    # the inverse route amplifies rounding by about cond(L) = sqrt(cond K)
    assert rel.item() <= 1e-3


@pytest.mark.parametrize("left_side,transpose_a", [
    (True, False), (False, True)])
def test_solve_triangular_above_the_inverse_route_is_float64(
        card, left_side, transpose_a):
    """Above ``INV_ROUTE_MAX_T`` a float32 triangle on the card is solved
    in float64 (one library call, no ``tri_inv``) and the result rounded
    back to float32: within float32's rounding of the float64 solve of
    the same float32 inputs, with a gradient for both operands."""
    t = trsm.INV_ROUTE_MAX_T + 128
    k, k64 = _prebuilt(card, t, 2, t)
    a = torch.linalg.cholesky(k64).float().contiguous().requires_grad_()
    rng = np.random.default_rng(t)
    b = torch.tensor(rng.standard_normal((2, t, 3) if left_side
                                         else (2, 3, t)),
                     dtype=torch.float32, device=card, requires_grad=True)
    before = tri_inv.LAUNCHES
    x = trsm.solve_triangular(a, b, left_side=left_side,
                              transpose_a=transpose_a)
    assert tri_inv.LAUNCHES == before
    assert x.dtype == torch.float32
    ref = torch.linalg.solve_triangular(
        a.detach().double().mT if transpose_a else a.detach().double(),
        b.detach().double(), upper=transpose_a, left=left_side)
    assert ((x.detach().double() - ref).abs().max()
            <= 1e-6 * ref.abs().max())
    x.sum().backward()
    assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()


def test_evaluate_path_goes_through_the_kernels(card, tmp_path):
    """``imputation_metrics`` of a ``bench_t100`` model at T=256 on the
    card: every kernel of the path launches, no library factorization or
    solve is called, and the metrics agree with the same model on the CPU
    in float64 with the same kept mask and baseline noise."""
    from gpvae_tpu_torch import analysis

    preset = configs.get("bench_t100")
    t = 256
    cfg = dataclasses.replace(preset.model, time_len=t)
    batch = toy_to_masked_batch(generate_toy_data(np.random.default_rng(0),
                                                  4, t=t))
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    kept = analysis.drop_timesteps(torch.tensor(batch["mask"]), 0.5,
                                   generator=gen)
    noise = torch.randn((4, t, cfg.latent_dim), generator=gen)

    def run(m, device, dtype):
        d = {k: torch.tensor(v, device=device) for k, v in batch.items()}
        return analysis.imputation_metrics(
            m, d["x"].to(dtype), d["times"].to(dtype), d["mask"],
            kept=kept.to(device), baseline_eps=noise.to(device, dtype))

    counters = (chol_block, tri_inv)
    before = [m.LAUNCHES for m in counters] + [blocked.HIST_LAUNCHES,
                                               blocked.SOLVE_LAUNCHES]
    got = run(model.to(card), card, torch.float32)
    after = [m.LAUNCHES for m in counters] + [blocked.HIST_LAUNCHES,
                                              blocked.SOLVE_LAUNCHES]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    _, _, post = analysis.impute(
        model, *(torch.tensor(batch[k], device=card) for k in (
            "x", "times", "mask")), kept.to(card))
    cpu = model.to("cpu")
    _, _, post32 = analysis.impute(
        cpu, *(torch.tensor(batch[k]) for k in ("x", "times", "mask")), kept)
    want = run(cpu.double(), "cpu", torch.float64)
    assert got["dropped_steps"] == want["dropped_steps"] > 0
    for name in ("nll_gp_impute", "mse_gp_impute", "nll_baseline",
                 "mse_baseline"):
        assert got[name] == pytest.approx(want[name], rel=1e-4), name
    _, _, post64 = analysis.impute(
        cpu, *(torch.tensor(batch[k]).double() if k != "mask"
               else torch.tensor(batch[k]) for k in ("x", "times", "mask")),
        kept)
    # 1e-4 of the largest entry, or 4x the CPU's float32 plain route
    scale = post64.mean.abs().max().item()
    err = (post.mean.double().cpu() - post64.mean).abs().max().item()
    err32 = (post32.mean.double() - post64.mean).abs().max().item()
    assert err <= max(1e-4 * scale, 4.0 * err32)


# -- the right-looking route: trail_panel + trail_update (B23) ----------------

# The explicit inverse of the diagonal block costs the float32 factor 3-4x
# the library's error of float64 (a CPU emulation, PERF.md), more on
# ill-conditioned blocks: the band is 5x the library's error, floored at
# 5e-5 as in _l_band, or 2x the same algorithm's error on its plain
# versions in float32 on the CPU (library factor, triangular solve for the
# inverse, matmuls), whichever is larger.
FUSED_VS_LIBRARY = 5.0
FUSED_VS_PLAIN = 2.0
# a kernel's float32 product against the float64 product of the same
# inputs, per element, over the sum of the magnitudes of its terms: depth
# <= 128 float32 roundings
TERMS_REL = 1e-5


def _fused_band(k, ref, block_size=128):
    lib = (torch.linalg.cholesky(k).double() - ref).abs().max().item()
    with_plain = k.cpu()  # the CPU takes the plain versions
    plain = blocked.cholesky_blocked_fused(with_plain, block_size=block_size)
    err_plain = (plain.to(ref.device).double() - ref).abs().max().item()
    return max(5e-5, FUSED_VS_LIBRARY * lib, FUSED_VS_PLAIN * err_plain)


def _terms_err(got, ref, terms):
    """max over elements of |got - ref| / terms."""
    return ((got.double() - ref).abs() / terms.clamp_min(1e-30)).max().item()


def _one_step(card, seed, n, t, nb):
    """A masked bank's float32 copy with its first ``nb`` block column
    finished by one right-looking step on the kernels, the second diagonal
    block factored and its inverse: the state in which step 2 starts."""
    k, _ = _prebuilt(card, seed, n, t)
    l = k.clone()
    for o in (0, nb):
        d = l[:, o:o + nb, o:o + nb]
        _, inv = chol_block.chol_block(d, inverse=True, out=d)
        if o == 0:
            trail.trail_panel(l, inv, 0)
            trail.trail_update(l, 0, nb)
    return l, inv


@pytest.mark.parametrize("nb", trail.WIDTHS)
@pytest.mark.parametrize("t", [320, 1000, 1023])
def test_trail_kernels_match_plain(card, nb, t):
    """Step 2 (o = nb) of ragged T (1000, and 1023, whose rows are not
    16-byte aligned) and a whole-tile T against the plain versions in
    float64 on the same inputs, X and the downdate on its lower tiles, each
    within ``TERMS_REL`` of its terms."""
    l, inv = _one_step(card, t + nb, 8, t, nb)
    o = nb
    got, ref = l.clone(), l.double()
    before = (trail.PANEL_LAUNCHES, trail.UPDATE_LAUNCHES)
    trail.trail_panel(got, inv, o)
    trail.trail_panel_plain(ref, inv.double(), o)
    p = l[:, o + nb:, o:o + nb].double()
    assert _terms_err(got[:, o + nb:, o:o + nb], ref[:, o + nb:, o:o + nb],
                      p.abs() @ inv.double().abs().mT) <= TERMS_REL
    assert torch.all(got[:, o:o + nb, o + nb:] == 0)
    # the downdate, both from the kernel's X
    ref = got.double()
    trail.trail_update(got, o, nb)
    trail.trail_update_plain(ref, o, nb)
    assert (trail.PANEL_LAUNCHES - before[0],
            trail.UPDATE_LAUNCHES - before[1]) == (1, 1)
    torch.cuda.synchronize()
    low = trail.lower_tiles(t - o - nb, card)
    sq = got[:, o + nb:, o + nb:]
    x = ref[:, o + nb:, o:o + nb]
    terms = l[:, o + nb:, o + nb:].double().abs() + x.abs() @ x.abs().mT
    err = _terms_err(sq[:, low], ref[:, o + nb:, o + nb:][:, low],
                     terms[:, low])
    assert err <= TERMS_REL
    # the tiles above the lower ones, and the columns left of X, untouched
    assert torch.equal(sq[:, ~low], l[:, o + nb:, o + nb:][:, ~low])
    assert torch.equal(got[:, :, :o], l[:, :, :o])


@pytest.mark.parametrize("nb", trail.WIDTHS)
def test_trail_panel_reads_only_the_lower_triangle_of_ld_inv(card, nb):
    """Noise above the diagonal of ``Ld^{-1}`` changes no bit of the
    kernel's result, and the plain version ignores it as well."""
    l, inv = _one_step(card, 7, 4, 384, nb)
    gen = torch.Generator(device=card).manual_seed(nb)
    noisy = inv + torch.randn(inv.shape, device=card,
                              generator=gen).triu(1)
    want, got, ref = l.clone(), l.clone(), l.double()
    trail.trail_panel(want, inv, nb)
    trail.trail_panel(got, noisy, nb)
    trail.trail_panel_plain(ref, noisy.double(), nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    p = l[:, 2 * nb:, nb:2 * nb].double()
    assert _terms_err(got[:, 2 * nb:, nb:2 * nb], ref[:, 2 * nb:, nb:2 * nb],
                      p.abs() @ inv.double().abs().mT) <= TERMS_REL


@pytest.mark.parametrize("col", [12, 13])
def test_trail_kernels_work_in_place_at_a_row_stride(card, col):
    """L a view inside a larger buffer, its rows 16-byte aligned (column
    offset 12) or not (13): the same bits as on a contiguous L, and nothing
    written outside the view."""
    nb, t = 128, 384
    l, inv = _one_step(card, 4, 4, t, nb)
    want = l.clone()
    trail.trail_panel(want, inv, nb)
    trail.trail_update(want, nb, nb)
    big = torch.full((4, t + 10, t + 20), float("nan"), device=card)
    big[:, 6:t + 6, col:t + col] = l
    view = big[:, 6:t + 6, col:t + col]
    trail.trail_panel(view, inv, nb)
    trail.trail_update(view, nb, nb)
    torch.cuda.synchronize()
    assert torch.equal(view, want)
    outside = big.clone()
    outside[:, 6:t + 6, col:t + col] = float("nan")
    assert torch.isnan(outside).all()


@pytest.mark.parametrize("t,nb", [(128, 128), (256, 64), (300, 64),
                                  (300, 128), (1024, 128)])
def test_cholesky_blocked_fused_matches_float64(card, t, nb):
    """Counted launches, the band, an exactly zero strict upper triangle
    (K's upper half was copied into L first), K unchanged."""
    k, k64 = _prebuilt(card, 90 + t, 16, t)
    k_before = k.clone()
    before = (chol_block.LAUNCHES, trail.PANEL_LAUNCHES,
              trail.UPDATE_LAUNCHES)
    l = blocked.cholesky_blocked_fused(k, block_size=nb)
    blocks = -(-t // nb)
    assert (chol_block.LAUNCHES - before[0],
            trail.PANEL_LAUNCHES - before[1],
            trail.UPDATE_LAUNCHES - before[2]) == (blocks, blocks - 1,
                                                   blocks - 1)
    ref = torch.linalg.cholesky(k64)
    err = (l.double() - ref).abs().max().item()
    assert err <= _fused_band(k, ref, nb)
    assert torch.all(torch.triu(l, 1) == 0)
    assert torch.equal(k, k_before)


@pytest.mark.parametrize("method", chol.METHODS)
def test_every_cholesky_method_on_the_card(card, method):
    t = 64 if method == "pallas" else 300
    k, k64 = _prebuilt(card, 5, 8, t)
    l = chol.cholesky(k.reshape(4, 2, t, t), method=method).reshape(8, t, t)
    assert l.is_contiguous()
    ref = torch.linalg.cholesky(k64)
    if method in ("blocked", "blocked_fused", "blocked_fused_64"):
        band = _fused_band(k, ref, 64 if method.endswith("64") else 128)
        err = (l.double() - ref).abs().max().item()
    else:
        err, band = _l_band(l, ref, torch.linalg.cholesky(k))
    assert err <= band
    assert torch.all(torch.triu(l, 1) == 0)


def test_trail_kernels_refuse_what_they_do_not_take(card):
    l = torch.zeros((2, 256, 256), device=card)
    inv = torch.zeros((2, 128, 128), device=card)
    with pytest.raises(TypeError, match="float32"):
        trail.trail_panel(l.double(), inv.double(), 0)
    with pytest.raises(TypeError, match="float32"):
        trail.trail_update(l.double(), 0, 128)
    with pytest.raises(ValueError, match="unit-stride"):
        trail.trail_update(l.transpose(1, 2), 0, 128)
    with pytest.raises(ValueError, match="unit-stride"):
        trail.trail_panel(l.transpose(1, 2), inv, 0)
    with pytest.raises(ValueError, match="contiguous"):
        trail.trail_panel(l, inv.transpose(1, 2), 0)
    with pytest.raises(ValueError, match="bad block"):
        trail.trail_update(l, 0, 96)
    with pytest.raises(ValueError, match="block_size"):
        blocked.cholesky_blocked_fused(l, block_size=32)
    with pytest.raises(ValueError, match="T=100 > 64"):
        chol.cholesky(torch.eye(100, device=card)[None], method="pallas")


# -- the Toeplitz prior: the Durbin recursion ---------------------------------

def _toeplitz_rows(card, t, z, dtype=torch.float64):
    """``z`` first rows on the grid 0 .. 60 (step 60 / (T-1)), lengthscales
    from 9 down, noise 1e-3."""
    ls = torch.tensor([9.0, 3.0, 1.0][:z], dtype=dtype, device=card)
    return kernels.toeplitz_row(t, 60.0 / max(t - 1, 1), ls, dtype=dtype)


@pytest.mark.parametrize("z", [1, 3])
@pytest.mark.parametrize("t", [2, 3, 33, 1024, 1025, 4096])
def test_durbin_kernel_matches_plain(card, t, z):
    """``durbin_gs_factors`` through the kernel (one launch) against its
    plain version on the same float64 rows: logdet over max(|logdet|, 1)
    and e relative, a and b over max |a|, to 1e-9."""
    row = _toeplitz_rows(card, t, z)
    before = durbin.LAUNCHES
    got = toeplitz.durbin_gs_factors(row)
    assert durbin.LAUNCHES == before + 1
    real = dispatch.on_cuda
    dispatch.on_cuda = lambda x: False
    try:
        ref = toeplitz.durbin_gs_factors(row)
    finally:
        dispatch.on_cuda = real
    torch.cuda.synchronize()
    ld, a, b, e = got
    ld0, a0, b0, e0 = ref
    scale = a0.abs().max()
    assert ((ld - ld0).abs() / ld0.abs().clamp(min=1.0)).max() <= 1e-9
    assert ((e - e0).abs() / e0.abs()).max() <= 1e-9
    assert (a - a0).abs().max() <= 1e-9 * scale
    assert (b - b0).abs().max() <= 1e-9 * scale
    if t <= 1025:  # the logdet against the dense matrix's
        k = kernels.toeplitz_to_dense(row)
        dense = torch.linalg.slogdet(k)[1]
        assert ((ld - dense).abs() / dense.abs().clamp(min=1.0)).max() <= 1e-9


def test_durbin_kernel_keeps_the_input_dtype_and_refuses_what_it_cannot(
        card):
    """A float32 row recurs in float64 and comes back in float32; a row
    that requires a gradient goes through the forward kernel (keeping its
    steps) and, at ``backward``, one launch of the reverse kernel, its
    gradient that of the plain version's autograd; past T = 4096 (the long
    route, T in {4097, 8192}) the forward and the reverse hold to their
    plain versions as below; the wrappers refuse float32."""
    row = _toeplitz_rows(card, 64, 2, torch.float32)
    ld, a, b, e = toeplitz.durbin_gs_factors(row)
    assert all(v.dtype == torch.float32 and v.is_cuda for v in (ld, a, b, e))
    # recurred in float64 on the float32 row's values
    ref = toeplitz.durbin_gs_factors(row.double())
    for v, r in zip((ld, a, b, e), ref):
        assert torch.equal(v, r.float())
    r64 = row.double().requires_grad_(True)
    before = (durbin.LAUNCHES, durbin.BWD_LAUNCHES)
    toeplitz.durbin_logdet(r64).sum().backward()
    assert (durbin.LAUNCHES, durbin.BWD_LAUNCHES) == (before[0] + 1,
                                                      before[1] + 1)
    rp = row.double().requires_grad_(True)
    real = dispatch.on_cuda
    dispatch.on_cuda = lambda x: False
    try:
        toeplitz.durbin_logdet(rp).sum().backward()
    finally:
        dispatch.on_cuda = real
    assert (r64.grad - rp.grad).abs().max() <= 1e-9 * rp.grad.abs().max()
    with torch.no_grad():
        toeplitz.durbin_logdet(row.clone().requires_grad_(True))
    for t in (4097, 8192):
        rho = _bwd_cases(card, t, 2)
        before = durbin.LAUNCHES
        got = durbin.durbin_cuda(rho)
        assert durbin.LAUNCHES == before + 1
        ref = durbin.durbin_plain(rho)
        torch.cuda.synchronize()
        for v, r in zip(got, ref):
            assert (v - r).abs().max() <= 1e-9 * r.abs().max()
        g = torch.Generator(device=card).manual_seed(t)
        _check_bwd(rho, tuple(
            torch.randn(shape, dtype=torch.float64, device=card, generator=g)
            for shape in ((2,), (2, t - 1), (2,))))
    with pytest.raises(TypeError, match="float64"):
        durbin.durbin_cuda(torch.zeros(1, 8, device=card))


def test_durbin_chain_floor_runs(card):
    """Both routes' chains: one block (T=1024), the long route (8192)."""
    for t in (1024, 8192):
        out = durbin.chain_floor_cuda(2, t, card)
        bwd = durbin.bwd_chain_floor_cuda(2, t, card)
        torch.cuda.synchronize()
        assert out.tolist() == [1.0, 1.0]
        assert bwd.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("t", [1024, 4096, 4097, 4130, 8192])
def test_durbin_counts_the_kernels_each_route_launches(card, t):
    """One kernel a call up to T = 4096; above it one a window of 32 steps
    and a finishing one, and in reverse two a window, a starting and a
    finishing one: counted where the C code launches them."""
    windows = -(-(t - 1) // 32)
    want = (1, 1) if t <= 4096 else (windows + 1, 2 * windows + 2)
    rho = _bwd_cases(card, t, 2)
    before = (durbin.KERNEL_LAUNCHES, durbin.BWD_KERNEL_LAUNCHES)
    *_, (steps, last) = durbin.durbin_cuda(rho, save=True)
    durbin.durbin_bwd_cuda(steps, last, None, None,
                           torch.ones(2, dtype=torch.float64, device=card))
    assert (durbin.KERNEL_LAUNCHES - before[0],
            durbin.BWD_KERNEL_LAUNCHES - before[1]) == want


def _bwd_cases(card, t, z):
    rows = _toeplitz_rows(card, t, z)
    return (rows[:, 1:] / rows[:, :1]).contiguous()


def _check_bwd(rho, cotangents, band=1e-9):
    """The reverse kernel on the forward kernel's steps against
    ``durbin_bwd_plain`` on the same steps and against the plain
    version's autograd, float64, max error over max |reference|."""
    n, t1 = rho.shape
    _, _, _, (steps, last) = durbin.durbin_cuda(rho, save=True)
    before = durbin.BWD_LAUNCHES
    got = durbin.durbin_bwd_cuda(steps, last, *cotangents)
    assert durbin.BWD_LAUNCHES == before + 1
    plain = durbin.durbin_bwd_plain(steps, last, *cotangents)
    r = rho.clone().requires_grad_(True)
    outs = durbin.durbin_plain(r)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents)
               if c is not None)
    auto, = torch.autograd.grad(loss, r)
    torch.cuda.synchronize()
    for ref in (plain, auto):
        scale = ref.abs().max().clamp(min=1e-300)
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= band * scale


@pytest.mark.parametrize("z", [1, 3])
@pytest.mark.parametrize("t", [2, 3, 33, 1024, 1025, 4096])
def test_durbin_bwd_kernel_matches_plain(card, t, z):
    """Random cotangents on all three outputs, at the forward's sides."""
    rho = _bwd_cases(card, t, z)
    g = torch.Generator(device=card).manual_seed(t)
    n, t1 = rho.shape
    _check_bwd(rho, (
        torch.randn(n, dtype=torch.float64, device=card, generator=g),
        torch.randn(n, t1, dtype=torch.float64, device=card, generator=g),
        torch.randn(n, dtype=torch.float64, device=card, generator=g)))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_durbin_bwd_kernel_takes_each_output_alone(card, which):
    """A cotangent on one output (the others ``None``: not read)."""
    rho = _bwd_cases(card, 1024, 2)
    n, t1 = rho.shape
    shapes = ((n,), (n, t1), (n,))
    cot = [None, None, None]
    cot[which] = torch.randn(shapes[which], dtype=torch.float64,
                             device=card)
    _check_bwd(rho, tuple(cot))


@pytest.mark.parametrize("t", [17, 1024, 8192])
def test_durbin_bwd_kernel_where_alpha_clamps(card, t):
    """The last reflection coefficient clamped: no gradient through it,
    as ``torch.clamp``'s autograd."""
    rho = clamped_rows(t, device=card)
    _check_bwd(rho, (torch.ones(1, dtype=torch.float64, device=card),
                     torch.ones(1, t - 1, dtype=torch.float64, device=card),
                     torch.ones(1, dtype=torch.float64, device=card)))


@pytest.mark.parametrize("t", [2, 9, 40])
def test_durbin_function_gradcheck(card, t):
    """``torch.autograd.gradcheck`` of the kernels' Function in float64,
    on well-conditioned rows (unit grid, lengthscales 2 and 0.7, noise
    0.1): central differences at eps 1e-6 stay far inside the tolerance
    there, not on the preset's cond ~1e5 rows, where the Jacobian reaches
    1e4 (those are held against autograd above)."""
    row = kernels.toeplitz_row(t, 1.0, torch.tensor(
        [2.0, 0.7], dtype=torch.float64, device=card), noise=0.1,
        dtype=torch.float64)
    rho = (row[:, 1:] / row[:, :1]).contiguous().requires_grad_(True)
    assert torch.autograd.gradcheck(durbin.DurbinFunction.apply, (rho,),
                                    eps=1e-6, atol=1e-7, rtol=1e-5)


def test_durbin_bwd_refuses_what_it_cannot(card):
    rho = _bwd_cases(card, 64, 2)
    _, _, _, (steps, last) = durbin.durbin_cuda(rho, save=True)
    with pytest.raises(TypeError, match="float64"):
        durbin.durbin_bwd_cuda(steps.float(), last, None, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        durbin.durbin_bwd_cuda(steps, last[:, :, :-1], None, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        durbin.durbin_bwd_cuda(steps.cpu(), last.cpu(), None, None, None)


def test_toeplitz_prior_kl_on_the_card_matches_dense(card):
    """``gp_kl_toeplitz_prior`` in float32 on the card (the Durbin kernel,
    cuFFT) against the dense prior's ``gp_kl`` in float64 on the CPU,
    T=1024, B=4, Z=2, a shared posterior factor: within 4.5e-4 relative
    (BASELINE.md's T=1024 figure) or 4x the CPU's float32 error."""
    rng = np.random.default_rng(3)
    t = 1024
    times = torch.linspace(0.0, 60.0, t, dtype=torch.float64)[None]
    mu = torch.tensor(0.5 * rng.standard_normal((4, t, 2)))
    l_q = gp.chol_gram_bank(times, torch.tensor([5.0, 2.0],
                                                dtype=torch.float64))
    row = kernels.toeplitz_row(t, 60.0 / (t - 1), torch.tensor(
        [9.0, 3.0], dtype=torch.float64), dtype=torch.float64)
    l_p = torch.linalg.cholesky(kernels.toeplitz_to_dense(row))[None]
    ref = gp.gp_kl(mu, l_q, l_p)
    lib = gp.gp_kl_toeplitz_prior(mu.float(), l_q.float(), row.float())
    before = durbin.LAUNCHES
    got = gp.gp_kl_toeplitz_prior(mu.float().to(card), l_q.float().to(card),
                                  row.float().to(card))
    assert durbin.LAUNCHES == before + 1
    err = ((got.double().cpu() - ref).abs() / ref.abs()).max().item()
    err_lib = ((lib.double() - ref).abs() / ref.abs()).max().item()
    assert err <= max(4.5e-4, 4.0 * err_lib)


def test_t1024_toeplitz_steps_launch_their_kernels(card):
    """A training step of t1024_toeplitz at its widths (B=8, T=1024, Z=2):
    the posterior bank's blocked factorization (gram_panel 8, chol_block
    8, panel_solve 7), one diag_logdet, the backward's tri_inv and its
    three chol_bwd passes, one Durbin launch; no prior factorization, no
    gram_chol, no hist_panel."""
    cfg = configs.get("t1024_toeplitz").model
    data = toy_to_masked_batch(generate_toy_data(
        np.random.default_rng(0), 16, t=1024, hide_fraction=0.0))
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    before = _launches() + (durbin.LAUNCHES, chol_bwd.LAUNCHES)
    state, log = train.fit(model, Batcher(data, 8), train.TrainConfig(
        num_steps=2, log_every=2), device=card, verbose=False)
    after = _launches() + (durbin.LAUNCHES, chol_bwd.LAUNCHES)
    assert tuple((a - b) // 2 for a, b in zip(after, before)) == (
        0, 1, 8, 8, 7, 0, 1, 1, 3)
    assert np.isfinite(log.rows[-1]["loss"])


def test_learnable_toeplitz_prior_steps_launch_the_reverse(card):
    """t1024_toeplitz with ``learn_prior_lengthscales``: each step also
    launches the Durbin kernel's reverse once, and the prior's
    lengthscales move."""
    cfg = dataclasses.replace(configs.get("t1024_toeplitz").model,
                              learn_prior_lengthscales=True)
    data = toy_to_masked_batch(generate_toy_data(
        np.random.default_rng(0), 16, t=1024, hide_fraction=0.0))
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    ls0 = model.prior_log_ls.detach().clone()
    before = _launches() + (durbin.LAUNCHES, durbin.BWD_LAUNCHES)
    state, log = train.fit(model, Batcher(data, 8), train.TrainConfig(
        num_steps=2, log_every=2), device=card, verbose=False)
    after = _launches() + (durbin.LAUNCHES, durbin.BWD_LAUNCHES)
    assert tuple((a - b) // 2 for a, b in zip(after, before)) == (
        0, 1, 8, 8, 7, 0, 1, 1, 1)
    assert np.isfinite(log.rows[-1]["loss"])
    assert (model.prior_log_ls.detach().cpu() - ls0).abs().max() > 0


def test_posterior_conditional_with_cov_inverts_once_on_the_card(card):
    """``gp.posterior_conditional`` with the covariance at T=256 on the
    card: one ``tri_inv`` launch serves the refined mean and ``A``, and
    the covariance is ``K_qq - A^T A`` with ``A`` from
    ``trsm.solve_triangular``'s own inverse."""
    rng = np.random.default_rng(19)
    t = 256
    times = torch.linspace(0.0, 15.0, t)[None].expand(2, t).to(card)
    kept = torch.tensor(rng.random((2, t)) < 0.5).to(card)
    z_obs = torch.tensor(rng.standard_normal((2, t, 2)),
                         dtype=torch.float32).to(card)
    ls = torch.tensor([9.0, 3.0]).to(card)
    before = tri_inv.LAUNCHES
    got = gp.posterior_conditional(times, z_obs, times, ls, mask_obs=kept)
    assert tri_inv.LAUNCHES == before + 1
    k_oo = kernels.gram_bank(times, ls, mask=kept) + gp._jitter(
        torch.float32) * torch.eye(t, device=card)
    k_oq = kernels.cross_gram(times, times, ls, mask_a=kept)
    a = trsm.solve_triangular(chol.cholesky(k_oo), k_oq)
    want = kernels.gram_bank(times, ls) - a.mT @ a
    assert torch.allclose(got.cov, want, rtol=0.0,
                          atol=1e-6 * want.abs().max().item())


def test_cho_solve_by_inverse_on_the_card_is_refined(card):
    """``trsm.cho_solve_by_inverse`` at T=1024 (one ``tri_inv``
    of L for both solves, each product refined by its residual) on a
    dense uniform grid with half the steps kept (cond(K) ~ 1e5): the
    posterior mean ``K_qo K_oo^{-1} z`` within 1e-4 of its largest entry
    of float64, or 4x the CPU library's float32 substitution."""
    rng = np.random.default_rng(18)
    t = 1024
    times = torch.linspace(0.0, 60.0, t, dtype=torch.float64)[None].expand(
        2, t)
    kept = torch.tensor(rng.random((2, t)) < 0.5)
    ls = torch.tensor([9.0, 3.0], dtype=torch.float64)
    k = kernels.gram_bank(times, ls, mask=kept) + 1e-5 * torch.eye(
        t, dtype=torch.float64)
    k_oq = kernels.cross_gram(times, times, ls, mask_a=kept)
    z = torch.tensor(rng.standard_normal((2, 2, t, 1))) * kept[:, None, :,
                                                               None]

    def mean(w):
        return (k_oq.mT @ w.double().cpu())[..., 0]

    ref = mean(torch.cholesky_solve(z, torch.linalg.cholesky(k)))
    l = chol.cholesky(k.float().to(card))
    before = tri_inv.LAUNCHES
    got = mean(trsm.cho_solve_by_inverse(l, z.float().to(card)))
    assert tri_inv.LAUNCHES == before + 1
    lib = mean(torch.cholesky_solve(z.float(),
                                    torch.linalg.cholesky(k.float())))
    scale = ref.abs().max()
    err = ((got - ref).abs().max() / scale).item()
    err_lib = ((lib - ref).abs().max() / scale).item()
    assert err <= max(1e-4, 4.0 * err_lib)


def _drain(batcher):
    while True:
        yield next(batcher)


def _syn_data_fit(card, k, path, steps=50):
    """``syn_data`` at its widths, ``k`` steps a call, from seed-0 weights
    on a seed-0 Batcher (or a plain iterator of its batches)."""
    preset = configs.get("syn_data")
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(0),
                                                 200))
    model = GPVAE(preset.model, generator=torch.Generator().manual_seed(0))
    batcher = Batcher(data, preset.batch_size, seed=0)
    before = (gram_chol.LAUNCHES, tri_inv.LAUNCHES)
    state, log = train.fit(
        model, batcher if path == "batcher" else _drain(batcher),
        train.TrainConfig(num_steps=steps, log_every=25,
                          beta=preset.train.beta, steps_per_call=k),
        device=card, verbose=False)
    launches = (gram_chol.LAUNCHES - before[0], tri_inv.LAUNCHES - before[1])
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return state.step, [(r["step"], r["loss"]) for r in log.rows], params, \
        launches


@pytest.mark.parametrize("path", ["batcher", "iterator"])
def test_k_step_fit_equals_k1_bit_for_bit_on_the_card(card, path):
    """The same kernels in the same order with the same generator: every
    logged loss and parameter of k=25 equals k=1's, and each run launches
    one ``gram_chol`` and two ``tri_inv`` a step."""
    ref = _syn_data_fit(card, 1, "batcher")
    got = _syn_data_fit(card, 25, path)
    assert got[0] == ref[0] == 50
    assert got[1] == ref[1] and [s for s, _ in got[1]] == [25, 50]
    assert torch.equal(got[2], ref[2])
    assert got[3] == ref[3] == (50, 100)


def test_world_of_one_nccl_step_equals_train_step(card, tmp_path):
    """``make_parallel_train_step`` on a world of one rank (NCCL, a file
    store) against ``train_step`` on the same batch and noise: the
    all-reduce over one rank is the identity, so bit for bit."""
    from gpvae_tpu_torch.parallel import mesh as mesh_lib

    preset = configs.get("syn_data")
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(1),
                                                 20))
    states = []
    for _ in range(2):
        model = GPVAE(preset.model,
                      generator=torch.Generator().manual_seed(0))
        states.append(train.create_train_state(model, train.TrainConfig(),
                                               card))
    want = train.train_step(states[0], train.device_arrays(data, card), 1e-3)
    mesh_lib.init_process_group(str(tmp_path / "store"), 0, 1, "cuda")
    try:
        mesh = mesh_lib.make_mesh(devices=[card])
        mesh_lib.replicate(states[1], mesh)
        _, got = mesh_lib.make_parallel_train_step(
            lambda step: 1e-3, mesh)(states[1],
                                     mesh_lib.shard_batch(data, mesh))
    finally:
        torch.distributed.destroy_process_group()
    for key in ("loss", "nll", "kl"):
        assert torch.equal(got[key], want[key]), key
    for p, q in zip(states[1].model.parameters(),
                    states[0].model.parameters()):
        assert torch.equal(p, q)


# the Cholesky backward's kernel against its plain version (the library's
# float32 products), both against float64 on the same float32 inputs, max
# error over max |reference|: the CPU emulation of the kernel's arithmetic
# (python -m gpvae_tpu_torch.ops.split_emulation --backward) puts each
# pass within 2x an FMA loop's error and the whole K_bar within 1.9x (T =
# 256, ten seeds; 0.97x at T = 1024); the band is 3x, for the library's
# own order of sums
CHOL_BWD_VS_PLAIN = 3.0
# K_bar's mean error away from zero over its mean magnitude: the tensor
# cores truncate their sums, so the kernel's sums lean toward zero (-3.6e-7
# at T = 1024, -4.0e-7 at T = 8192 on an H100, the library's -1.8e-9);
# 2.5x the kernel's reading, 5e-3 of the float32 route's own error in the
# T = 1024 lengthscale gradient that K_bar feeds
CHOL_BWD_BIAS = 1e-6


def _chol_bwd_case(card, t, n):
    """A float32 factor of the port's blocked factorization (the unit grid
    at T = 8192, the training cell's), a lower N(0, 1) cotangent, a logdet
    cotangent per matrix, and X = L^-1."""
    if t >= 8192:
        rng = np.random.default_rng(t)
        times = torch.arange(t, dtype=torch.float32, device=card).expand(n,
                                                                         t)
        mask = torch.ones(n, t, device=card)
        ls = torch.tensor(rng.uniform(2.0, 9.0, n), dtype=torch.float32,
                          device=card)
        var = torch.ones(n, device=card)
    else:
        times, mask, ls, var = _flat(card, t, n, t)
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    gen = torch.Generator(card).manual_seed(t)
    l_bar = torch.randn(n, t, t, generator=gen, device=card).tril_()
    g = torch.randn(n, generator=gen, device=card)
    return l, l_bar, g, tri_inv.tri_inv(l)


@pytest.mark.parametrize("t,n", [(256, 4), (1024, 128), (8192, 2)])
def test_chol_bwd_kernel_matches_plain(card, t, n):
    """At T=256, at the training shapes T=1024 (N=128) and T=8192 (N=2):
    K_bar within CHOL_BWD_VS_PLAIN of the plain version's error from
    float64, its mean error away from zero within CHOL_BWD_BIAS,
    symmetric to the bit (the kernel mirrors its tiles), three
    launches."""
    l, l_bar, g, x = _chol_bwd_case(card, t, n)
    before = chol_bwd.LAUNCHES
    got = chol_bwd.chol_bwd_cuda(l, l_bar, x, g)
    assert chol_bwd.LAUNCHES == before + 3
    lib = chol_bwd.chol_bwd_plain(l, l_bar, x, g)
    d = torch.float64
    ref = chol_bwd.chol_bwd_plain(l.to(d), l_bar.to(d), x.to(d), g.to(d))
    scale = ref.abs().max()
    err = ((got.to(d) - ref).abs().max() / scale).item()
    err_lib = ((lib.to(d) - ref).abs().max() / scale).item()
    assert err <= CHOL_BWD_VS_PLAIN * err_lib, (err, err_lib)
    bias = (((got.to(d) - ref) * torch.sign(ref)).mean()
            / ref.abs().mean()).item()
    assert abs(bias) <= CHOL_BWD_BIAS, bias
    assert torch.equal(got, got.mT)


@pytest.mark.parametrize("t,takes", [(256, True), (1024, True),
                                     (320, False), (128, True),
                                     (100, False)])
def test_cholesky_backward_takes_the_kernel_by_shape(card, t, takes):
    """``cholesky_bwd_from_l`` on the card: three launches a backward where
    the side is a multiple of 128 (T=128 one tile); none at a ragged or
    small side, nor for the logdet alone (float64 on the card stops at
    ``tri_inv``'s kernel, float32 only; the CPU tests hold the rule
    there)."""
    # a leading block of a factor is a factor
    l, l_bar, g, _ = _chol_bwd_case(card, max(256, -(-t // 128) * 128), 2)
    l, l_bar = (m[:, :t, :t].contiguous() for m in (l, l_bar))
    before = chol_bwd.LAUNCHES
    chol.cholesky_bwd_from_l(l, l_bar, logdet_bar=g)
    assert chol_bwd.LAUNCHES == before + (3 if takes else 0)
    chol.cholesky_bwd_from_l(l, None, logdet_bar=g)
    assert chol_bwd.LAUNCHES == before + (3 if takes else 0)
