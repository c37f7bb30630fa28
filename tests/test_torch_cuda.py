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

from gpvae_tpu_torch import configs, kernels, train
from gpvae_tpu_torch.data import Batcher, generate_toy_data, toy_to_masked_batch
from gpvae_tpu_torch.models import GPVAE
from gpvae_tpu_torch.ops import blocked, chol_block, gram_chol, logdet, tri_inv

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


@pytest.mark.parametrize("kernel", sorted(kernels.KERNELS))
@pytest.mark.parametrize("t", [1, 8, 45, 64])
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


@pytest.mark.parametrize("t", [1, 37, 64, 100, 128])
@pytest.mark.parametrize("gram", [True, False])
def test_chol_block_matches_plain(card, t, gram):
    times, mask, ls, var = _flat(card, t, 64, t)
    k = kernels.gram(times.double(), ls.double()[:, None, None],
                     variance=var.double()[:, None, None], mask=mask)
    before = chol_block.LAUNCHES
    if gram:
        l, x = chol_block.gram_chol_block(times, mask, ls, var, inverse=True)
    else:
        l, x = chol_block.chol_block(k.float(), inverse=True)
    assert chol_block.LAUNCHES == before + 1
    ref = torch.linalg.cholesky(k)
    err, band = _l_band(l, ref, torch.linalg.cholesky(k.float()))
    assert err <= band
    xref = tri_inv.tri_inv_plain(l.double())
    rel = (torch.linalg.matrix_norm(x.double() - xref)
           / torch.linalg.matrix_norm(xref)).max().item()
    assert rel <= 1e-4
    assert torch.all(torch.triu(l, 1) == 0)
    assert torch.all(torch.triu(x, 1) == 0)


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


def test_panel_kernels_match_plain(card):
    t, o, w, n = 320, 128, 128, 8
    times, mask, ls, var = _flat(card, 9, n, t)
    rng = np.random.default_rng(3)
    l0 = torch.tensor(rng.standard_normal((n, t, t)), dtype=torch.float32,
                      device=card)
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
