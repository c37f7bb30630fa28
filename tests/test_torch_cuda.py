"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from gpvae_tpu_torch import configs, kernels, train
from gpvae_tpu_torch.data import Batcher, generate_toy_data, toy_to_masked_batch
from gpvae_tpu_torch.models import GPVAE
from gpvae_tpu_torch.ops import gram_chol, tri_inv

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
    with pytest.raises(NotImplementedError, match="slice 2"):
        gram_chol.gram_chol_fused(torch.zeros((2, 65), device=card),
                                  torch.ones(2, device=card))
    with pytest.raises(NotImplementedError, match="slice 2"):
        tri_inv.tri_inv(torch.eye(65, device=card)[None])
    with pytest.raises(TypeError, match="float32"):
        tri_inv.tri_inv_cuda(torch.eye(4, dtype=torch.float64,
                                       device=card)[None])
    with pytest.raises(ValueError, match="contiguous"):
        tri_inv.tri_inv_cuda(torch.eye(4, device=card)[None].transpose(1, 2)
                             .expand(2, 4, 4))


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
