"""The Cholesky backward's three passes (``ops.chol_bwd``) on the CPU: the
plain version against ``ops.chol``'s 2x2-blocked products in float64, and
the rule that decides which calls take the card's kernel.

No JAX: ``ops.chol``'s blocked route is held against JAX in
``tests/test_torch_gp.py`` and ``tests/test_torch_large_t.py``.
"""
import numpy as np
import pytest
import torch

from gpvae_tpu_torch.ops import chol, chol_bwd, tri_inv

# two float64 routes through the same algebra, rounded in another order
FP64_REL = 1e-10


def _case(seed, t, n=1, dtype=torch.float64):
    """A well-conditioned lower factor ``[n, t, t]``, a lower cotangent and
    a logdet cotangent per matrix, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    l = (np.tril(rng.standard_normal((n, t, t))) / np.sqrt(t)
         + np.eye(t) * rng.uniform(1.0, 2.0, (n, 1, t)))
    l_bar = np.tril(rng.standard_normal((n, t, t)))
    g = rng.standard_normal(n)
    return (torch.tensor(l, dtype=dtype), torch.tensor(l_bar, dtype=dtype),
            torch.tensor(g, dtype=dtype))


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("given", ["l_bar", "l_bar and logdet", "logdet"])
@pytest.mark.parametrize("t", [256, 512, 1024])
def test_plain_passes_match_the_blocked_products(t, given):
    """With the factor's cotangent, the logdet's, or both."""
    l, l_bar, g = _case(t + len(given), t)
    l_bar = l_bar if "l_bar" in given else None
    g = g if "logdet" in given else None
    want = chol.cholesky_bwd_from_l(l, l_bar, logdet_bar=g)
    got = chol_bwd.chol_bwd_plain(l, l_bar, tri_inv.tri_inv(l), g)
    assert _rel(got, want) <= FP64_REL
    assert torch.equal(got, got.mT)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as a CUDA one, and the kernel's wrapper is its
    plain version with a count of calls (``X`` by the plain inverse)."""
    calls = []

    def kernel(l, l_bar, x, logdet_bar=None):
        calls.append(l.shape)
        return chol_bwd.chol_bwd_plain(l, l_bar, x, logdet_bar)

    monkeypatch.setattr(chol_bwd.dispatch, "on_cuda", lambda t: True)
    monkeypatch.setattr(chol, "tri_inv", tri_inv.tri_inv_plain)
    monkeypatch.setattr(chol_bwd, "chol_bwd_cuda", kernel)
    return calls


# (dtype, T, with a factor's cotangent): whether the kernel takes it
RULE = [
    (torch.float32, 256, True, True),
    (torch.float32, 1024, True, True),
    (torch.float32, 384, True, True),
    (torch.float32, 256, False, False),  # the logdet alone
    (torch.float64, 256, True, False),
    (torch.float32, 128, True, True),    # one tile a matrix
    (torch.float32, 100, True, False),
    (torch.float32, 320, True, False),   # ragged: not a multiple of 128
    (torch.float32, 300, True, False),
]


@pytest.mark.parametrize("dtype,t,with_l_bar,takes", RULE)
def test_the_rule_that_chooses_the_kernel(fake_card, dtype, t, with_l_bar,
                                          takes):
    l, l_bar, g = _case(t, t, dtype=dtype)
    l_bar = l_bar if with_l_bar else None
    assert chol_bwd.engaged(l, l_bar) == takes
    got = chol.cholesky_bwd_from_l(l, l_bar, logdet_bar=g)
    assert fake_card == ([l.shape] if takes else [])
    if takes:  # the kernel's place holds the same function
        want = chol_bwd.chol_bwd_plain(l.double(), l_bar.double(),
                                       tri_inv.tri_inv_plain(l.double()),
                                       g.double())
        assert _rel(got.double(), want) <= 1e-4


@pytest.mark.parametrize("t", [256, 384])
def test_cpu_tensors_never_take_the_kernel(monkeypatch, t):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(chol_bwd, "chol_bwd_cuda", refuse)
    l, l_bar, g = _case(t, t, dtype=torch.float32)
    assert not chol_bwd.engaged(l, l_bar)
    chol.cholesky_bwd_from_l(l, l_bar, logdet_bar=g)
