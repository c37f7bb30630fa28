"""Parity of the port's GP machinery (``gpvae_tpu_torch.gp``,
``ops.chol``, ``ops.logdet``) with the JAX package, on the CPU.

float64 against the JAX package's CPU default route (solve-form KL, XLA
Cholesky and triangular solves) to 1e-9 relative; float32 against its
TPU route (``FORCE_INVERSE_PATH`` / ``impl="fused"``: the Pallas kernels
in interpret mode).  The port always takes the inverse route.  Where the
JAX code pins float32 inside a float64 computation, the float64 reference
is named at the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import gp as jgp
from gpvae_tpu import kernels as jkernels
from gpvae_tpu.ops import chol as jchol
from gpvae_tpu.ops import logdet as jlogdet
from gpvae_tpu_torch import gp as tgp
from gpvae_tpu_torch.ops import chol as tchol
from gpvae_tpu_torch.ops import logdet as tlogdet

FP64_REL = 1e-9
# float32 against the JAX kernel route: both sides round the same
# products in another order; values and gradients to 2e-4 relative
FP32_REL = 2e-4


@pytest.fixture
def jax_inverse_route():
    """The JAX package's TPU route on the CPU: its KLs take the Pallas
    triangular inverse (interpret mode), as tests/test_inverse_path.py."""
    prev = jgp.FORCE_INVERSE_PATH
    jgp.FORCE_INVERSE_PATH = True
    try:
        yield
    finally:
        jgp.FORCE_INVERSE_PATH = prev


def _inputs(seed, b, t, z=2):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 45.0, (b, t)), axis=-1)
    mask = np.ones((b, t), bool)
    mask[0, (2 * t) // 3:] = False
    mask[-1, 1::4] = False
    mu = rng.standard_normal((b, t, z)) * mask[..., None]
    return times, mask, mu


def _factors(times, mask, ls):
    """float64 factors from the JAX default route (numpy)."""
    return np.asarray(jnp.linalg.cholesky(jkernels.gram_bank(
        jnp.asarray(times), jnp.asarray(ls), mask=jnp.asarray(mask))))


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def test_logdet_from_chol_matches_jax_fp64():
    times, mask, _ = _inputs(0, 3, 12)
    l = _factors(times, mask, np.array([2.0, 5.0]))
    ref = jlogdet.logdet_from_chol(jnp.asarray(l))
    got = tlogdet.logdet_from_chol(torch.tensor(l))
    assert got.shape == (3, 2)
    assert _rel_err(got.numpy(), ref) <= FP64_REL


@pytest.mark.parametrize("t", [8, 45])
def test_gp_kl_matches_jax_fp64(t):
    times, mask, mu = _inputs(t, 3, t)
    l_q = _factors(times, mask, np.array([2.0, 5.0]))
    l_p = _factors(times, mask, np.array([9.0, 3.0]))
    ref = jgp.gp_kl(jnp.asarray(mu), jnp.asarray(l_q), jnp.asarray(l_p),
                    jnp.asarray(mask))
    got = tgp.gp_kl(torch.tensor(mu), torch.tensor(l_q), torch.tensor(l_p),
                    torch.tensor(mask))
    assert got.shape == (3, 2)
    assert _rel_err(got.numpy(), ref) <= FP64_REL


def test_gp_kl_shared_factor_matches_jax_fp64():
    times, _, mu = _inputs(1, 4, 10)
    full = np.ones((1, 10), bool)
    l_q = _factors(times[:1], full, np.array([2.0, 4.0]))
    l_p = _factors(times[:1], full, np.array([1.0, 1.5]))
    ref = jgp.gp_kl(jnp.asarray(mu), jnp.asarray(l_q), jnp.asarray(l_p))
    got = tgp.gp_kl(torch.tensor(mu), torch.tensor(l_q), torch.tensor(l_p))
    assert got.shape == (4, 2)
    assert _rel_err(got.numpy(), ref) <= FP64_REL


@pytest.mark.parametrize("t", [8, 45])
def test_gp_kl_matches_jax_inverse_route_fp32(t, jax_inverse_route):
    times, mask, mu = _inputs(50 + t, 3, t)
    l_q = _factors(times, mask, np.array([2.0, 5.0])).astype(np.float32)
    l_p = _factors(times, mask, np.array([9.0, 3.0])).astype(np.float32)
    mu = mu.astype(np.float32)
    ref = jgp.gp_kl(jnp.asarray(mu), jnp.asarray(l_q), jnp.asarray(l_p),
                    jnp.asarray(mask))
    got = tgp.gp_kl(torch.tensor(mu), torch.tensor(l_q), torch.tensor(l_p),
                    torch.tensor(mask))
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), ref) <= FP32_REL


# gp.gp_sample's einsum asks for float32 results (preferred_element_type,
# gpvae_tpu/gp.py:546-553), so its float64 draw carries float32 rounding
SAMPLE_VS_JAX_REL = 1e-6


def test_gp_sample_matches_jax_with_injected_eps():
    s, b, t, z = 3, 3, 11, 2
    times, mask, mu = _inputs(2, b, t)
    l_q = _factors(times, mask, np.array([2.0, 5.0]))
    key = jax.random.key(5)
    ref = jgp.gp_sample(key, jnp.asarray(mu), jnp.asarray(l_q), s,
                        jnp.asarray(mask))
    # gp_sample draws its noise as normal(key, (S, B, Z, T), mu.dtype)
    eps = np.asarray(jax.random.normal(key, (s, b, z, t), jnp.float64))
    got = tgp.gp_sample(torch.tensor(mu), torch.tensor(l_q), s,
                        torch.tensor(mask), eps=torch.tensor(eps))
    assert got.shape == (s, b, t, z)
    assert _rel_err(got.numpy(), ref) <= SAMPLE_VS_JAX_REL
    exact = (mu[None] + np.einsum("bzij,sbzj->sbiz", l_q, eps)) * mask[
        None, :, :, None]
    assert _rel_err(got.numpy(), exact) <= FP64_REL
    # a shared factor broadcasts over the batch
    ref1 = jgp.gp_sample(key, jnp.asarray(mu), jnp.asarray(l_q[:1]), s)
    got1 = tgp.gp_sample(torch.tensor(mu), torch.tensor(l_q[:1]), s,
                         eps=torch.tensor(eps))
    assert _rel_err(got1.numpy(), ref1) <= SAMPLE_VS_JAX_REL
    with pytest.raises(ValueError, match="eps must be"):
        tgp.gp_sample(torch.tensor(mu), torch.tensor(l_q), 2,
                      eps=torch.tensor(eps))


def test_gp_sample_draws_from_a_generator():
    times, mask, mu = _inputs(3, 2, 9)
    l_q = torch.tensor(_factors(times, mask, np.array([2.0, 5.0])))
    draw = [tgp.gp_sample(torch.tensor(mu), l_q, 2, torch.tensor(mask),
                          generator=torch.Generator().manual_seed(0))
            for _ in range(2)]
    torch.testing.assert_close(draw[0], draw[1], rtol=0, atol=0)
    assert torch.all(draw[0][:, ~torch.tensor(mask)] == 0)


def _cholesky_vjp_fp64(l, l_bar):
    """float64 reference for K_bar: JAX's own derivative of
    ``jnp.linalg.cholesky`` (symmetrized input) at ``K = L L^T``.  The
    package's ``cholesky_bwd_from_l`` cannot serve here: it pins its
    ``phi`` product to float32 (gpvae_tpu/ops/chol.py:603), which its
    float64 solve then refuses."""
    k = jnp.einsum("...ij,...kj->...ik", jnp.asarray(l), jnp.asarray(l))
    _, vjp = jax.vjp(jnp.linalg.cholesky, k)
    return vjp(jnp.asarray(l_bar))[0]


@pytest.mark.parametrize("t", [8, 45, 64])
def test_cholesky_bwd_from_l_matches_jax_fp64(t):
    times, mask, _ = _inputs(70 + t, 2, t)
    l = _factors(times, mask, np.array([2.0, 5.0]))
    l_bar = np.tril(np.random.default_rng(t).standard_normal(l.shape))
    ref = _cholesky_vjp_fp64(l, l_bar)
    got = tchol.cholesky_bwd_from_l(torch.tensor(l), torch.tensor(l_bar))
    assert _rel_err(got.numpy(), ref) <= FP64_REL
    np.testing.assert_allclose(got.numpy(), np.swapaxes(got.numpy(), -1, -2),
                               rtol=0, atol=1e-12 * np.abs(got.numpy()).max())


def test_cholesky_bwd_from_l_matches_jax_fp32():
    """The package's own backward (its solve route on the CPU)."""
    t = 45
    times, mask, _ = _inputs(90, 2, t)
    l = _factors(times, mask, np.array([2.0, 5.0])).astype(np.float32)
    l_bar = np.tril(np.random.default_rng(1).standard_normal(l.shape)).astype(
        np.float32)
    ref = jchol.cholesky_bwd_from_l(jnp.asarray(l), jnp.asarray(l_bar))
    got = tchol.cholesky_bwd_from_l(torch.tensor(l), torch.tensor(l_bar))
    assert _rel_err(got.numpy(), ref) <= FP32_REL


# the logdet's cotangent folded into the Cholesky backward against the
# same cotangent as a dense diagonal L_bar: one algebra, float64 rounding
FOLD_REL = 1e-10


@pytest.mark.parametrize("t", [45, 256])
def test_cholesky_bwd_from_l_folds_the_logdet_cotangent(t):
    """``logdet_bar=g`` gives ``K_bar`` of ``L_bar + diag(2 g / L_ii)``,
    on the plain route (T=45) and the 2x2-blocked one (T=256); JAX's
    derivative of ``jnp.linalg.cholesky`` on that dense sum is the float64
    reference (the package's ``cholesky_bwd_from_l`` pins float32: see
    ``_cholesky_vjp_fp64``), the package's own function the float32 one."""
    times, mask, _ = _inputs(200 + t, 2, t)
    l = _factors(times, mask, np.array([2.0, 5.0]))
    rng = np.random.default_rng(t)
    l_bar = np.tril(rng.standard_normal(l.shape))
    g = rng.standard_normal(l.shape[:-2])
    dense = l_bar + 2.0 * g[..., None, None] * np.eye(t) / np.diagonal(
        l, axis1=-2, axis2=-1)[..., None, :]
    got = tchol.cholesky_bwd_from_l(torch.tensor(l), torch.tensor(l_bar),
                                    logdet_bar=torch.tensor(g)).numpy()
    want = tchol.cholesky_bwd_from_l(torch.tensor(l),
                                     torch.tensor(dense)).numpy()
    assert _rel_err(got, want) <= FOLD_REL
    assert _rel_err(got, _cholesky_vjp_fp64(l, dense)) <= FOLD_REL
    # the logdet alone: K_bar = g K^{-1}
    alone = tchol.cholesky_bwd_from_l(torch.tensor(l), None,
                                      logdet_bar=torch.tensor(g)).numpy()
    assert _rel_err(alone, g[..., None, None] * np.linalg.inv(
        l @ np.swapaxes(l, -1, -2))) <= FOLD_REL
    f32 = np.float32
    ref = jchol.cholesky_bwd_from_l(jnp.asarray(l, f32),
                                    jnp.asarray(dense, f32))
    got32 = tchol.cholesky_bwd_from_l(
        torch.tensor(l, dtype=torch.float32),
        torch.tensor(l_bar, dtype=torch.float32),
        logdet_bar=torch.tensor(g, dtype=torch.float32))
    assert _rel_err(got32.numpy(), ref) <= FP32_REL


def _kl_fold(times, mask, mu, ls, var, *, fold):
    """Sum of ``gp_kl`` over a stacked bank's halves, with the logdets
    from the factorization's own node (``fold``) or from the factors,
    and its gradients with respect to lengthscales and variance."""
    z = mu.shape[-1]
    lt = torch.tensor(ls).requires_grad_(True)
    vt = torch.tensor(var).requires_grad_(True)
    bank = dict(mask=torch.tensor(mask), variance=vt)
    if fold:
        l, ld = tgp._chol_gram_bank_logdet(torch.tensor(times), lt, **bank)
        given = dict(logdet_q=ld[:, :z], logdet_p=ld[:, z:])
    else:
        l, given = tgp.chol_gram_bank(torch.tensor(times), lt, **bank), {}
    kl = tgp.gp_kl(torch.tensor(mu), l[:, :z], l[:, z:], torch.tensor(mask),
                   **given)
    kl.sum().backward()
    return kl.detach().numpy(), lt.grad.numpy(), vt.grad.numpy()


@pytest.mark.parametrize("t", [45, 256])
def test_gp_kl_with_given_logdets_matches_fp64(t):
    times, mask, mu = _inputs(230 + t, 2, t)
    ls, var = np.array([2.0, 5.0, 9.0, 3.0]), np.array([1.0, 0.7, 1.3, 0.9])
    got = _kl_fold(times, mask, mu, ls, var, fold=True)
    want = _kl_fold(times, mask, mu, ls, var, fold=False)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= FOLD_REL


def _chol_gram_bank_loss(times, mask, ls, var, w, *, impl=None):
    """Values of ``L`` and gradients of ``sum(L * w)`` with respect to
    lengthscales and variance, through both packages.  ``impl="fp64"`` is
    JAX's autodiff of ``jnp.linalg.cholesky(gram_bank(...))``: the
    package's ``chol_gram_bank`` backward cannot run in float64 (see
    ``_cholesky_vjp_fp64``)."""
    if impl is not None:
        def f(ls_, var_):
            if impl == "fp64":
                l = jnp.linalg.cholesky(jkernels.gram_bank(
                    jnp.asarray(times), ls_, mask=jnp.asarray(mask),
                    variance=var_))
            else:
                l = jgp.chol_gram_bank(jnp.asarray(times), ls_,
                                       mask=jnp.asarray(mask), variance=var_,
                                       impl=impl)
            return jnp.sum(l * jnp.asarray(w)), l
        (_, l), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(ls), jnp.asarray(var))
        return np.asarray(l), [np.asarray(g) for g in grads]
    lt = torch.tensor(ls).requires_grad_(True)
    vt = torch.tensor(var).requires_grad_(True)
    l = tgp.chol_gram_bank(torch.tensor(times), lt, mask=torch.tensor(mask),
                           variance=vt)
    torch.sum(l * torch.tensor(w)).backward()
    return l.detach().numpy(), [lt.grad.numpy(), vt.grad.numpy()]


@pytest.mark.parametrize("t", [8, 45])
def test_chol_gram_bank_values_and_grads_match_jax_fp64(t):
    times, mask, _ = _inputs(110 + t, 3, t)
    ls, var = np.array([2.0, 5.0, 9.0, 3.0]), np.array([1.0, 0.7, 1.3, 0.9])
    w = np.random.default_rng(t).standard_normal((3, 4, t, t))
    ref_l, ref_g = _chol_gram_bank_loss(times, mask, ls, var, w, impl="fp64")
    got_l, got_g = _chol_gram_bank_loss(times, mask, ls, var, w)
    assert _rel_err(got_l, ref_l) <= FP64_REL
    for g, r in zip(got_g, ref_g):
        assert g.shape == r.shape
        assert _rel_err(g, r) <= FP64_REL


def test_chol_gram_bank_matches_jax_kernel_route_fp32():
    t = 45
    f32 = np.float32
    times, mask, _ = _inputs(150, 2, t)
    ls, var = np.array([9.0, 3.0, 9.0, 3.0], f32), np.ones(4, f32)
    w = np.random.default_rng(0).standard_normal((2, 4, t, t)).astype(f32)
    ref_l, ref_g = _chol_gram_bank_loss(times.astype(f32), mask, ls, var, w,
                                        impl="fused")
    got_l, got_g = _chol_gram_bank_loss(times.astype(f32), mask, ls, var, w)
    # L itself: two float32 factorizations, see test_torch_kernels
    assert np.abs(got_l - ref_l).max() <= 1e-4
    for g, r in zip(got_g, ref_g):
        assert _rel_err(g, r) <= FP32_REL


def test_chol_gram_bank_times_get_no_gradient():
    """Without ``diff_times`` the times get no gradient (the JAX package
    returns an explicit zero); with it they do, and the lengthscales'
    gradient is the same (tests/test_torch_zoo.py holds the times'
    gradient against JAX)."""
    times, mask, _ = _inputs(7, 2, 6)
    tt = torch.tensor(times).requires_grad_(True)
    ls = torch.tensor([2.0, 5.0], dtype=torch.float64, requires_grad=True)
    tgp.chol_gram_bank(tt, ls, mask=torch.tensor(mask)).sum().backward()
    assert tt.grad is None and ls.grad is not None
    ls_grad = ls.grad.clone()
    ls.grad = None
    tgp.chol_gram_bank(tt, ls, mask=torch.tensor(mask),
                       diff_times=True).sum().backward()
    assert tt.grad is not None and bool(torch.isfinite(tt.grad).all())
    assert torch.allclose(ls.grad, ls_grad, rtol=1e-14, atol=0)
