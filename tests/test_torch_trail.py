"""Parity of the port's Cholesky method menu with the JAX package, on the
CPU: ``ops.trail`` (the right-looking step, TPU kernel B23
``pallas_trail.panel_trailing_update``), ``ops.blocked.
cholesky_blocked_fused``, every method name of ``ops.chol.cholesky`` and
its gradient, ``method=`` of ``chol_logdet``/``slogdet_psd``, and
``gp.chol_gram_bank(impl=...)``.

The port runs its plain route here (the CUDA kernels are held against the
same plain versions on the card, ``tests/test_torch_cuda.py``), on numpy
inputs from a seed.  References:
* the JAX package's Pallas kernel in interpret mode and its
  ``cholesky_blocked_fused`` in float32, against float64 (the JAX test's
  5e-5 of the largest entry, ``tests/test_ops.py``);
* the JAX package's and numpy's float64 factorizations, against the port
  in float64, to 1e-9 relative.
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
from gpvae_tpu.ops import pallas_trail
from gpvae_tpu_torch import gp
from gpvae_tpu_torch.ops import blocked, chol, logdet, trail

FP64_REL = 1e-9
# a float32 factorization against float64, of the largest entry, on the
# well-conditioned random_psd banks (tests/test_ops.py:211,347)
FUSED_FP32_REL = 5e-5
# one float32 step (depth nb <= 128 products) against float64, of the
# largest entry of its result
STEP_FP32_REL = 1e-5


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def random_psd(rng, n, t):
    """``A A^T + T I``, as ``tests/test_ops.py``."""
    a = rng.standard_normal((n, t, t))
    return a @ np.swapaxes(a, -1, -2) + t * np.eye(t)


# ---------------------------------------------------------------------------
# ops.trail: one right-looking step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,r", [(128, 256), (64, 192)])
def test_panel_trailing_update_matches_the_tpu_kernel(nb, r):
    """B23 in interpret mode (float32) and the port's plain step in float32,
    each against the port's float64 step on the same float32 inputs: the
    panel whole, the downdate on ``trail.lower_tiles`` (which hold the
    lower triangle and lie in the TPU kernel's lower nb-block triangle)."""
    rng = np.random.default_rng(nb + r)
    s = random_psd(rng, 2, r).astype(np.float32)
    ld = np.linalg.cholesky(s[:, :nb, :nb].astype(np.float64))
    inv = np.linalg.inv(ld).astype(np.float32)
    col_x, s_new = trail.panel_trailing_update(_t(s), _t(inv))
    jx, js = pallas_trail.panel_trailing_update(jnp.asarray(s),
                                                jnp.asarray(inv))
    px, ps = trail.panel_trailing_update(_t(s, torch.float32),
                                         _t(inv, torch.float32))
    assert col_x.shape == (2, r - nb, nb) and s_new.shape == (2, r - nb,
                                                             r - nb)
    low = trail.lower_tiles(r - nb).numpy()
    for x, sn in ((np.asarray(jx), np.asarray(js)), (px.numpy(), ps.numpy())):
        assert _rel(x, col_x) <= STEP_FP32_REL
        assert _rel(sn[:, low], s_new[:, low]) <= STEP_FP32_REL
    # the float64 step against its definition
    want_x = s[:, nb:, :nb] @ np.swapaxes(inv, -1, -2).astype(np.float64)
    assert _rel(col_x.numpy(), want_x) <= FP64_REL
    want_s = s[:, nb:, nb:] - want_x @ np.swapaxes(want_x, -1, -2)
    assert _rel(s_new.numpy()[:, low], want_s[:, low]) <= FP64_REL


@pytest.mark.parametrize("nb", trail.WIDTHS)
def test_trail_panel_reads_only_the_lower_triangle_of_ld_inv(nb):
    """The panel step takes ``Ld^{-1}`` as lower triangular: whatever lies
    above its diagonal is not read, by the kernel nor by its plain
    version."""
    rng = np.random.default_rng(nb)
    t = 3 * nb
    s = random_psd(rng, 2, t)
    inv = np.linalg.inv(np.linalg.cholesky(s[:, :nb, :nb]))
    inv = np.tril(inv)
    noisy = inv + np.triu(rng.standard_normal(inv.shape), 1)
    want, got = _t(s), _t(s)
    trail.trail_panel(want, _t(inv), 0)
    trail.trail_panel(got, _t(noisy), 0)
    assert torch.equal(got, want)
    x = s[:, nb:, :nb] @ np.swapaxes(inv, -1, -2)
    assert _rel(got[:, nb:, :nb].numpy(), x) <= FP64_REL
    assert torch.all(got[:, :nb, nb:] == 0)


def test_lower_tiles_hold_the_lower_triangle():
    low = trail.lower_tiles(300)
    assert bool(low[torch.tril_indices(300, 300).unbind()].all())
    assert bool(low[:64, :64].all()) and not bool(low[:64, 64:].any())
    assert bool(low[299, :].all())


def test_panel_trailing_update_refuses_a_square_without_trailing_rows():
    with pytest.raises(ValueError, match="R > 128"):
        trail.panel_trailing_update(torch.zeros((1, 128, 128)),
                                    torch.zeros((1, 128, 128)))


# ---------------------------------------------------------------------------
# ops.blocked.cholesky_blocked_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,nb", [(256, 128), (200, 128), (192, 64)])
def test_cholesky_blocked_fused_matches_jax(t, nb):
    """JAX's ``cholesky_blocked_fused`` in float32 (its Pallas step in
    interpret mode; T=200 padded to 256 with identity there, a ragged last
    block here) and the port's float32 plain route within 5e-5 of the
    float64 factor; the port in float64 within 1e-9 of numpy; the strict
    upper triangle exactly 0 and K unchanged."""
    rng = np.random.default_rng(t + nb)
    k = random_psd(rng, 2, t)
    want = np.linalg.cholesky(k)
    jl = jchol.cholesky_blocked_fused(jnp.asarray(k, jnp.float32),
                                      block_size=nb)
    assert _rel(jl, want) <= FUSED_FP32_REL
    kt = _t(k)
    got = blocked.cholesky_blocked_fused(kt, block_size=nb)
    assert _rel(got.numpy(), want) <= FP64_REL
    assert torch.all(torch.triu(got, 1) == 0)
    assert torch.equal(kt, _t(k))
    got32 = blocked.cholesky_blocked_fused(_t(k, torch.float32),
                                           block_size=nb)
    assert _rel(got32.numpy(), want) <= FUSED_FP32_REL


def test_cholesky_blocked_fused_reads_only_the_lower_triangle():
    rng = np.random.default_rng(1)
    k = random_psd(rng, 2, 300)
    upper = np.triu(np.full((300, 300), 1e3), 1)
    got = blocked.cholesky_blocked_fused(_t(k + upper))
    assert _rel(got.numpy(), np.linalg.cholesky(k)) <= FP64_REL


# ---------------------------------------------------------------------------
# ops.chol.cholesky(method=...)
# ---------------------------------------------------------------------------

def test_the_method_menu_is_the_jax_packages():
    """Every name ``_cholesky_fwd_impl`` dispatches on, read from its
    source, and no other."""
    import inspect

    src = inspect.getsource(jchol._cholesky_fwd_impl)
    names = {m for m in chol.METHODS if f'"{m}"' in src}
    assert names == set(chol.METHODS)


@pytest.mark.parametrize("method", chol.METHODS)
def test_every_cholesky_method_matches_jax_fp64(method):
    """Each method on a [B, Z, T, T] bank in float64 against JAX's
    ``method="xla"`` (T=40 for ``"pallas"``, else a ragged T=200)."""
    t = 40 if method == "pallas" else 200
    rng = np.random.default_rng(len(method))
    k = random_psd(rng, 4, t).reshape(2, 2, t, t)
    got = chol.cholesky(_t(k), method=method)
    want = np.asarray(jchol.cholesky(jnp.asarray(k), method="xla"))
    assert got.shape == k.shape and got.is_contiguous()
    assert _rel(got.numpy(), want) <= FP64_REL
    assert torch.all(torch.triu(got, 1) == 0)


def test_cholesky_methods_refuse_what_jax_refuses():
    k = random_psd(np.random.default_rng(0), 1, 80)
    for bad in ("bogus", "Auto"):
        with pytest.raises(ValueError, match="unknown cholesky method"):
            jchol.cholesky(jnp.asarray(k), method=bad)
        with pytest.raises(ValueError, match="unknown cholesky method"):
            chol.cholesky(_t(k), method=bad)
    # "pallas" is the T <= 64 lane kernel in both
    with pytest.raises(ValueError, match="T=80 > 64"):
        jchol.cholesky(jnp.asarray(k, jnp.float32), method="pallas")
    with pytest.raises(ValueError, match="T=80 > 64"):
        chol.cholesky(_t(k), method="pallas")


def test_cholesky_xla_gives_nan_where_not_positive_definite():
    k = random_psd(np.random.default_rng(2), 3, 70)
    k[1, 60, 60] = -1e3
    got = chol.cholesky(_t(k), method="xla")
    assert torch.isnan(got[1]).all()
    assert _rel(got[[0, 2]].numpy(), np.linalg.cholesky(k[[0, 2]])) <= FP64_REL


def test_cholesky_gradient_through_blocked_fused_matches_xla():
    """The shared reverse mode (tests/test_ops.py:215-228): in float32
    through ``"blocked_fused"`` against ``"xla"`` in both packages, the
    JAX test's rtol 2e-3, atol 2e-4."""
    rng = np.random.default_rng(3)
    k = random_psd(rng, 2, 160).astype(np.float32)
    w = rng.standard_normal((160, 160)).astype(np.float32)

    def grad(method):
        kt = _t(k, torch.float32).requires_grad_(True)
        torch.sum(chol.cholesky(kt, method=method)
                  * _t(w, torch.float32)).backward()
        return kt.grad.numpy()

    want = np.asarray(jax.grad(lambda kk: jnp.sum(
        jchol.cholesky(kk, method="xla") * w))(jnp.asarray(k)))
    g_fused = grad("blocked_fused")
    for ref in (grad("xla"), want):
        np.testing.assert_allclose(g_fused, ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("method", ["xla", "blocked_fused",
                                    "blocked_fused_64"])
def test_chol_logdet_and_slogdet_psd_take_a_method(method):
    k = random_psd(np.random.default_rng(4), 3, 256)
    l, ld = logdet.chol_logdet(_t(k), method=method)
    jl, jld = jlogdet.chol_logdet(jnp.asarray(k), method="xla")
    assert _rel(l.numpy(), jl) <= FP64_REL
    assert _rel(ld.numpy(), jld) <= FP64_REL
    assert _rel(logdet.slogdet_psd(_t(k), method=method).numpy(),
                jlogdet.slogdet_psd(jnp.asarray(k), method="xla")) <= FP64_REL
    with pytest.raises(ValueError, match="unknown cholesky method"):
        logdet.slogdet_psd(_t(k), method="bogus")


# ---------------------------------------------------------------------------
# gp.chol_gram_bank(impl=...)
# ---------------------------------------------------------------------------

def _gram_inputs(t=100, b=2):
    rng = np.random.default_rng(t)
    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    mask = rng.random((b, t)) > 0.3
    mask[:, 0] = True
    return times, mask, np.array([2.0, 9.0]), np.array([0.75, 1.25])


@pytest.mark.parametrize("impl", ["auto", "fused", "xla"])
def test_chol_gram_bank_impl_matches_jax_fp64(impl):
    """Values of every ``impl`` against JAX's ``impl="xla"`` (the composed
    route) in float64; ``"xla"``'s gradients, the times' too, against JAX's
    autodiff of the composed route in float64."""
    times, mask, ls, var = _gram_inputs()
    w = np.random.default_rng(0).standard_normal((2, 2, 100, 100))
    want = np.asarray(jgp.chol_gram_bank(
        jnp.asarray(times), jnp.asarray(ls), mask=jnp.asarray(mask),
        variance=jnp.asarray(var), impl="xla"))
    tt, lt, vt = (_t(x).requires_grad_(True) for x in (times, ls, var))
    got = gp.chol_gram_bank(tt, lt, mask=_t(mask, torch.bool), variance=vt,
                            impl=impl)
    assert got.shape == (2, 2, 100, 100)
    assert _rel(got.detach().numpy(), want) <= FP64_REL
    if impl != "xla":
        return
    torch.sum(got * _t(w)).backward()

    def loss(tj, lj, vj):
        l = jnp.linalg.cholesky(jkernels.gram_bank(
            tj, lj, mask=jnp.asarray(mask), variance=vj))
        return jnp.sum(l * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(times), jnp.asarray(ls), jnp.asarray(var))
    for g, ref in zip((tt.grad, lt.grad, vt.grad), grads):
        assert _rel(g.numpy(), ref) <= 1e-8


def test_chol_gram_bank_refuses_an_unknown_impl_as_jax_does():
    times, _, ls, _ = _gram_inputs(t=10)
    with pytest.raises(ValueError, match="impl must be"):
        jgp.chol_gram_bank(jnp.asarray(times), jnp.asarray(ls), impl="bogus")
    with pytest.raises(ValueError, match="impl must be"):
        gp.chol_gram_bank(_t(times), _t(ls), impl="bogus")
