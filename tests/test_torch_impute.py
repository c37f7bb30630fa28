"""Parity of the port's imputation path with the JAX package, on the CPU:
``kernels.cross_gram``, the pre-built-gram factorization
(``ops.blocked.hist_panel`` and ``cholesky_inplace``, ``ops.chol.cholesky``
and its gradient), ``ops.trsm.solve_triangular``, ``ops.logdet``'s
``chol_logdet``/``slogdet_psd``, the GP posterior (``gp.
posterior_conditional``, ``posterior_sample``, ``prior_sample``), the
``analysis`` module on a model whose flax parameters were carried over,
checkpoints, and ``evaluate --device cpu``.

Each port function runs its plain route here on numpy inputs from a seed
(the CUDA kernels are held against the same plain versions on the card,
``tests/test_torch_cuda.py``), and every random draw (noise, kept masks)
is made once and handed to both packages.  References:
* the JAX package's float64 routes, against the port in float64, to 1e-9
  relative, or 2e-7 where the JAX function pins a product to float32
  (``preferred_element_type=jnp.float32`` in ``gp.posterior_conditional``,
  ``posterior_sample`` and ``prior_sample``: float32's 6e-8 rounding);
* its Pallas kernels in interpret mode, which compute in float32, against
  the port's float32 plain route (rtol named at each use).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import analysis as janalysis
from gpvae_tpu import configs as jconfigs
from gpvae_tpu import gp as jgp
from gpvae_tpu import kernels as jkernels
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.ops import chol as jchol
from gpvae_tpu.ops import logdet as jlogdet
from gpvae_tpu.ops import pallas_big, pallas_left
from gpvae_tpu.ops import trsm as jtrsm
from gpvae_tpu_torch import analysis, convert, gp, kernels, train
from gpvae_tpu_torch.__main__ import main
from gpvae_tpu_torch.data import Batcher, generate_toy_data
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.ops import blocked, chol, logdet, trsm
from gpvae_tpu_torch.ops.tri_inv import tri_inv_plain

FP64_REL = 1e-9
# a JAX float64 function whose products are pinned to float32
FP32_PINNED_REL = 2e-7
# the float32 history product (depth <= 256, HIGHEST on the JAX side,
# plain float32 matmul here) against each other
HIST_FP32_REL = 1e-5
# a float32 factorization against the float64 one: 2e-4 of the largest
# entry, or 4x the library's own float32 factor (chip_smoke.py's rule)
FACTOR_FP32_REL = 2e-4
VS_LIBRARY = 4.0
# a posterior draw: the JAX S* carries the float32 rounding of A^T A
# (1e-7 absolute), and the factor of S* + jitter I, whose smallest pivots
# are near the noise (1e-3) at kept steps, amplifies it by up to
# 1 / sqrt(pivot)
SAMPLE_REL = 1e-5


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _jit(fn, *args):
    """``fn(*args)`` as one compiled program: on the CPU far cheaper than
    the op-by-op compiles of an eager JAX call."""
    return jax.jit(fn)(*args)


def _grid(seed, b, t, *, hide=0.3):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    mask = rng.random((b, t)) > hide
    mask[:, 0] = True
    return times, mask


def _bank(seed, b, t, *, masked=True, noise=1e-2):
    """A pre-built SPD bank ``[b, 2, t, t]`` (lengthscales 2 and 9), from
    the port's ``gram_bank`` (equal to the JAX package's in float64,
    tests/test_torch_kernels.py)."""
    times, mask = _grid(seed, b, t, hide=0.3 if masked else 0.0)
    return kernels.gram_bank(_t(times), _t([2.0, 9.0]), noise=noise,
                             mask=_t(mask, torch.bool)).numpy()


# ---------------------------------------------------------------------------
# kernels.cross_gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", sorted(kernels.KERNELS))
def test_cross_gram_matches_jax(kernel):
    ta, ma = _grid(1, 3, 20)
    tb, mb = _grid(2, 3, 13)
    ls, var = np.array([2.0, 7.0]), np.array([0.8, 1.3])
    want = jkernels.cross_gram(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(ls), kernel=kernel,
        variance=jnp.asarray(var), mask_a=jnp.asarray(ma),
        mask_b=jnp.asarray(mb))
    got = kernels.cross_gram(_t(ta), _t(tb), _t(ls), kernel=kernel,
                             variance=_t(var), mask_a=_t(ma, torch.bool),
                             mask_b=_t(mb, torch.bool))
    assert got.shape == (3, 2, 20, 13)
    assert _rel(got.numpy(), want) <= FP64_REL
    assert torch.all(got.transpose(0, 1)[:, ~_t(ma, torch.bool)] == 0)
    # per-sequence lengthscales, no masks
    ls_b = np.array([[2.0, 7.0], [3.0, 1.0], [9.0, 4.0]])
    want = jkernels.cross_gram(jnp.asarray(ta), jnp.asarray(tb),
                               jnp.asarray(ls_b), kernel=kernel)
    got = kernels.cross_gram(_t(ta), _t(tb), _t(ls_b), kernel=kernel)
    assert _rel(got.numpy(), want) <= FP64_REL


# ---------------------------------------------------------------------------
# hist_panel: its plain version against the TPU's history kernels
# ---------------------------------------------------------------------------

def _hist_operands(seed, n, t):
    """``K`` an SPD bank and ``L`` its float64 factor, both float32."""
    k = _bank(seed, n // 2, t).reshape(n, t, t)
    return np.linalg.cholesky(k).astype(np.float32), k.astype(np.float32)


@pytest.mark.parametrize("jax_fn,t,block", [
    ("hist_panel", 256, 1), ("hist_panel", 384, 2),
    ("hist_panel_split", 384, 2), ("hist_panel_update", 256, 1),
    ("hist_panel_update", 384, 2)])
def test_hist_panel_matches_the_tpu_history_kernels(jax_fn, t, block):
    """B14 ``pallas_big.hist_panel``, B15 ``hist_panel_split`` and B19
    ``pallas_left.hist_panel_update`` (interpret mode), on the panel of a
    middle block: ``K[:, o:, o:o+128] - L[:, o:, :o] L[:, o:o+128, :o]^T``.
    """
    nb = blocked.NB
    o = block * nb
    l, k = _hist_operands(10 + t + block, 2, t)
    if jax_fn == "hist_panel_update":
        want = pallas_left.hist_panel_update(jnp.asarray(l), jnp.asarray(k),
                                             block)
    elif jax_fn == "hist_panel_split":
        diag, sub = pallas_big.hist_panel_split(jnp.asarray(l),
                                                jnp.asarray(k), block, nb)
        want = jnp.concatenate([diag, sub], axis=1)
    else:
        want = pallas_big.hist_panel(jnp.asarray(l), jnp.asarray(k), block,
                                     nb)
    got = _t(l, torch.float32)
    blocked.hist_panel(got, _t(k, torch.float32), o, o, nb)
    assert _rel(got[:, o:, o:o + nb].numpy(), want) <= HIST_FP32_REL
    # nothing else of L was touched
    untouched = np.ones((t, t), bool)
    untouched[o:, o:o + nb] = False
    np.testing.assert_array_equal(got.numpy()[:, untouched], l[:, untouched])


def test_hist_panel_reads_k_at_a_row_stride():
    """``K`` a view inside a larger buffer (the bank flattened from [B, Z,
    T, T] is another view), a ragged block, and ``r0 > o``."""
    l, k = _hist_operands(3, 2, 300)
    big = np.zeros((2, 310, 320))
    big[:, 5:305, 10:310] = k
    kv = _t(big)[:, 5:305, 10:310]
    got, ref = _t(l), _t(l)
    blocked.hist_panel(got, kv, 280, 256, 44)
    ref[:, 280:, 256:300] = (_t(k)[:, 280:, 256:300]
                             - ref[:, 280:, :256] @ ref[:, 256:300, :256].mT)
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# cholesky of a pre-built matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("t", [45, 100, 200, 256, 300])
def test_cholesky_matches_jax_fp64(t, masked):
    """One ``chol_block`` (T <= 128) or the blocked loop with ``hist_panel``
    (a ragged last block at 200 and 300), against JAX's ``cholesky(method=
    "xla")`` on the [B, Z, T, T] bank; ``k`` comes back unchanged."""
    k = _bank(t, 2, t, masked=masked)
    kt = _t(k)
    l = chol.cholesky(kt)
    want = np.asarray(jchol.cholesky(jnp.asarray(k), method="xla"))
    assert l.shape == k.shape
    assert _rel(l.numpy(), want) <= FP64_REL
    assert torch.all(torch.triu(l, 1) == 0)
    assert torch.equal(kt, _t(k))


@pytest.mark.parametrize("t", [256, 300])
def test_cholesky_fp32_matches_jax_streamed_route(t):
    """In float32 against the JAX package's 64 < T < 768 route,
    ``cholesky_blocked_left_streamed`` (its history panels B19 in
    interpret mode; T=300 padded to 384 with identity there, ragged
    here), both held to the float64 factor."""
    k = _bank(40 + t, 2, t, masked=True).reshape(4, t, t)
    want = np.linalg.cholesky(k)
    lib = torch.linalg.cholesky(_t(k, torch.float32)).numpy()
    band = max(FACTOR_FP32_REL, VS_LIBRARY * _rel(lib, want))
    got = chol.cholesky(_t(k, torch.float32))
    jl = jchol.cholesky_blocked_left_streamed(jnp.asarray(k, jnp.float32))
    assert _rel(got.numpy(), want) <= band
    assert _rel(jl, want) <= band


def test_cholesky_gives_nan_not_an_error_where_not_positive_definite():
    """As ``jnp.linalg.cholesky``: no exception, NaN for the failed matrix,
    the others untouched."""
    k = np.array(_bank(5, 1, 150, masked=False).reshape(2, 150, 150))
    k[1, 140, 140] = -1.0
    l = chol.cholesky(_t(k))
    want = np.asarray(jchol.cholesky(jnp.asarray(k), method="xla"))
    assert np.isnan(want[1][np.tril_indices(150)]).all()
    assert torch.isnan(l[1]).any()
    assert _rel(l[0].numpy(), want[0]) <= FP64_REL


def test_cholesky_gradient_matches_jax():
    """The reverse mode in float32 against JAX's ``cholesky`` on the
    inputs and in the band of tests/test_ops.py (rtol 2e-3, atol 2e-4):
    two random SPD matrices ``A A^T + T I`` of side 200."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 200, 200))
    k = (a @ a.transpose(0, 2, 1) + 200 * np.eye(200)).astype(np.float32)
    w = rng.standard_normal((200, 200)).astype(np.float32)
    want = jax.grad(lambda kk: jnp.sum(jchol.cholesky(kk) * w))(
        jnp.asarray(k))
    kt = _t(k, torch.float32).requires_grad_(True)
    torch.sum(chol.cholesky(kt) * _t(w, torch.float32)).backward()
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)


def test_chol_logdet_and_slogdet_psd_match_jax():
    k = _bank(7, 2, 256)
    l, ld = logdet.chol_logdet(_t(k))
    jl, jld = jlogdet.chol_logdet(jnp.asarray(k), method="xla")
    assert _rel(l.numpy(), jl) <= FP64_REL
    assert _rel(ld.numpy(), jld) <= FP64_REL
    assert _rel(logdet.slogdet_psd(_t(k)).numpy(),
                jlogdet.slogdet_psd(jnp.asarray(k), method="xla")) <= FP64_REL
    assert _rel(ld.numpy(), np.linalg.slogdet(k)[1]) <= FP64_REL


# ---------------------------------------------------------------------------
# solve_triangular
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("left_side", [True, False])
def test_solve_triangular_matches_jax(left_side, transpose_a):
    a = np.linalg.cholesky(_bank(8, 2, 70))
    rng = np.random.default_rng(9)
    b = rng.standard_normal((2, 2, 70, 5) if left_side else (2, 2, 5, 70))
    want = jtrsm.solve_triangular(jnp.asarray(a), jnp.asarray(b),
                                  left_side=left_side,
                                  transpose_a=transpose_a)
    got = trsm.solve_triangular(_t(a), _t(b), left_side=left_side,
                                transpose_a=transpose_a)
    assert _rel(got.numpy(), want) <= FP64_REL
    op = np.swapaxes(a, -1, -2) if transpose_a else a
    np.testing.assert_allclose(op @ got.numpy() if left_side
                               else got.numpy() @ op, b, atol=1e-9)


def test_cho_solve_by_inverse_matches_float64():
    """``(L L^T)^{-1} B`` from one inverse of L, each product refined by
    its residual: in float64 against numpy; in float32 on a dense uniform
    grid (cond(K) ~ 1e5) within 2x the library's substitution error of
    float64."""
    k = _bank(14, 2, 60)
    b = np.random.default_rng(15).standard_normal((2, 2, 60, 3))
    got = trsm.cho_solve_by_inverse(_t(np.linalg.cholesky(k)), _t(b))
    assert _rel(got.numpy(), np.linalg.solve(k, b)) <= FP64_REL
    times = np.linspace(0.0, 60.0, 300)[None]
    k = np.asarray(jkernels.gram_bank(jnp.asarray(times), jnp.asarray(
        [9.0, 3.0]))) + 1e-5 * np.eye(300)
    l32 = torch.linalg.cholesky(_t(k, torch.float32))
    z = _t(np.random.default_rng(16).standard_normal((1, 2, 300, 1)),
           torch.float32)
    want = np.linalg.solve(k, z.numpy())
    sub = torch.cholesky_solve(z, l32)
    assert _rel(trsm.cho_solve_by_inverse(l32, z).numpy(), want) <= (
        2.0 * _rel(sub.numpy(), want))


# ---------------------------------------------------------------------------
# the GP posterior
# ---------------------------------------------------------------------------

def _posterior_inputs(seed, b=2, t=150):
    times, mask = _grid(seed, b, t)
    rng = np.random.default_rng(seed)
    kept = mask & (rng.random(mask.shape) >= 0.5)
    z_obs = rng.standard_normal((b, t, 2))
    return times, kept, z_obs, np.array([3.0, 9.0])


@pytest.mark.parametrize("with_cov", [True, False])
def test_posterior_conditional_matches_jax(with_cov):
    times, kept, z_obs, ls = _posterior_inputs(11)
    tq = times[:, ::2] + 0.25
    want = _jit(lambda *a: jgp.posterior_conditional(
        *a[:4], mask_obs=a[4], with_cov=with_cov),
        times, z_obs, tq, ls, kept)
    got = gp.posterior_conditional(
        _t(times), _t(z_obs), _t(tq), _t(ls), mask_obs=_t(kept, torch.bool),
        with_cov=with_cov)
    assert got.mean.shape == (2, 75, 2)
    assert _rel(got.mean.numpy(), want.mean) <= FP32_PINNED_REL
    if with_cov:
        # S* = K_qq - A^T A: the JAX function rounds A^T A, whose entries
        # reach 1 as K_qq's do, to float32, and S* is far smaller where
        # the query is near a kept step, so the band is absolute
        err = np.abs(got.cov.numpy() - np.asarray(want.cov)).max()
        assert err <= FP32_PINNED_REL
    else:
        assert got.cov is None and want.cov is None


@pytest.mark.parametrize("with_cov", [True, False])
def test_posterior_conditional_inverse_route_matches_substitution(
        with_cov, monkeypatch):
    """The card's inverse route (the mean ``K_qo (L L^T)^{-1} z`` from the
    single column, ``A`` for the covariance alone), forced on the CPU,
    against the substitution route's ``A^T L^{-1} z`` in float64."""
    times, kept, z_obs, ls = _posterior_inputs(13)
    args = (_t(times), _t(z_obs), _t(times[:, ::3] + 0.1), _t(ls))
    want = gp.posterior_conditional(*args, mask_obs=_t(kept, torch.bool),
                                    with_cov=with_cov)
    monkeypatch.setattr(gp, "inverse_route", lambda a: True)
    got = gp.posterior_conditional(*args, mask_obs=_t(kept, torch.bool),
                                   with_cov=with_cov)
    assert _rel(got.mean.numpy(), want.mean.numpy()) <= FP64_REL
    if with_cov:
        assert _rel(got.cov.numpy(), want.cov.numpy()) <= FP64_REL


def test_posterior_conditional_inverse_route_inverts_once(monkeypatch):
    """With the covariance, the inverse route inverts ``L`` once: the
    refined mean and ``A = L^{-1} K_oq`` share one ``tri_inv``."""
    times, kept, z_obs, ls = _posterior_inputs(13)
    calls = []

    def counted(l):
        calls.append(l.shape)
        return tri_inv_plain(l)

    monkeypatch.setattr(gp, "inverse_route", lambda a: True)
    monkeypatch.setattr(gp, "tri_inv", counted)
    monkeypatch.setattr(trsm, "tri_inv", counted)
    got = gp.posterior_conditional(_t(times), _t(z_obs),
                                   _t(times[:, ::3] + 0.1), _t(ls),
                                   mask_obs=_t(kept, torch.bool))
    assert len(calls) == 1 and torch.isfinite(got.cov).all()


def test_posterior_and_prior_samples_match_jax_with_the_same_noise():
    times, kept, z_obs, ls = _posterior_inputs(12)
    jpost = _jit(lambda *a: jgp.posterior_conditional(*a[:4], mask_obs=a[4]),
                 times, z_obs, times, ls, kept)
    key = jax.random.key(3)
    # its noise, drawn in the dtype of the mean, which the JAX function
    # pins to float32
    want, eps = _jit(lambda p: (
        jgp.posterior_sample(key, p, num_samples=2),
        jax.random.normal(key, (2, 2, 2, 150), jnp.float32)), jpost)
    post = gp.GPPosterior(mean=_t(jpost.mean), cov=_t(jpost.cov))
    got = gp.posterior_sample(post, 2, eps=_t(eps))
    assert got.shape == (2, 2, 150, 2)
    assert _rel(got.numpy(), want) <= FP32_PINNED_REL
    with pytest.raises(ValueError, match="eps must be"):
        gp.posterior_sample(post, 1, eps=_t(eps))
    # the prior: z = L_p eps
    l_p = np.linalg.cholesky(_bank(13, 2, 40))
    want, eps = _jit(lambda l: (
        jgp.prior_sample(key, l, 3),
        jax.random.normal(key, (3, 2, 2, 40), jnp.float64)), l_p)
    got = gp.prior_sample(_t(l_p), 3, eps=_t(eps))
    assert _rel(got.numpy(), want) <= FP32_PINNED_REL


# ---------------------------------------------------------------------------
# analysis on a model carried over from flax
# ---------------------------------------------------------------------------

@functools.lru_cache
def _models(learn_prior, t=30, b=3):
    """The ``syn_data`` model at ``t`` in both packages, float64, the
    port's weights the JAX model's, and a batch (built once; no test
    changes them)."""
    cfg = dataclasses.replace(jconfigs.get("syn_data").model, time_len=t,
                              learn_prior_lengthscales=learn_prior,
                              prior_lengthscales=(5.0, 2.0))
    times, mask = _grid(20, b, t)
    rng = np.random.default_rng(21)
    x = ((rng.random((b, t, 15)) < 0.4) * mask[..., None]).astype(np.float64)
    jmodel = JGPVAE(cfg)
    # encode and decode create every parameter (the lengthscales in
    # setup); one compiled init, then a numpy perturbation, in place of
    # dozens of op-by-op compiles
    params = jax.jit(lambda x: jmodel.init(
        {"params": jax.random.key(0)}, x,
        method=lambda m, x: m.decode(m.encode(x))))(jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * rng.standard_normal(a.shape), params)
    model = GPVAE(GPVAEConfig(**dataclasses.asdict(cfg))).double()
    convert.load_flax_params(model, params)
    kept = mask & (rng.random(mask.shape) >= 0.4)
    return jmodel, params, model, (x, times, mask, kept)


@pytest.mark.parametrize("learn_prior", [False, True])
def test_impute_matches_jax(learn_prior):
    """Conditioned on the prior's lengthscales: the config's constant
    (5, 2) for a fixed prior, the learned parameter otherwise; and on the
    posterior's when asked."""
    jmodel, params, model, (x, times, mask, kept) = _models(learn_prior)
    const = analysis._param_or_const(model, "prior_log_ls")
    want_const = janalysis._param_or_const(jmodel, params, "prior_log_ls",
                                           jmodel.config)
    assert _rel(const.detach().numpy(), want_const) <= FP64_REL
    assert (const is model.prior_log_ls) == learn_prior
    args = [jnp.asarray(a) for a in (x, times, mask, kept)]
    targs = (_t(x), _t(times), _t(mask, torch.bool), _t(kept, torch.bool))
    for use_prior in (True, False):
        probs, z, post = _jit(lambda p, *a: janalysis.impute(
            jmodel, p, *a, key=jax.random.key(0),
            use_prior_lengthscales=use_prior), params, *args)
        gprobs, gz, gpost = analysis.impute(
            model, *targs, use_prior_lengthscales=use_prior)
        assert _rel(gpost.mean.numpy(), post.mean) <= FP32_PINNED_REL
        assert _rel(gz.numpy(), z) <= FP32_PINNED_REL
        assert _rel(gprobs.numpy(), probs) <= FP32_PINNED_REL
    # at kept steps the imputed latent is the encoder mean
    k = kept
    np.testing.assert_array_equal(gz.numpy()[k],
                                  model.encode(targs[0]).detach().numpy()[k])


def test_impute_by_sampling_matches_jax():
    jmodel, params, model, (x, times, mask, kept) = _models(False)
    key = jax.random.key(4)
    probs, z, post, eps = _jit(lambda p, *a: (
        *janalysis.impute(jmodel, p, *a, key=key, sample=True),
        jax.random.normal(key, (1, 3, 2, 30), jnp.float32)),
        params, x, times, mask, kept)
    gprobs, gz, gpost = analysis.impute(
        model, _t(x), _t(times), _t(mask, torch.bool), _t(kept, torch.bool),
        sample=True, eps=_t(eps))
    err = np.abs(gpost.cov.numpy() - np.asarray(post.cov)).max()
    assert err <= FP32_PINNED_REL  # absolute, as in the test above
    assert _rel(gz.numpy(), z) <= SAMPLE_REL


def test_imputation_metrics_match_jax_with_the_same_draws():
    """JAX draws its kept mask and the baseline's noise from keys split off
    one key; the same draws go to the port."""
    jmodel, params, model, (x, times, mask, _) = _models(False)
    key = jax.random.key(5)
    want = janalysis.imputation_metrics(
        jmodel, params, jnp.asarray(x), jnp.asarray(times),
        jnp.asarray(mask), key=key, drop_fraction=0.4)
    k_drop, _, k_base = jax.random.split(key, 3)
    kept = janalysis.drop_timesteps(k_drop, jnp.asarray(mask), 0.4)
    noise = jax.random.normal(k_base, (3, 30, 2), jnp.float64)
    got = analysis.imputation_metrics(
        model, _t(x), _t(times), _t(mask, torch.bool),
        kept=_t(kept, torch.bool), baseline_eps=_t(noise))
    assert got["dropped_steps"] == want["dropped_steps"] > 0
    for name in ("nll_gp_impute", "mse_gp_impute", "nll_baseline",
                 "mse_baseline"):
        assert got[name] == pytest.approx(want[name], rel=FP32_PINNED_REL)


def test_analysis_draws_and_traversals_match_jax():
    """``reconstruct``, ``activation_stats``, ``traversal_from_gp`` and
    ``prior_draws`` with JAX's own noise, ``latent_traversal``, and the
    kept mask of ``drop_timesteps``."""
    jmodel, params, model, (x, times, mask, _) = _models(True)
    targs = (_t(x), _t(times), _t(mask, torch.bool))
    jargs = tuple(jnp.asarray(a) for a in (x, times, mask))
    key = jax.random.key(6)
    def reconstruct(p, *a):
        # with the noise the model draws from its "sample" stream
        sample_key = jmodel.apply({"params": p},
                                  method=lambda m: m.make_rng("sample"),
                                  rngs={"sample": key})
        return (*janalysis.reconstruct(jmodel, p, *a, key=key,
                                       num_samples=4),
                jax.random.normal(sample_key, (4, 3, 2, 30), jnp.float64))

    probs, z, eps = _jit(reconstruct, params, *jargs)
    gprobs, gz = analysis.reconstruct(model, *targs, num_samples=4,
                                      eps=_t(eps))
    assert _rel(gz.numpy(), z) <= FP32_PINNED_REL
    assert _rel(gprobs.numpy(), probs) <= FP32_PINNED_REL
    mc, var = _jit(lambda p, *a: janalysis.activation_stats(
        jmodel, p, *a, key=key, num_samples=4), params, *jargs)
    gmc, gvar = analysis.activation_stats(model, *targs, num_samples=4,
                                          eps=_t(eps))
    assert _rel(gmc.numpy(), mc) <= FP32_PINNED_REL
    assert _rel(gvar.numpy(), var) <= 1e-6
    grid = jnp.asarray(times[0])
    want, eps = _jit(lambda p, g: (
        janalysis.traversal_from_gp(jmodel, p, g, 1, key=key),
        jax.random.normal(key, (1, 1, 2, 30), jnp.float64)), params, grid)
    got = analysis.traversal_from_gp(model, _t(times[0]), 1, eps=_t(eps))
    assert _rel(got.numpy(), want) <= FP32_PINNED_REL
    want, eps = _jit(lambda p, g: (
        janalysis.prior_draws(jmodel, p, g, key=key, num_samples=2),
        jax.random.normal(key, (2, 1, 2, 30), jnp.float64)), params, grid)
    got = analysis.prior_draws(model, _t(times[0]), num_samples=2,
                               eps=_t(eps))
    assert _rel(got.numpy(), want) <= FP32_PINNED_REL
    base = np.array([0.3, -0.2])
    want = _jit(lambda p, b: janalysis.latent_traversal(jmodel, p, b, 0),
                params, base)
    got = analysis.latent_traversal(model, _t(base), 0)
    assert _rel(got.numpy(), want) <= FP64_REL
    kept = analysis.drop_timesteps(targs[2], 0.5,
                                   generator=torch.Generator().manual_seed(0))
    assert not kept[~targs[2]].any() and kept.sum() < targs[2].sum()


# ---------------------------------------------------------------------------
# checkpoints and the evaluate command
# ---------------------------------------------------------------------------

def _toy_batcher(t=12):
    times, mask = _grid(30, 12, t)
    x = (np.random.default_rng(31).random((12, t, 15)) < 0.4) * mask[..., None]
    return Batcher({"x": x.astype(np.float32),
                    "times": times.astype(np.float32), "mask": mask}, 4,
                   seed=0)


def test_checkpoint_manager_round_trip(tmp_path):
    """Three saves with ``keep=2`` leave the newest two; a fresh state
    restored from them continues exactly as the run that saved them."""
    cfg = dataclasses.replace(GPVAEConfig(), time_len=12,
                              learn_prior_lengthscales=True)
    run = train.TrainConfig(num_steps=3, log_every=1, checkpoint_every=1,
                            checkpoint_dir=str(tmp_path), keep_checkpoints=2)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    batches = _toy_batcher()
    state, _ = train.fit(model, batches, run, device="cpu", verbose=False)
    mgr = train.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.steps() == [2, 3]
    fresh = GPVAE(cfg, generator=torch.Generator().manual_seed(9))
    restored = mgr.restore_latest(train.create_train_state(
        fresh, train.TrainConfig(seed=5), "cpu"))
    assert restored.step == 3
    for a, b in zip(model.state_dict().values(), fresh.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())
    # one more step from each: same loss, same parameters
    more = dataclasses.replace(run, num_steps=4, checkpoint_dir=None)
    _, log_a = train.fit(model, batches, more, device="cpu", state=state,
                         verbose=False)
    _, log_b = train.fit(fresh, _advanced(_toy_batcher(), 3), more,
                         device="cpu", state=restored, verbose=False)
    assert log_a.rows[-1]["loss"] == log_b.rows[-1]["loss"]
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    assert train.CheckpointManager(str(tmp_path / "empty")).restore_latest(
        state) is None


def test_checkpoint_from_another_device_restores_all_but_the_generator(
        tmp_path):
    """A checkpoint whose generator state is another device's (a run
    trained on the card): the model, Adam and the step are restored, the
    generator keeps its own state."""
    cfg = dataclasses.replace(GPVAEConfig(), time_len=12)
    state = train.create_train_state(
        GPVAE(cfg, generator=torch.Generator().manual_seed(0)),
        train.TrainConfig(), "cpu")
    state.step = 7
    mgr = train.CheckpointManager(str(tmp_path))
    path = mgr.save(state)
    payload = torch.load(path, weights_only=True)
    payload.update(generator=torch.zeros(16, dtype=torch.uint8),
                   generator_device="cuda")
    torch.save(payload, path)
    fresh = train.create_train_state(
        GPVAE(cfg, generator=torch.Generator().manual_seed(3)),
        train.TrainConfig(seed=4), "cpu")
    gen_before = fresh.generator.get_state()
    assert mgr.restore_latest(fresh).step == 7
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(fresh.generator.get_state(), gen_before)


def _advanced(batcher, steps):
    for _ in range(steps):
        batcher.next_indices()
    return batcher


def test_evaluate_cli_on_the_cpu(tmp_path, capsys):
    """``evaluate --device cpu`` at T=12: from a checkpoint that ``train
    --ckpt-dir`` wrote, and from the seeded initial weights; the kept mask
    comes from a seeded CPU generator, so two runs agree exactly."""
    common = ["--preset", "syn_data", "--time-len", "12", "--num-seqs",
              "40", "--device", "cpu"]
    main(["train", *common, "--steps", "2", "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    main(["evaluate", *common, "--eval-batch", "4", "--ckpt-dir",
          str(tmp_path), "--stats", "--stats-samples", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 2"
    metrics = json.loads(lines[1])
    assert metrics["dropped_steps"] > 0
    assert all(np.isfinite(metrics[k]) for k in (
        "nll_gp_impute", "mse_gp_impute", "nll_baseline", "mse_baseline"))
    assert len(json.loads(lines[2])["activation_variance_sorted"]) == 2
    main(["evaluate", *common, "--eval-batch", "4"])
    fresh = json.loads(capsys.readouterr().out)
    main(["evaluate", *common, "--eval-batch", "4"])
    assert json.loads(capsys.readouterr().out) == fresh
    # --data: the same toy sequences from a file score the same
    np.savez(tmp_path / "toy.npz", **generate_toy_data(
        np.random.default_rng(0), 40, t=12))
    main(["evaluate", *common, "--eval-batch", "4", "--data",
          str(tmp_path / "toy.npz")])
    assert json.loads(capsys.readouterr().out) == fresh
    # --plots: a dense decoder's latents and traversal (Agg backend)
    main(["evaluate", *common, "--eval-batch", "4", "--plots",
          str(tmp_path / "p"), "--traversal", "0"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "plots written to")
    assert sorted(os.listdir(tmp_path / "p")) == ["latents.png",
                                                  "traversal.png"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["evaluate", *common, "--ckpt-dir", str(tmp_path / "none")])
