"""The port's Toeplitz structured prior against the JAX package, on the CPU.

* ``kernels.toeplitz_row`` and ``toeplitz_to_dense``; the FFT pieces
  ``tri_toeplitz``, ``tri_toeplitz_matvec`` and ``tri_toeplitz_matvec_t``
  with leading batch dims; ``circulant_prior_sample`` on the JAX
  package's own noise: to ``FFT_REL``;
* the Durbin recursion (``ops.durbin``'s plain version, which the card's
  kernel repeats step for step) under ``durbin_logdet`` and
  ``durbin_gs_factors``, against JAX's scan and its blocked Schur/Durbin
  with and without the compensated arithmetic (``GPVAE_DURBIN_*`` set so
  the blocked path runs at small T, a remainder block included), and its
  gradient with respect to the row: to ``FP64_REL``;
* both Toeplitz KLs with their gradients, against JAX and against the
  port's own dense KLs;
* the Toeplitz model's ELBO and every gradient through
  ``tests/test_torch_zoo.py``'s helper; ``prior_draws``; the
  ``t1024_toeplitz`` preset; ``train`` and ``evaluate`` of the preset
  through ``__main__.main`` at T=16;
* the Durbin kernel's reverse: its plain version (``durbin_bwd_plain``,
  the kernel's arithmetic step for step) against the plain forward's
  autograd and against ``jax.grad`` through both of JAX's routes, a
  clamped coefficient included; the autograd Function on the card's
  route (kernels stubbed by their plain versions); the learnable Toeplitz
  prior's ELBO and every gradient against the JAX model, and its
  training, checkpoint, ``evaluate`` and ``prior_draws``.

JAX's Toeplitz row defaults to float32 (``gpvae_tpu/kernels.py:225``):
the JAX side builds it in float64 here (``jax_rows_fp64``).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import analysis as janalysis
from gpvae_tpu import configs as jconfigs
from gpvae_tpu import gp as jgp
from gpvae_tpu import kernels as jkernels
from gpvae_tpu import toeplitz as jtoeplitz
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.models import GPVAEConfig as JConfig
from gpvae_tpu_torch import analysis, configs, convert, gp, kernels, toeplitz
from gpvae_tpu_torch.__main__ import main
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.ops import dispatch, durbin

from durbin_rows import clamped_rows
from test_torch_healing import _gp_sample_fp64
from test_torch_zoo import _random_params, check_elbo_matches_jax

FP64_REL = 1e-9
FFT_REL = 1e-10
# the reference grid: 0 .. 60 in 1024 steps, at lengthscales the presets use
STEP = 60.0 / 1023


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture
def jax_rows_fp64(monkeypatch):
    monkeypatch.setattr(jkernels, "toeplitz_row", functools.partial(
        jkernels.toeplitz_row, dtype=jnp.float64))


def _rows(t, ls=(9.0, 3.0, 1.0), step=10 * STEP, noise=1e-3):
    """First rows ``[Z, T]`` in float64 (the port's ``toeplitz_row``)."""
    return kernels.toeplitz_row(t, step, torch.tensor(ls, dtype=torch.float64),
                                noise=noise, dtype=torch.float64)


@pytest.mark.parametrize("kernel", ["rbf", "matern32", "cauchy"])
def test_toeplitz_row_and_dense_match_jax(kernel):
    ls = np.array([9.0, 3.0, 0.7])
    var = np.array([1.0, 0.5, 2.0])
    for variance in (1.0, var):
        ref = jkernels.toeplitz_row(
            12, 0.25, jnp.asarray(ls), kernel=kernel, noise=1e-2,
            variance=variance if np.ndim(variance) == 0
            else jnp.asarray(variance), dtype=jnp.float64)
        got = kernels.toeplitz_row(
            12, 0.25, torch.tensor(ls), kernel=kernel, noise=1e-2,
            variance=variance if np.ndim(variance) == 0
            else torch.tensor(variance), dtype=torch.float64)
        assert got.dtype == torch.float64 and got.shape == (3, 12)
        assert _rel(got.numpy(), ref) <= FFT_REL
        np.testing.assert_array_equal(
            kernels.toeplitz_to_dense(got).numpy(),
            np.asarray(jkernels.toeplitz_to_dense(jnp.asarray(got.numpy()))))
    # the default dtype is the JAX package's float32
    assert kernels.toeplitz_row(4, 1.0, torch.ones(2)).dtype == torch.float32


@pytest.mark.parametrize("t", [16, 45])
def test_fft_pieces_match_jax(t):
    rng = np.random.default_rng(t)
    col = rng.standard_normal((3, t))
    y = rng.standard_normal((2, 4, 3, t, 5))     # leading batch dims
    np.testing.assert_array_equal(
        toeplitz.tri_toeplitz(torch.tensor(col)).numpy(),
        np.asarray(jtoeplitz.tri_toeplitz(jnp.asarray(col))))
    for name in ("tri_toeplitz_matvec", "tri_toeplitz_matvec_t"):
        ref = getattr(jtoeplitz, name)(jnp.asarray(col), jnp.asarray(y))
        got = getattr(toeplitz, name)(torch.tensor(col), torch.tensor(y))
        assert got.shape == y.shape
        assert _rel(got.numpy(), ref) <= FFT_REL, name
    # and against the dense triangular products
    a = np.asarray(jtoeplitz.tri_toeplitz(jnp.asarray(col)))
    got = toeplitz.tri_toeplitz_matvec_t(torch.tensor(col), torch.tensor(y))
    assert _rel(got.numpy(), np.einsum("zji,...zjc->...zic", a, y)) <= 1e-12
    assert toeplitz._fft_len(t) == jtoeplitz._fft_len(t)


@pytest.mark.parametrize("t", [16, 45])
def test_circulant_prior_sample_matches_jax(t):
    """JAX's draw, and its noise (the same key and shape) as ``eps``."""
    row = _rows(t, ls=(2.0, 0.5))
    key = jax.random.key(t)
    ref = jtoeplitz.circulant_prior_sample(key, jnp.asarray(row.numpy()),
                                           num_samples=3)
    eps = np.asarray(jax.random.normal(key, (3, 2, 2 * (t - 1))))
    got = toeplitz.circulant_prior_sample(row, 3, eps=torch.tensor(eps))
    assert got.shape == (3, 2, t)
    assert _rel(got.numpy(), ref) <= FFT_REL
    g = torch.Generator().manual_seed(0)
    assert toeplitz.circulant_prior_sample(row, 2, generator=g).shape == (
        2, 2, t)
    with pytest.raises(ValueError, match="eps must be"):
        toeplitz.circulant_prior_sample(row, 2, eps=torch.tensor(eps))


# JAX's routes of _durbin_flat: the classical scan (T < GPVAE_DURBIN_MIN_T),
# the blocked Schur/Durbin (block 8 from T=1 on), with the compensated
# theta tree and tail convolution or without
ROUTES = {"scan": {"GPVAE_DURBIN_BLOCK": "0"},
          "blocked": {"GPVAE_DURBIN_BLOCK": "8", "GPVAE_DURBIN_MIN_T": "1",
                      "GPVAE_DURBIN_COMP": "0"},
          "blocked_comp": {"GPVAE_DURBIN_BLOCK": "8",
                           "GPVAE_DURBIN_MIN_T": "1",
                           "GPVAE_DURBIN_COMP": "1"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("t", [2, 17, 45])
def test_durbin_matches_jax(route, t, monkeypatch):
    """``durbin_logdet`` and ``(logdet, a, b, e)`` of ``durbin_gs_factors``
    on rows with leading batch dims ``[2, 3, T]`` (T=45: 44 steps, five
    blocks of 8 and a remainder of 4); JAX's logdet also against the dense
    matrix's in float64."""
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    row = torch.stack([_rows(t), _rows(t, ls=(0.5, 2.0, 6.0), noise=1e-2)])
    ref = jtoeplitz.durbin_gs_factors(jnp.asarray(row.numpy()))
    got = toeplitz.durbin_gs_factors(row)
    for name, g, r in zip(("logdet", "a", "b", "e"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.float64
        assert _rel(g.numpy(), r) <= FP64_REL, name
    ref_ld = jtoeplitz.durbin_logdet(jnp.asarray(row.numpy()))
    assert _rel(toeplitz.durbin_logdet(row).numpy(), ref_ld) <= FP64_REL
    # the JAX side itself against the dense matrix's float64 logdet
    dense = torch.linalg.slogdet(kernels.toeplitz_to_dense(row))[1]
    assert _rel(ref_ld, dense.numpy()) <= FP64_REL


@pytest.mark.parametrize("t", [33, 100])
def test_durbin_is_the_dense_logdet_and_gs_inverse(t):
    """Against the dense matrix in float64: the logdet, and K^-1 from the
    Gohberg-Semencul factors; a float32 row is recurred in float64 and
    returned in float32."""
    row = _rows(t)
    k = kernels.toeplitz_to_dense(row)
    ld, a, b, e = toeplitz.durbin_gs_factors(row)
    assert _rel(ld.numpy(), torch.linalg.slogdet(k)[1].numpy()) <= 1e-12
    aa, bb = toeplitz.tri_toeplitz(a), toeplitz.tri_toeplitz(b)
    inv = (aa @ aa.mT - bb @ bb.mT) / e[:, None, None]
    assert _rel((inv @ k).numpy(), np.broadcast_to(np.eye(t), k.shape)) \
        <= 1e-8
    got32 = toeplitz.durbin_gs_factors(row.float())
    for g, r in zip(got32, toeplitz.durbin_gs_factors(row.float().double())):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), r.float().numpy())


@pytest.mark.parametrize("t", [17, 45])
def test_durbin_plain_gradient_matches_jax(t):
    """The gradient of a loss on every output of ``durbin_gs_factors``
    with respect to the rows: the plain version's autograd against JAX's
    autodiff through its scan (the reference for a backward kernel)."""
    row = _rows(t, ls=(3.0, 1.0))
    w = np.random.default_rng(t).standard_normal((3, 2, t))

    def jloss(r):
        ld, a, b, e = jtoeplitz.durbin_gs_factors(r)
        return (jnp.sum(ld) + jnp.sum(a * w[0]) + jnp.sum(b * w[1])
                + jnp.sum(jnp.log(e)) + jnp.sum(a * a * w[2]))

    ref = jax.grad(jloss)(jnp.asarray(row.numpy()))
    r = row.clone().requires_grad_(True)
    ld, a, b, e = toeplitz.durbin_gs_factors(r)
    wt = torch.tensor(w)
    loss = (ld.sum() + (a * wt[0]).sum() + (b * wt[1]).sum()
            + torch.log(e).sum() + (a * a * wt[2]).sum())
    loss.backward()
    assert _rel(r.grad.numpy(), ref) <= FP64_REL


def test_durbin_on_a_cuda_tensor_needs_no_gradient(monkeypatch):
    """On the card's route a row goes through ``DurbinFunction``: the
    forward kernel keeps its steps only where a gradient is needed, and
    ``backward`` launches the reverse kernel once, with ``None`` for an
    output no loss reaches (here both kernels stubbed by their plain
    versions); the gradient is the plain version's autograd."""
    monkeypatch.setattr(dispatch, "on_cuda", lambda t: True)
    fwd, bwd = [], []

    def fake_fwd(rho, save=False):
        fwd.append((rho.dtype, save))
        with torch.no_grad():
            return durbin.durbin_plain(rho, save=save)

    def fake_bwd(steps, last, *cot):
        bwd.append(tuple(c is None for c in cot))
        return durbin.durbin_bwd_plain(steps, last, *cot)

    monkeypatch.setattr(durbin, "durbin_cuda", fake_fwd)
    monkeypatch.setattr(durbin, "durbin_bwd_cuda", fake_bwd)
    row = _rows(9).requires_grad_(True)
    toeplitz.durbin_logdet(row).sum().backward()
    with torch.no_grad():
        toeplitz.durbin_logdet(row)
    toeplitz.durbin_logdet(row.detach().float())
    assert fwd == [(torch.float64, True), (torch.float64, False),
                   (torch.float64, False)]
    assert bwd == [(False, True, True)]   # only sum_log_e reached the loss
    ref = _rows(9).requires_grad_(True)
    monkeypatch.setattr(dispatch, "on_cuda", lambda t: False)
    toeplitz.durbin_logdet(ref).sum().backward()
    assert _rel(row.grad.numpy(), ref.grad.numpy()) <= 1e-13


def _cotangents(n, t1, which, seed=0):
    """Random cotangents of (sum_log_e, y, e); those not in ``which``
    None."""
    rng = np.random.default_rng(seed)
    full = (rng.standard_normal(n), rng.standard_normal((n, t1)),
            rng.standard_normal(n))
    return tuple(torch.tensor(c) if i in which else None
                 for i, c in enumerate(full))


def _jax_rho_grad_fn():
    """JAX's gradient with respect to ``rho`` of the same loss, through
    ``durbin_gs_factors`` of the rows ``(1, rho)`` (at r_0 = 1 its logdet
    is ``sum_log_e``, its ``a[1:]`` is ``y`` and its ``e`` is ``e``),
    jitted once with the cotangents as arguments.  Build it after the
    route's variables are set: they are read when it is traced."""
    def loss(r, w_sum, w_y, w_e):
        row = jnp.concatenate([jnp.ones((r.shape[0], 1), r.dtype), r], -1)
        ld, a, _, e = jtoeplitz.durbin_gs_factors(row)
        return (jnp.sum(ld * w_sum) + jnp.sum(a[:, 1:] * w_y)
                + jnp.sum(e * w_e))

    grad = jax.jit(jax.grad(loss))

    def call(rho, cot):
        zero = (np.zeros(rho.shape[0]), np.zeros(rho.shape),
                np.zeros(rho.shape[0]))
        w = [z if c is None else c.numpy() for z, c in zip(zero, cot)]
        return np.asarray(grad(rho.numpy(), *w))

    return call


@pytest.mark.parametrize("route", ["scan", "blocked"])
@pytest.mark.parametrize("t", [2, 17, 45])
def test_durbin_bwd_plain_matches_autograd_and_jax(route, t, monkeypatch):
    """``durbin_bwd_plain`` on the plain forward's steps, against the plain
    forward's autograd and JAX's gradient (its scan, or its blocked route
    with ``GPVAE_DURBIN_MIN_T``/``GPVAE_DURBIN_BLOCK`` lowered), for a
    cotangent on each output alone and on all three, to ``FP64_REL``."""
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    jax_grad = _jax_rho_grad_fn()
    row = _rows(t, ls=(9.0, 3.0, 1.0))
    rho = row[:, 1:] / row[:, :1]
    n, t1 = rho.shape
    for which in ((0,), (1,), (2,), (0, 1, 2)):
        cot = _cotangents(n, t1, which, seed=t)
        r = rho.clone().requires_grad_(True)
        *outs, (steps, last) = durbin.durbin_plain(r, save=True)
        loss = sum((o * c).sum() for o, c in zip(outs, cot) if c is not None)
        auto, = torch.autograd.grad(loss, r)
        got = durbin.durbin_bwd_plain(steps, last, *cot)
        assert got.shape == (n, t1) and got.dtype == torch.float64
        assert _rel(got.numpy(), auto.numpy()) <= FP64_REL, which
        assert _rel(got.numpy(), jax_grad(rho, cot)) <= FP64_REL, which


@pytest.mark.parametrize("t", [3, 17])
def test_durbin_bwd_plain_where_alpha_clamps(t):
    """The last reflection coefficient past 1 before its clamp: no
    gradient through it (``torch.clamp``'s autograd, JAX's ``clip``); the
    earlier ones pass theirs."""
    rho = clamped_rows(t)
    *_, (steps, last) = durbin.durbin_plain(rho, save=True)
    raw = -steps[0, 1, -1] / steps[0, 2, -1]
    assert raw > 1.0 and steps[0, 0, -1] < 1.0
    cot = _cotangents(1, t - 1, (0, 1, 2), seed=t)
    r = rho.clone().requires_grad_(True)
    outs = durbin.durbin_plain(r)
    auto, = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cot)), r)
    got = durbin.durbin_bwd_plain(steps, last, *cot)
    assert _rel(got.numpy(), auto.numpy()) <= FP64_REL
    assert _rel(got.numpy(), _jax_rho_grad_fn()(rho, cot)) <= FP64_REL


def test_durbin_bwd_plain_starts_from_the_kept_last_step():
    """The reverse starts from the last step's kept inputs ``last [N, 2,
    T]`` (``(a, Z b)`` at every lag) and undoes the 98 steps before it by
    their inverse (T=100), within ``FP64_REL`` of autograd; the kept state
    is what it starts from: spoiling it changes the gradient."""
    row = _rows(100, ls=(9.0,))
    rho = row[:, 1:] / row[:, :1]
    cot = _cotangents(1, 99, (0, 1, 2))
    r = rho.clone().requires_grad_(True)
    *outs, (steps, last) = durbin.durbin_plain(r, save=True)
    assert steps.shape == (1, 4, 99) and last.shape == (1, 2, 100)
    assert last[0, 0, 99] == 0.0  # a[T-1] before the last step
    auto, = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cot)), r)
    got = durbin.durbin_bwd_plain(steps, last, *cot)
    assert _rel(got.numpy(), auto.numpy()) <= FP64_REL
    spoiled = last.clone()
    spoiled[:, 1] *= 1.5
    assert _rel(durbin.durbin_bwd_plain(steps, spoiled, *cot).numpy(),
                auto.numpy()) > 1e-3


def _kl_inputs(seed, b, t, z, shared):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((b, t, z))
    log_var = 0.3 * rng.standard_normal((b, t, z))
    times = np.arange(t, dtype=np.float64)[None]
    ls_q = rng.uniform(1.0, 4.0, z)
    k = jkernels.gram_bank(jnp.asarray(times if shared
                                       else np.repeat(times, b, 0)),
                           jnp.asarray(ls_q))
    l_q = np.asarray(jnp.linalg.cholesky(k))
    row = _rows(t, ls=tuple(rng.uniform(1.0, 5.0, z)), step=1.0).numpy()
    return mu, log_var, l_q, row


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kind", ["gp", "diag"])
def test_toeplitz_kls_match_jax_and_dense(kind, shared):
    """``gp_kl_toeplitz_prior`` (per-sequence or shared ``[1, Z, T, T]``
    posterior factors) and ``gp_prior_diag_kl_toeplitz``: values ``[B, Z]``
    and the gradient of their sum with respect to every input, the prior
    row included, against JAX; the values against the port's dense
    ``gp_kl`` / ``gp_prior_diag_kl`` of the same prior."""
    mu, log_var, l_q, row = _kl_inputs(4 + shared, 3, 20, 2, shared)
    if kind == "gp":
        args = (mu, l_q, row)
        jfn, tfn = jgp.gp_kl_toeplitz_prior, gp.gp_kl_toeplitz_prior
    else:
        args = (mu, log_var, row)
        jfn, tfn = jgp.gp_prior_diag_kl_toeplitz, gp.gp_prior_diag_kl_toeplitz

    def jsum(*a):
        return jnp.sum(jfn(*a))

    ref = jfn(*(jnp.asarray(a) for a in args))
    ref_grads = jax.grad(jsum, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.tensor(a).requires_grad_(True) for a in args]
    got = tfn(*ts)
    got.sum().backward()
    assert got.shape == ref.shape == (3, 2)
    assert _rel(got.detach().numpy(), ref) <= FP64_REL
    for name, t_, r in zip(("mu", "second", "row"), ts, ref_grads):
        assert _rel(t_.grad.numpy(), r) <= FP64_REL, name
    l_p = torch.linalg.cholesky(kernels.toeplitz_to_dense(torch.tensor(row)))
    dense = (gp.gp_kl(torch.tensor(mu), torch.tensor(l_q), l_p[None])
             if kind == "gp" else
             gp.gp_prior_diag_kl(torch.tensor(mu), torch.tensor(log_var),
                                 l_p[None]))
    assert _rel(got.detach().numpy(), dense.numpy()) <= 1e-8
    if kind == "gp":
        ld_q = 2.0 * torch.log(torch.diagonal(
            torch.tensor(l_q), dim1=-2, dim2=-1)).sum(-1)
        given = tfn(*(torch.tensor(a) for a in args), logdet_q=ld_q)
        assert _rel(given.numpy(), got.detach().numpy()) <= 1e-14


@pytest.mark.parametrize("posterior", ["gp", "diag"])
def test_toeplitz_elbo_and_grads_match_jax_fp64(posterior, monkeypatch,
                                                 jax_rows_fp64):
    """The dense nets on a shared uniform grid under the Toeplitz prior:
    loss, nll, kl, the draw and every gradient to ``FP64_REL`` (the JAX
    model's ``gp_sample`` einsum in float64, as the healing tests patch
    it; its row built in float64)."""
    monkeypatch.setattr(jgp, "gp_sample", _gp_sample_fp64)
    check_elbo_matches_jax(("gp", posterior), "dense", True, monkeypatch,
                           extra={"structured_prior": "toeplitz"},
                           band=FP64_REL)


def test_toeplitz_model_factors_only_the_posterior():
    """``chol_banks`` gives the posterior's factor and logdet and the
    prior's first rows, no prior factor; its KL equals the dense prior's
    within rounding."""
    fields = dict(structured_prior="toeplitz", shared_time_grid=True,
                  time_len=12, prior_lengthscales=(4.0, 2.0))
    model = GPVAE(GPVAEConfig(**fields)).double()
    dense = GPVAE(GPVAEConfig(**{**fields, "structured_prior": "dense"}))
    dense.load_state_dict(model.state_dict())
    dense.double()
    times = torch.arange(12, dtype=torch.float64).expand(3, 12) * 0.5
    aux = model.chol_banks(times, None, logdets=True)
    assert sorted(aux) == ["l_q", "ld_q", "prior_row"]
    assert aux["l_q"].shape == (1, 2, 12, 12)
    assert aux["prior_row"].shape == (2, 12)
    x = torch.tensor((np.random.default_rng(0).random((3, 12, 15)) < 0.4)
                     .astype(np.float64))
    eps = torch.tensor(np.random.default_rng(1).standard_normal(
        model.noise_shape(1, 3, 12)))
    out, ref = (m(x, times, eps=eps) for m in (model, dense))
    assert _rel(out.kl.detach().numpy(), ref.kl.detach().numpy()) <= 1e-9


def test_prior_draws_toeplitz_matches_jax(jax_rows_fp64):
    """``analysis.prior_draws`` of a Toeplitz model: the circulant sampler
    on JAX's own noise, ``[S, T, Z]``."""
    fields = dataclasses.asdict(GPVAEConfig(
        structured_prior="toeplitz", shared_time_grid=True, time_len=16,
        prior_lengthscales=(1.0,)))
    times = np.arange(16, dtype=np.float64) * 0.5
    jmodel = JGPVAE(JConfig(**fields))
    args = (jnp.zeros((1, 16, 15)), jnp.asarray(times[None]),
            jnp.ones((1, 16), bool))
    params = _random_params(jmodel, args, fields)
    key = jax.random.key(4)
    ref = janalysis.prior_draws(jmodel, params, jnp.asarray(times), key=key,
                                num_samples=3)
    model = GPVAE(GPVAEConfig(**fields)).double()
    convert.load_flax_params(model, jax.device_get(params))
    eps = np.asarray(jax.random.normal(key, (3, 2, 30)))
    got = analysis.prior_draws(model, torch.tensor(times), num_samples=3,
                               eps=torch.tensor(eps))
    assert got.shape == (3, 16, 2)
    assert _rel(got.numpy(), ref) <= FFT_REL
    assert analysis.prior_draws(model, torch.tensor(times), num_samples=2,
                                generator=torch.Generator().manual_seed(0)
                                ).shape == (2, 16, 2)


def test_t1024_toeplitz_preset_matches_jax():
    ours, ref = configs.get("t1024_toeplitz"), jconfigs.get("t1024_toeplitz")
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(ref.model)
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
    assert (ours.batch_size, ours.description, ours.data_family) == (
        ref.batch_size, ref.description, ref.data_family)
    assert ours.model.toeplitz_prior
    GPVAE(ours.model)


def test_check_ported_refuses_only_a_learnable_toeplitz_prior():
    """Nothing is refused any more: every preset builds (on the meta
    device: no weights drawn), and so does ``t1024_toeplitz`` with
    ``learn_prior_lengthscales``, its prior's log-lengthscales a parameter
    (a buffer in the preset)."""
    for name in configs.PRESETS:
        with torch.device("meta"):
            GPVAE(configs.get(name).model)
    preset = configs.get("t1024_toeplitz").model
    cfg = dataclasses.replace(preset, learn_prior_lengthscales=True)
    params = dict(GPVAE(cfg).named_parameters())
    assert "prior_log_ls" in params and params["prior_log_ls"].shape == (2,)
    assert "prior_log_ls" not in dict(GPVAE(preset).named_parameters())
    assert "prior_log_ls" in dict(GPVAE(preset).named_buffers())


@pytest.mark.parametrize("posterior", ["gp", "diag"])
def test_learnable_toeplitz_prior_elbo_and_grads_match_jax_fp64(
        posterior, monkeypatch, jax_rows_fp64):
    """A learnable Toeplitz prior: loss, nll, kl, the draw and every
    gradient, ``prior_log_ls``'s through the Durbin recursion included, to
    ``FP64_REL`` against the JAX model's autodiff."""
    monkeypatch.setattr(jgp, "gp_sample", _gp_sample_fp64)
    check_elbo_matches_jax(("gp", posterior), "dense", True, monkeypatch,
                           extra={"structured_prior": "toeplitz",
                                  "learn_prior_lengthscales": True},
                           band=FP64_REL)


def test_learnable_toeplitz_prior_trains_saves_and_evaluates(tmp_path,
                                                             capsys):
    """``t1024_toeplitz``'s model with ``learn_prior_lengthscales`` at
    T=16: ``train.fit`` moves the prior's lengthscales and saves a
    checkpoint; ``evaluate`` (the preset, its prior fixed) restores the
    model from it (not Adam's state: its parameters differ) and prints
    finite metrics; ``prior_draws`` samples the learned prior."""
    from gpvae_tpu_torch import train
    from gpvae_tpu_torch.data import (
        Batcher, generate_toy_data, toy_to_masked_batch,
    )

    t = 16
    cfg = dataclasses.replace(configs.get("t1024_toeplitz").model,
                              time_len=t, learn_prior_lengthscales=True)
    data = toy_to_masked_batch(generate_toy_data(
        np.random.default_rng(0), 20, t=t, hide_fraction=0.0))
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    ls0 = model.prior_log_ls.detach().clone()
    state, log = train.fit(model, Batcher(data, 4, seed=0), train.TrainConfig(
        num_steps=3, log_every=1, learning_rate=0.05,
        checkpoint_dir=str(tmp_path / "ck")), device="cpu", verbose=False)
    assert all(np.isfinite(r["loss"]) for r in log.rows)
    moved = model.prior_log_ls.detach()
    assert (moved - ls0).abs().min() > 0 and torch.isfinite(moved).all()
    main(["evaluate", "--preset", "t1024_toeplitz", "--device", "cpu",
          "--time-len", str(t), "--num-seqs", "20", "--batch-size", "4",
          "--seed", "0", "--ckpt-dir", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 3"
    assert all(np.isfinite(v) for v in json.loads(lines[1]).values())
    restored = GPVAE(configs.get("t1024_toeplitz").model)
    restored.load_state_dict(model.state_dict())
    assert torch.equal(restored.prior_log_ls, moved)
    draws = analysis.prior_draws(model, torch.linspace(0.0, 60.0, t),
                                 num_samples=2,
                                 generator=torch.Generator().manual_seed(1))
    assert draws.shape == (2, t, 2) and torch.isfinite(draws).all()


def test_cli_trains_and_evaluates_t1024_toeplitz(tmp_path, capsys):
    """The preset at its widths (B=4 here, Z=2, 15 observed dims) at T=16
    on fully observed toy sequences: two steps, then evaluate prints the
    imputation metrics of the held-out sequences."""
    common = ["--preset", "t1024_toeplitz", "--device", "cpu", "--time-len",
              "16", "--num-seqs", "20", "--batch-size", "4", "--seed", "0",
              "--ckpt-dir", str(tmp_path / "ck")]
    main(["train", *common, "--steps", "2"])
    assert "done at step 2" in capsys.readouterr().out
    main(["evaluate", *common])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 2"
    metrics = json.loads(lines[1])
    # the last 2 of 20 sequences, all 16 steps observed, half dropped
    assert 0 < metrics["dropped_steps"] < 2 * 16
    assert all(np.isfinite(v) for v in metrics.values())
