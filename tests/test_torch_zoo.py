"""The port's model zoo against the JAX package, on the CPU in float64.

* the zoo's GP functions (``gp_prior_diag_kl``, ``standard_kl``,
  ``recog_gp_kl``, ``_batch_diag``, ``diag_sample``, ``recog_sample``),
  on per-sequence and shared (``[1, Z, T, T]``) banks with masked steps:
  values and gradients to 1e-10 relative;
* ``chol_gram_bank(diff_times=True)``'s times gradient and
  ``solve_triangular(via_inverse=...)``;
* ``GPVAE.forward`` for every ported prior/posterior pair on the dense
  nets, with and without a shared time grid: loss, nll, kl and every
  gradient, with JAX's own noise (the conv nets' cases are in
  ``tests/test_torch_conv.py``).

The JAX functions run as jitted programs, the JAX model op by op (its
primitives compile once for all cases).  The JAX model's gradient in float64 is its autodiff through
``jnp.linalg.cholesky``: the package's own Cholesky backward pins float32
(``gpvae_tpu/ops/chol.py:603``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import gp as jgp
from gpvae_tpu import kernels as jkernels
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.ops import trsm as jtrsm
from gpvae_tpu_torch import convert
from gpvae_tpu_torch import gp as tgp
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.ops import trsm as ttrsm

FP64_REL = 1e-10
# gp_sample and recog_sample in the JAX package ask their einsum for
# float32 results (gpvae_tpu/gp.py:546-553, :596-599), forward and in its
# transpose, so a model whose posterior draws through one carries float32
# rounding (unit roundoff 6e-8) into the draw, the loss and every
# gradient: held to 1e-6 there (a lengthscale gradient that reaches the
# loss only through the draw missed by 2.9e-7), to FP64_REL where the
# posterior is diagonal; the draw itself (recog_sample) is held to
# FP64_REL against a float64 numpy formula
SAMPLED_REL = 1e-6

PAIRS = (("gp", "gp"), ("gp", "diag"), ("standard", "diag"),
         ("standard", "gp_plus_diag"), ("standard", "gp_plus_diag_ref"),
         ("standard", "gp"))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _inputs(seed, b, t, z, shared):
    """times [B, T], mask [B, T], means and log-variances [B, T, Z], and
    the lower factors [B or 1, Z, T, T] of each sequence's gram."""
    rng = np.random.default_rng(seed)
    if shared:
        times = np.broadcast_to(np.arange(t, dtype=np.float64), (b, t))
        mask = np.ones((b, t), bool)
    else:
        times = np.sort(rng.uniform(0.0, 12.0, (b, t)), axis=-1)
        mask = rng.random((b, t)) > 0.3
        mask[:, 0] = True
    mu = rng.standard_normal((b, t, z))
    log_var = 0.3 * rng.standard_normal((b, t, z))
    ls = rng.uniform(1.0, 4.0, z)
    grid = (times[:1], None) if shared else (times, mask)
    k = jkernels.gram_bank(jnp.asarray(grid[0]), jnp.asarray(ls),
                           mask=None if grid[1] is None
                           else jnp.asarray(grid[1]))
    l = np.asarray(jnp.linalg.cholesky(k))
    return times, mask, mu, log_var, l


def _jax_value_and_grads(fn, args):
    """``fn(*args)`` (JAX, jitted) and the gradient of its sum with
    respect to every argument."""
    def both(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.ones_like(out))

    return jax.jit(both)(*[jnp.asarray(a) for a in args])


def _torch_value_and_grads(fn, args):
    ts = [torch.tensor(np.array(a)).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("name", ["gp_prior_diag_kl", "standard_kl",
                                  "recog_gp_kl"])
def test_zoo_kls_match_jax_fp64(name, shared):
    """Values ``[B, Z]`` (``standard_kl``: ``[B]``) and the gradient of
    their sum with respect to the means, log-variances and the factor."""
    times, mask, mu, log_var, l = _inputs(3 + shared, 3, 9, 2, shared)
    mj = jnp.asarray(mask)
    if name == "standard_kl":
        args = (mu, log_var)
        jfn = lambda m, v: jgp.standard_kl(m, v, mj)          # noqa: E731
        tfn = lambda m, v: tgp.standard_kl(m, v, torch.tensor(mask))  # noqa
    else:
        args = (mu, log_var, l)
        jfn = lambda m, v, f: getattr(jgp, name)(m, v, f, mj)  # noqa: E731
        tfn = lambda m, v, f: getattr(tgp, name)(  # noqa: E731
            m, v, f, torch.tensor(mask))
    ref, ref_grads = _jax_value_and_grads(jfn, args)
    got, grads = _torch_value_and_grads(tfn, args)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= FP64_REL
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= FP64_REL


def test_gp_prior_diag_kl_takes_the_given_logdet():
    times, mask, mu, log_var, l = _inputs(5, 2, 7, 3, False)
    lt = torch.tensor(l)
    ld = 2.0 * torch.log(torch.diagonal(lt, dim1=-2, dim2=-1)).sum(-1)
    args = (torch.tensor(mu), torch.tensor(log_var), lt, torch.tensor(mask))
    a = tgp.gp_prior_diag_kl(*args)
    b = tgp.gp_prior_diag_kl(*args, logdet_p=ld)
    assert _rel(b.numpy(), a.numpy()) <= 1e-14


@pytest.mark.parametrize("shared", [False, True])
def test_samplers_match_jax_fp64(shared):
    """Each sampler with the JAX package's own draw as ``eps``:
    ``diag_sample`` (noise ``[S, B, T, Z]``) to 1e-10; ``recog_sample``
    (noise ``[S, B, Z, T]``) to 1e-10 of ``mu + (L + diag(sqrt v)) eps``
    in float64 and to ``SAMPLED_REL`` of the JAX function, whose einsum
    rounds to float32."""
    times, mask, mu, log_var, l = _inputs(7 + shared, 3, 8, 2, shared)
    key = jax.random.key(11)
    args = [jnp.asarray(a) for a in (mu, log_var)]
    mj = jnp.asarray(mask)
    ref = jax.jit(lambda m, v: jgp.diag_sample(key, m, v, 2, mj))(*args)
    eps = np.asarray(jax.random.normal(key, (2,) + mu.shape, jnp.float64))
    got = tgp.diag_sample(torch.tensor(mu), torch.tensor(log_var), 2,
                          torch.tensor(mask), eps=torch.tensor(eps))
    assert _rel(got.numpy(), ref) <= FP64_REL

    ref = jax.jit(lambda m, v, f: jgp.recog_sample(key, m, v, f, 2, mj))(
        *args, jnp.asarray(l))
    eps = np.asarray(jax.random.normal(key, (2, 3, 2, 8), jnp.float64))
    got = tgp.recog_sample(torch.tensor(mu), torch.tensor(log_var),
                           torch.tensor(l), 2, torch.tensor(mask),
                           eps=torch.tensor(eps)).numpy()
    c = l + np.sqrt(np.exp(log_var)).transpose(0, 2, 1)[..., None] * np.eye(8)
    exact = (mu[None] + np.einsum("bzij,sbzj->sbiz", c, eps)) * mask[
        None, :, :, None]
    assert _rel(got, exact) <= FP64_REL
    assert _rel(got, ref) <= SAMPLED_REL
    # the batch diagonal of both packages
    v = np.random.default_rng(0).standard_normal((2, 3, 5))
    np.testing.assert_array_equal(tgp._batch_diag(torch.tensor(v)).numpy(),
                                  np.asarray(jgp._batch_diag(jnp.asarray(v))))
    # a generator's draw has each sampler's layout
    g = torch.Generator().manual_seed(0)
    assert tgp.diag_sample(torch.tensor(mu), torch.tensor(log_var), 4,
                           generator=g).shape == (4, 3, 8, 2)
    with pytest.raises(ValueError, match="eps must be"):
        tgp.recog_sample(torch.tensor(mu), torch.tensor(log_var),
                         torch.tensor(l), 2, eps=torch.tensor(eps[..., :4]))


def test_chol_gram_bank_diff_times_matches_jax_fp64():
    """``diff_times=True``: the times get the gradient of the gram's
    pullback, against JAX's autodiff of ``gram_bank`` and
    ``jnp.linalg.cholesky`` in float64; values, lengthscale and variance
    gradients unchanged."""
    times, mask, _, _, _ = _inputs(13, 3, 10, 2, False)
    ls, var = np.array([2.0, 5.0, 3.0]), np.array([1.0, 0.7, 1.3])
    w = np.random.default_rng(1).standard_normal((3, 3, 10, 10))
    mj = jnp.asarray(mask)

    def jloss(tt, l_, v_):
        k = jkernels.gram_bank(tt, l_, variance=v_, mask=mj)
        return jnp.sum(jnp.linalg.cholesky(k) * jnp.asarray(w))

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(times), jnp.asarray(ls), jnp.asarray(var))
    tt, lt, vt = (torch.tensor(a).requires_grad_(True)
                  for a in (times, ls, var))
    l = tgp.chol_gram_bank(tt, lt, mask=torch.tensor(mask), variance=vt,
                           diff_times=True)
    torch.sum(l * torch.tensor(w)).backward()
    for got, r in zip((tt.grad, lt.grad, vt.grad), ref):
        assert _rel(got.numpy(), r) <= FP64_REL


@pytest.mark.parametrize("via_inverse", [None, True, False])
def test_solve_triangular_via_inverse_matches_jax_fp64(via_inverse):
    """Every form of ``op(A) X = B`` / ``X op(A) = B`` on each route,
    against the JAX package's substitution route in float64."""
    _, _, _, _, l = _inputs(17, 2, 12, 2, False)
    rng = np.random.default_rng(2)
    for left_side in (True, False):
        for transpose_a in (False, True):
            b = rng.standard_normal((2, 2, 12, 3) if left_side
                                    else (2, 2, 3, 12))
            ref = jtrsm.solve_triangular(
                jnp.asarray(l), jnp.asarray(b), left_side=left_side,
                transpose_a=transpose_a, via_inverse=False)
            got = ttrsm.solve_triangular(
                torch.tensor(l), torch.tensor(b), left_side=left_side,
                transpose_a=transpose_a, via_inverse=via_inverse)
            assert _rel(got.numpy(), ref) <= FP64_REL


# ---------------------------------------------------------------------------
# GPVAE.forward, every pair
# ---------------------------------------------------------------------------

def _zoo_config(pair, net, shared):
    prior, posterior = pair
    ref_kl = posterior == "gp_plus_diag_ref"
    # fixed sides at l = 1: the JAX model holds a fixed side's
    # log-lengthscales as a float32 constant (log 1 = 0 is exact)
    return dict(
        prior=prior, posterior="gp_plus_diag" if ref_kl else posterior,
        reference_recog_kl=ref_kl, latent_dim=2, time_len=6,
        encoder=net, decoder=net,
        obs_dim=15 if net == "dense" else 64, image_shape=(8, 8, 1),
        prior_lengthscales=(1.0,), learn_prior_lengthscales=False,
        posterior_lengthscales=(2.0, 3.0),
        likelihood="gaussian" if prior == "standard" and net == "dense"
        else "bernoulli",
        shared_time_grid=shared)


def _zoo_batch(seed, cfg, b=3):
    rng = np.random.default_rng(seed)
    t = cfg["time_len"]
    if cfg["shared_time_grid"]:
        times = np.broadcast_to(np.arange(t, dtype=np.float64), (b, t)).copy()
        mask = np.ones((b, t), bool)
    else:
        times = np.sort(rng.uniform(0.0, 10.0, (b, t)), axis=-1)
        mask = rng.random((b, t)) > 0.3
        mask[:, 0] = True
    shape = ((b, t, cfg["obs_dim"]) if cfg["encoder"] == "dense"
             else (b, t) + cfg["image_shape"])
    x = (rng.random(shape) < 0.4).astype(np.float64)
    x *= mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    fmask = rng.random(shape) > 0.2
    return x, times, mask, fmask


def _random_params(jmodel, args, fields, seed=0):
    """float64 weights in the flax model's parameter tree, drawn with
    numpy (``jax.eval_shape`` gives the tree without compiling the
    initializer): N(0, 0.1) kernels, 0.1 biases, and the configured
    log-lengthscales of each learned GP side."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.key(0),
                                          "sample": jax.random.key(1)},
                            *args)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "log_ls" in name:
            raw = (fields["posterior_lengthscales"] if "posterior" in name
                   else fields["prior_lengthscales"])
            return np.log(np.broadcast_to(np.asarray(raw, np.float64),
                                          leaf.shape))
        if "bias" in name:
            return np.full(leaf.shape, 0.1)
        return 0.1 * rng.standard_normal(leaf.shape)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def zoo_cases(net):
    """Every pair on ``net``, and on a shared grid wherever it has a GP
    side, with its test id."""
    cases = [(pair, net, shared) for pair in PAIRS for shared in (False, True)
             if not (shared and pair == ("standard", "diag"))]
    ids = ["-".join(p) + f"-{n}" + ("-shared" if s else "")
           for p, n, s in cases]
    return cases, ids


def check_elbo_matches_jax(pair, net, shared, monkeypatch, *, extra=None,
                           band=None):
    """Loss, nll, kl, the latent draw and every gradient of the ELBO, the
    JAX model's noise fed to the port as ``eps``, with a ``feature_mask``
    and ``beta`` 0.7 (the Gaussian likelihood on the dense standard-prior
    pairs).  Also run by tests/test_torch_conv.py for the conv nets and by
    tests/test_torch_toeplitz.py, which sets more config fields
    (``extra``) and its own ``band``."""
    monkeypatch.setattr(jgp, "cholesky",
                        lambda k, method="auto": jnp.linalg.cholesky(k))
    fields = {**_zoo_config(pair, net, shared), **(extra or {})}
    cfg = GPVAEConfig(**fields)
    from gpvae_tpu.models import GPVAEConfig as JConfig
    jcfg = JConfig(**fields)
    x, times, mask, fmask = _zoo_batch(PAIRS.index(pair), fields)
    args = (jnp.asarray(x), jnp.asarray(times), jnp.asarray(mask))
    jmodel = JGPVAE(jcfg)
    params = _random_params(jmodel, args, fields)
    key = jax.random.key(3)

    def loss_fn(p):
        out = jmodel.apply(p, *args, beta=0.7,
                           feature_mask=jnp.asarray(fmask),
                           rngs={"sample": key})
        return out.loss, out

    (_, ref), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    sample_key = jmodel.apply(params, method=lambda m: m.make_rng("sample"),
                              rngs={"sample": key})
    model = GPVAE(cfg).double()
    convert.load_flax_params(model, jax.device_get(params))
    eps = np.asarray(jax.random.normal(
        sample_key, model.noise_shape(1, *mask.shape), jnp.float64))
    out = model(torch.tensor(x), torch.tensor(times), torch.tensor(mask),
                beta=0.7, feature_mask=torch.tensor(fmask),
                eps=torch.tensor(eps))
    out.loss.backward()
    if band is None:
        band = FP64_REL if cfg.posterior == "diag" else SAMPLED_REL
    assert _rel(out.latent_sample.detach().numpy(), ref.latent_sample) <= band
    for name in ("loss", "nll", "kl"):
        assert _rel(getattr(out, name).detach().numpy(),
                    getattr(ref, name)) <= band, name
    ref_grads = {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.device_get(jgrads["params"])).items()}
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref_grads)
    for name, g in got.items():
        assert _rel(g, ref_grads[name]) <= band, name
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("pair,net,shared", zoo_cases("dense")[0],
                         ids=zoo_cases("dense")[1])
def test_elbo_and_grads_match_jax_fp64(pair, net, shared, monkeypatch):
    """:func:`check_elbo_matches_jax` on the dense nets (the JAX model run
    op by op: its primitives compile once for all cases)."""
    check_elbo_matches_jax(pair, net, shared, monkeypatch)
