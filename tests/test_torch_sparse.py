"""The port's FITC sparse prior against the JAX package, on the CPU.

* ``fitc_prior_parts`` (``l_mm``, ``k_tm``, ``d``), ``fitc_diag_kl`` and
  ``fitc_prior_sample`` (fed the normals ``jax.random`` draws from the
  JAX function's own split key), masked and unmasked, with shared ``[m]``
  and per-sequence ``[B, m]`` inducing times, in float64 to ``FP64_REL``,
  values and gradients with respect to ``mu``, ``log_var`` and the
  lengthscales;
* the ``sparse_gp`` GPVAE's ELBO (T=64, m=16, Z=2), loss, nll, kl and
  every gradient through ``convert.py``, with and without a learned prior
  lengthscale;
* the configuration's validation, and ``train`` then ``evaluate`` of the
  ``sparse_t4096`` preset through ``__main__.main`` at a small T.

The JAX functions and model run as jitted programs with
``jnp.linalg.cholesky`` in place of the package's ``cholesky``, whose
reverse mode pins float32 (``gpvae_tpu/ops/chol.py:603``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import sparse as jsparse
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.ops import trsm as jtrsm
from gpvae_tpu.models import GPVAEConfig as JConfig
from gpvae_tpu_torch import convert, sparse
from gpvae_tpu_torch.__main__ import main
from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.ops import trsm

from test_torch_zoo import _random_params

FP64_REL = 1e-9


@pytest.fixture(autouse=True)
def jax_float64_cholesky(monkeypatch):
    monkeypatch.setattr(jsparse, "cholesky",
                        lambda k, method="auto": jnp.linalg.cholesky(k))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _inputs(seed, masked, per_seq, b=3, t=24, z=2, m=8):
    """times [B, T] on [0, 20], mask [B, T] or None, inducing times [m]
    or [B, m], lengthscales [Z], means and log-variances [B, T, Z]."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 20.0, (b, t)), axis=-1)
    mask = None
    if masked:
        mask = rng.random((b, t)) > 0.3
        mask[:, 0] = True
    if per_seq:
        lo = rng.uniform(-2.0, 2.0, (b, 1))
        inducing = lo + np.linspace(0.0, 20.0, m)[None] * rng.uniform(
            0.9, 1.1, (b, 1))
    else:
        inducing = np.linspace(0.0, 20.0, m)
    ls = rng.uniform(1.5, 3.0, z)
    mu = rng.standard_normal((b, t, z))
    log_var = 0.3 * rng.standard_normal((b, t, z))
    return times, mask, inducing, ls, mu, log_var


def _value_and_grads(jfn, tfn, args):
    """``fn(*args)`` and the gradient of its sum with respect to every
    argument, by the JAX function (jitted) and the port's."""
    def both(*a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp(jnp.ones_like(out))

    ref, ref_grads = jax.jit(both)(*[jnp.asarray(a) for a in args])
    ts = [torch.tensor(np.array(a)).requires_grad_(True) for a in args]
    out = tfn(*ts)
    out.sum().backward()
    return (out.detach().numpy(), [t.grad.numpy() for t in ts], ref,
            ref_grads)


CASES = [(masked, per_seq) for masked in (False, True)
         for per_seq in (False, True)]
IDS = [f"{'masked' if m else 'full'}-{'per_seq' if p else 'shared'}"
       for m, p in CASES]


@pytest.mark.parametrize("masked,per_seq", CASES, ids=IDS)
def test_fitc_prior_parts_match_jax_fp64(masked, per_seq):
    """``l_mm [B, Z, m, m]``, ``k_tm [B, Z, T, m]``, ``d [B, Z, T]``, and
    the gradient of a random weighting of all three with respect to the
    lengthscales and a per-latent variance."""
    times, mask, inducing, ls, _, _ = _inputs(1 + 2 * masked + per_seq,
                                              masked, per_seq)
    var = np.array([0.8, 1.3])
    rng = np.random.default_rng(9)
    w = [rng.standard_normal(s) for s in ((3, 2, 8, 8), (3, 2, 24, 8),
                                          (3, 2, 24))]
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.tensor(mask)

    def jparts(l, v):
        return jsparse.fitc_prior_parts(jnp.asarray(times),
                                        jnp.asarray(inducing), l, mask=mj,
                                        variance=v)

    def tparts(l, v):
        return sparse.fitc_prior_parts(torch.tensor(times),
                                       torch.tensor(inducing), l, mask=mt,
                                       variance=v)

    ref = jax.jit(jparts)(jnp.asarray(ls), jnp.asarray(var))
    got = tparts(torch.tensor(ls), torch.tensor(var))
    for name, g, r in zip(("l_mm", "k_tm", "d"), got, ref):
        assert g.shape == r.shape, name
        assert _rel(g.numpy(), r) <= FP64_REL, name

    def jloss(l, v):
        return sum(jnp.sum(p * jnp.asarray(wi))
                   for p, wi in zip(jparts(l, v), w))[None]

    def tloss(l, v):
        return sum(torch.sum(p * torch.tensor(wi))
                   for p, wi in zip(tparts(l, v), w))[None]

    got, grads, ref, ref_grads = _value_and_grads(jloss, tloss, (ls, var))
    assert _rel(got, ref) <= FP64_REL
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= FP64_REL


@pytest.mark.parametrize("masked,per_seq", CASES, ids=IDS)
def test_fitc_diag_kl_matches_jax_fp64(masked, per_seq):
    """The KL ``[B, Z]`` in the whitened form, and its gradients with
    respect to ``mu``, ``log_var`` and the lengthscales."""
    times, mask, inducing, ls, mu, log_var = _inputs(
        11 + 2 * masked + per_seq, masked, per_seq)
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.tensor(mask)
    got, grads, ref, ref_grads = _value_and_grads(
        lambda m, v, l: jsparse.fitc_diag_kl(
            m, v, jnp.asarray(times), jnp.asarray(inducing), l, mask=mj),
        lambda m, v, l: sparse.fitc_diag_kl(
            m, v, torch.tensor(times), torch.tensor(inducing), l, mask=mt),
        (mu, log_var, ls))
    assert got.shape == ref.shape == (3, 2)
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    assert _rel(got, ref) <= FP64_REL
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= FP64_REL


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_fitc_prior_sample_matches_jax_fp64(masked):
    """The JAX function's draw under ``key``, and the port's fed the
    normals that ``jax.random`` draws from the two halves of that key;
    masked steps draw from ``d = 1``, their ``K_tm`` rows zero."""
    times, mask, inducing, ls, _, _ = _inputs(21 + masked, masked, False)
    key = jax.random.key(5)
    mj = None if mask is None else jnp.asarray(mask)
    ref = jax.jit(lambda t, s, l: jsparse.fitc_prior_sample(
        key, t, s, l, 2, mask=mj))(*[jnp.asarray(a)
                                     for a in (times, inducing, ls)])
    k1, k2 = jax.random.split(key)
    eps_m = np.asarray(jax.random.normal(k1, (2, 3, 2, 8)))
    eps_t = np.asarray(jax.random.normal(k2, (2, 3, 2, 24)))
    got = sparse.fitc_prior_sample(
        torch.tensor(times), torch.tensor(inducing), torch.tensor(ls), 2,
        mask=None if mask is None else torch.tensor(mask),
        eps_m=torch.tensor(eps_m), eps_t=torch.tensor(eps_t))
    assert got.shape == ref.shape == (2, 3, 24, 2)
    assert _rel(got.numpy(), ref) <= FP64_REL
    # a generator's draw has the same layout; a wrong eps shape raises
    g = torch.Generator().manual_seed(0)
    assert sparse.fitc_prior_sample(
        torch.tensor(times), torch.tensor(inducing), torch.tensor(ls), 3,
        generator=g).shape == (3, 3, 24, 2)
    with pytest.raises(ValueError, match="eps must be"):
        sparse.fitc_prior_sample(
            torch.tensor(times), torch.tensor(inducing), torch.tensor(ls), 2,
            eps_m=torch.tensor(eps_m[..., :4]), eps_t=torch.tensor(eps_t))


@pytest.mark.parametrize("left_side,transpose_a", [
    (True, False), (True, True), (False, False), (False, True)])
def test_inverse_route_gradients_match_jax_fp64(left_side, transpose_a):
    """``solve_triangular(via_inverse=True)`` (the card's route for
    FITC's solves), values and the gradients of their sum with respect to
    ``A`` and ``B``, against the JAX package's substitution route, with a
    factor shared across a leading batch dim: its own reverse mode, not
    autograd through the inverse."""
    rng = np.random.default_rng(31)
    a = np.tril(rng.standard_normal((1, 2, 7, 7))) + 4.0 * np.eye(7)
    b = rng.standard_normal((3, 2, 7, 5) if left_side else (3, 2, 5, 7))
    form = dict(left_side=left_side, transpose_a=transpose_a)
    got, grads, ref, ref_grads = _value_and_grads(
        lambda x, y: jtrsm.solve_triangular(
            jnp.broadcast_to(x, (3, 2, 7, 7)), y, via_inverse=False, **form),
        lambda x, y: trsm.solve_triangular(x, y, via_inverse=True, **form),
        (a, b))
    assert _rel(got, ref) <= FP64_REL
    assert _rel(grads[0], np.tril(np.asarray(ref_grads[0]))) <= FP64_REL
    assert _rel(grads[1], ref_grads[1]) <= FP64_REL


def test_jitter_and_inducing_grid_match_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        assert sparse._resolve_jitter(None, dtype) == \
            jsparse._resolve_jitter(None, jdtype)
        assert sparse._resolve_jitter(3e-5, dtype) == 3e-5
    np.testing.assert_allclose(
        sparse.uniform_inducing_times(0.0, 4096.0, 64,
                                      dtype=torch.float64).numpy(),
        np.asarray(jsparse.uniform_inducing_times(0.0, 4096.0, 64)),
        rtol=1e-15, atol=1e-12)


# ---------------------------------------------------------------------------
# the sparse_gp GPVAE
# ---------------------------------------------------------------------------

def _sparse_fields(learn):
    # times 0 .. 15.75 (T=64), 16 inducing points over [0, 16] at l = 1:
    # the inducing grid as fine as the lengthscale, so that Q carries most
    # of K.  A fixed side's log-lengthscales are a float32 constant in the
    # JAX model, exact at log 1 = 0.
    return dict(prior="sparse_gp", posterior="diag", latent_dim=2,
                time_len=64, obs_dim=15, num_inducing=16,
                inducing_time_range=(0.0, 16.0), prior_lengthscales=(1.0,),
                learn_prior_lengthscales=learn)


@pytest.mark.parametrize("learn", [False, True], ids=["fixed", "learned"])
def test_sparse_elbo_and_grads_match_jax_fp64(learn):
    """Loss, nll, kl and every gradient (the prior's log-lengthscales when
    learned), the JAX model's noise fed to the port as ``eps``, beta 0.7,
    on masked toy sequences."""
    fields = _sparse_fields(learn)
    raw = generate_toy_data(np.random.default_rng(3), 3, t=64, xmax=15.75)
    batch = toy_to_masked_batch(raw)
    x, times, mask = (batch["x"].astype(np.float64),
                      batch["times"].astype(np.float64), batch["mask"])
    args = (jnp.asarray(x), jnp.asarray(times), jnp.asarray(mask))
    jmodel = JGPVAE(JConfig(**fields))
    params = _random_params(jmodel, args, fields, seed=2)
    key = jax.random.key(4)

    def loss_fn(p):
        out = jmodel.apply(p, *args, beta=0.7, rngs={"sample": key})
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    sample_key = jmodel.apply(params, method=lambda m: m.make_rng("sample"),
                              rngs={"sample": key})
    model = GPVAE(GPVAEConfig(**fields)).double()
    convert.load_flax_params(model, jax.device_get(params))
    assert ("prior_log_ls" in dict(model.named_parameters())) == learn
    assert "prior_log_ls" in model.state_dict()
    eps = np.asarray(jax.random.normal(
        sample_key, model.noise_shape(1, *mask.shape), jnp.float64))
    out = model(torch.tensor(x), torch.tensor(times), torch.tensor(mask),
                beta=0.7, eps=torch.tensor(eps))
    out.loss.backward()
    for name in ("loss", "nll", "kl"):
        assert _rel(getattr(out, name).detach().numpy(),
                    getattr(ref, name)) <= FP64_REL, name
    ref_grads = {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.device_get(jgrads["params"])).items()}
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref_grads)
    for name, g in got.items():
        assert _rel(g, ref_grads[name]) <= FP64_REL, name
    np.testing.assert_allclose(
        model.inducing_times(dtype=torch.float64).numpy(),
        np.asarray(jmodel.apply(params, method=lambda m: m.inducing_times())),
        rtol=1e-15, atol=1e-14)


@pytest.mark.parametrize("overrides", [
    dict(posterior="gp"), dict(inducing_time_range=None),
    dict(posterior="gp_plus_diag", prior="sparse_gp")],
    ids=["gp_posterior", "no_inducing_range", "recognition_posterior"])
def test_sparse_config_validation_raises_jax_errors(overrides):
    fields = dict(_sparse_fields(False), **overrides)
    with pytest.raises(ValueError) as ref:
        JConfig(**fields)
    with pytest.raises(ValueError) as ours:
        GPVAEConfig(**fields)
    assert str(ours.value) == str(ref.value)


def test_cli_trains_and_evaluates_sparse_t4096(tmp_path, capsys):
    """The preset at its widths but T=64 (``--time-len``): two steps and a
    checkpoint, then evaluate on it prints the imputation metrics; the
    model conditions under the prior's exact RBF kernel."""
    common = ["--preset", "sparse_t4096", "--device", "cpu", "--num-seqs",
              "20", "--time-len", "64", "--seed", "0", "--ckpt-dir",
              str(tmp_path)]
    main(["train", *common, "--steps", "2"])
    assert "done at step 2" in capsys.readouterr().out
    main(["evaluate", *common, "--eval-batch", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 2"
    metrics = json.loads(lines[1])
    assert metrics["dropped_steps"] > 0
    assert all(np.isfinite(metrics[k]) for k in (
        "nll_gp_impute", "mse_gp_impute", "nll_baseline", "mse_baseline"))
