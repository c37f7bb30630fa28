"""The port's healing-MNIST slice against the JAX package, on the CPU.

* ``make_healing_batch`` and its parts, bit for bit at several seeds and
  sizes; the ``healing_mnist`` and ``sparse_t4096`` presets field for
  field;
* the ELBO of a Cauchy, shared-grid healing model on 28 x 28 frames with
  a ``feature_mask`` (T=3, Z=4, B=2): loss, nll, kl, the draw and every
  gradient through ``convert.py``, to ``FP64_REL``;
* ``pixel_imputation_metrics`` and ``eval_step`` function for function;
* ``fit(callbacks=...)`` firing at the JAX package's steps, ``fit`` over
  a plain iterator giving the Batcher path's losses, and
  ``make_artifact_callback``'s PNGs;
* ``train`` (with ``--plots``) then ``evaluate`` of ``healing_mnist``
  through ``__main__.main``, and ``generate-data`` read back by
  ``train --data``.

The JAX model runs jitted with ``jnp.linalg.cholesky`` in place of the
package's ``cholesky`` (whose reverse mode pins float32) and its
``gp_sample`` with the einsum in float64 (the package's asks for float32
results, ``gpvae_tpu/gp.py:546-553``); both are the same formulas.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import analysis as janalysis
from gpvae_tpu import configs as jconfigs
from gpvae_tpu import gp as jgp
from gpvae_tpu import train as jtrain
from gpvae_tpu.data import Batcher as JBatcher
from gpvae_tpu.data import healing as jhealing
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.models import GPVAEConfig as JConfig
from gpvae_tpu_torch import analysis, configs, convert, train
from gpvae_tpu_torch.__main__ import main
from gpvae_tpu_torch.data import (
    Batcher, generate_toy_data, healing, make_healing_batch,
)
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig

from test_torch_zoo import _random_params

FP64_REL = 1e-9


def _gp_sample_fp64(key, mu, l_q, num_samples=1, mask=None):
    """``gpvae_tpu.gp.gp_sample`` with its einsum in the inputs' dtype."""
    b = mu.shape[0]
    _, z, t, _ = l_q.shape
    eps = jax.random.normal(key, (num_samples, b, z, t), dtype=mu.dtype)
    hi = jax.lax.Precision.HIGHEST
    if l_q.shape[0] == 1 and b > 1:
        corr = jnp.einsum("zij,sbzj->sbiz", l_q[0], eps, precision=hi)
    else:
        corr = jnp.einsum("bzij,sbzj->sbiz", l_q, eps, precision=hi)
    out = mu[None] + corr
    if mask is not None:
        out = out * mask.astype(out.dtype)[None, :, :, None]
    return out


@pytest.fixture
def jax_fp64(monkeypatch):
    monkeypatch.setattr(jgp, "cholesky",
                        lambda k, method="auto": jnp.linalg.cholesky(k))
    monkeypatch.setattr(jgp, "gp_sample", _gp_sample_fp64)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("n,t,size,missing,seed", [
    (3, 5, 28, 0.5, 0), (4, 4, 16, 0.3, 3), (2, 10, 28, 0.5, 7)])
def test_healing_data_is_bit_identical_to_jax(n, t, size, missing, seed):
    ours = make_healing_batch(n, t=t, size=size, missing_fraction=missing,
                              seed=seed)
    ref = jhealing.make_healing_batch(n, t=t, size=size,
                                      missing_fraction=missing, seed=seed)
    assert set(ours) == set(ref)
    for key, v in ref.items():
        assert ours[key].dtype == v.dtype and ours[key].shape == v.shape
        np.testing.assert_array_equal(ours[key], v)
    np.testing.assert_array_equal(
        healing.synthetic_healing_sequences(n, t=t, size=size, seed=seed),
        jhealing.synthetic_healing_sequences(n, t=t, size=size, seed=seed))
    shape = (n, t, size, size, 1)
    np.testing.assert_array_equal(
        healing.random_pixel_mask(shape, missing, seed=seed),
        jhealing.random_pixel_mask(shape, missing, seed=seed))
    assert 0 < ours["x_clean"].mean() < 1
    assert not ours["x"][~ours["feature_mask"]].any()


@pytest.mark.parametrize("name", ["healing_mnist", "sparse_t4096"])
def test_baseline_presets_match_jax(name):
    ours, ref = configs.get(name), jconfigs.get(name)
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(ref.model)
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
    assert (ours.batch_size, ours.description, ours.data_family) == (
        ref.batch_size, ref.description, ref.data_family)
    assert ours.resolved_data_family == ref.resolved_data_family
    GPVAE(ours.model)  # both build: check_ported refuses only Toeplitz


def _healing_fields(**overrides):
    # the fixed prior at l = 1: the JAX model holds a fixed side's
    # log-lengthscales as a float32 constant and takes its exp in float32,
    # exact only at log 1 = 0
    return dataclasses.asdict(dataclasses.replace(
        configs.get("healing_mnist").model, prior_lengthscales=(1.0,),
        **overrides))


def _models(fields, batch, seed=0):
    """The JAX model with numpy-drawn float64 weights, and the port's
    model with the same weights."""
    args = (jnp.asarray(batch["x"], jnp.float64),
            jnp.asarray(batch["times"], jnp.float64),
            jnp.asarray(batch["mask"]))
    jmodel = JGPVAE(JConfig(**fields))
    params = _random_params(jmodel, args, fields, seed=seed)
    model = GPVAE(GPVAEConfig(**fields)).double()
    convert.load_flax_params(model, jax.device_get(params))
    return jmodel, params, model, args


def _jax_eps(jmodel, params, key, shape):
    sample_key = jmodel.apply(params, method=lambda m: m.make_rng("sample"),
                              rngs={"sample": key})
    return torch.tensor(np.asarray(jax.random.normal(sample_key, shape,
                                                     jnp.float64)))


def test_healing_elbo_and_grads_match_jax_fp64(jax_fp64):
    """28 x 28 frames through the conv nets, the Cauchy kernel on one
    shared grid (one stacked [1, 2Z, T, T] bank), missing pixels out of
    the NLL by ``feature_mask``, beta 0.7."""
    fields = _healing_fields(latent_dim=4, time_len=3)
    batch = make_healing_batch(2, t=3, seed=5)
    jmodel, params, model, args = _models(fields, batch)
    fmask = batch["feature_mask"]
    key = jax.random.key(6)

    def loss_fn(p):
        out = jmodel.apply(p, *args, beta=0.7,
                           feature_mask=jnp.asarray(fmask),
                           rngs={"sample": key})
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    eps = _jax_eps(jmodel, params, key, model.noise_shape(1, 2, 3))
    out = model(*(torch.tensor(np.asarray(a)) for a in args), beta=0.7,
                feature_mask=torch.tensor(fmask), eps=eps)
    out.loss.backward()
    assert _rel(out.latent_sample.detach().numpy(),
                ref.latent_sample) <= FP64_REL
    for name in ("loss", "nll", "kl"):
        assert _rel(getattr(out, name).detach().numpy(),
                    getattr(ref, name)) <= FP64_REL, name
    # the feature mask matters: without it the NLL is another number
    with torch.no_grad():
        full = model(*(torch.tensor(np.asarray(a)) for a in args), beta=0.7,
                     eps=eps)
    assert _rel(full.nll.numpy(), ref.nll) > 1e-3
    ref_grads = {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.device_get(jgrads["params"])).items()}
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref_grads)
    assert "posterior_log_ls" in got and "prior_log_ls" not in got
    for name, g in got.items():
        assert _rel(g, ref_grads[name]) <= FP64_REL, name


def _small_healing(seed=2, b=3):
    """A healing model on 8 x 8 frames (Z=3, T=4) and its batch."""
    fields = _healing_fields(latent_dim=3, time_len=4, obs_dim=64,
                             image_shape=(8, 8, 1))
    batch = make_healing_batch(b, t=4, size=8, seed=seed)
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    return fields, batch


def test_pixel_imputation_metrics_match_jax_fp64():
    fields, batch = _small_healing()
    jmodel, params, model, _ = _models(fields, batch)
    ref = janalysis.pixel_imputation_metrics(jmodel, params["params"], batch,
                                             key=jax.random.key(0))
    got = analysis.pixel_imputation_metrics(model, batch)
    assert set(got) == set(ref)
    assert got["missing_pixels"] == ref["missing_pixels"] > 0
    for k, v in ref.items():
        assert _rel(got[k], v) <= FP64_REL, k
    # tensors on the model's device take the same route
    tensors = {k: torch.tensor(v) for k, v in batch.items()}
    assert analysis.pixel_imputation_metrics(model, tensors) == got


def test_eval_step_matches_jax_fp64(jax_fp64):
    fields, batch = _small_healing(seed=4)
    jmodel, params, model, args = _models(fields, batch, seed=1)
    key = jax.random.key(8)
    ref = jtrain.eval_step(jmodel, params["params"], batch, key, beta=0.5)
    eps = _jax_eps(jmodel, params, key, model.noise_shape(1, 3, 4))
    got = train.eval_step(model, {k: torch.tensor(np.asarray(a)) for k, a in
                                  zip(("x", "times", "mask"), args)},
                          beta=0.5, eps=eps)
    assert set(got) == set(ref)
    for k in ref:
        assert not got[k].requires_grad
        assert _rel(got[k].numpy(), ref[k]) <= FP64_REL, k


def _toy_arrays(n=8, t=12, seed=0):
    from gpvae_tpu_torch.data import toy_to_masked_batch

    return toy_to_masked_batch(generate_toy_data(np.random.default_rng(seed),
                                                 n, t=t))


def test_fit_callbacks_fire_at_the_jax_steps():
    """Every ``every``-th step, after the step, for both packages' loops
    over a plain iterator (and the port's Batcher path), with log points
    and checkpoints between."""
    arrays = _toy_arrays()
    # a model without a GP: the loops' step counting is the same for
    # every model, and the JAX step compiles in a third of the time
    cfg = dict(latent_dim=2, obs_dim=15, time_len=12, prior="standard",
               posterior="diag")
    config = dict(num_steps=13, log_every=5)
    calls = {}
    for name in ("jax", "batcher", "iterator"):
        seen = []
        callbacks = [(4, lambda s, step, seen=seen: seen.append((4, step))),
                     (6, lambda s, step, seen=seen: seen.append((6, step)))]
        if name == "jax":
            jtrain.fit(JGPVAE(JConfig(**cfg)), iter(JBatcher(arrays, 4)),
                       jtrain.TrainConfig(**config), verbose=False,
                       callbacks=callbacks)
        else:
            batches = Batcher(arrays, 4)
            train.fit(GPVAE(GPVAEConfig(**cfg)),
                      batches if name == "batcher" else iter(list(
                          next(batches) for _ in range(13))),
                      train.TrainConfig(**config), device="cpu",
                      verbose=False, callbacks=callbacks)
        calls[name] = seen
    assert calls["jax"] == [(4, 4), (6, 6), (4, 8), (4, 12), (6, 12)]
    assert calls["batcher"] == calls["iterator"] == calls["jax"]


def test_fit_over_an_iterator_gives_the_batcher_paths_losses(tmp_path):
    """The same batches (healing frames with their ``feature_mask``) and
    the same weights and noise: the logged losses agree; a finite
    iterator of exactly ``num_steps`` batches ends with its checkpoint."""
    fields, batch = _small_healing(b=6)
    arrays = {k: batch[k] for k in ("x", "times", "mask", "feature_mask")}
    config = train.TrainConfig(num_steps=6, log_every=2)
    logs = {}
    for name in ("batcher", "iterator"):
        model = GPVAE(GPVAEConfig(**fields),
                      generator=torch.Generator().manual_seed(0))
        batches = Batcher(arrays, 3, seed=1)
        if name == "iterator":
            batches = iter([next(batches) for _ in range(6)])
        state, log = train.fit(
            model, batches, dataclasses.replace(
                config, checkpoint_dir=str(tmp_path / name)),
            device="cpu", verbose=False)
        assert state.step == 6
        assert train.CheckpointManager(str(tmp_path / name)).steps() == [6]
        logs[name] = [r["loss"] for r in log.rows]
    assert len(logs["batcher"]) == 3
    np.testing.assert_allclose(logs["iterator"], logs["batcher"], rtol=1e-6)


@pytest.mark.parametrize("net", ["conv", "dense"])
def test_artifact_callback_writes_its_pngs(net, tmp_path):
    if net == "conv":
        fields, batch = _small_healing(b=4)
        arrays = {k: batch[k] for k in ("x", "times", "mask",
                                        "feature_mask")}
        want = ["input_{:08d}.png", "recon_{:08d}.png"]
    else:
        fields = dict(latent_dim=2, obs_dim=15, time_len=12)
        arrays = _toy_arrays()
        want = ["latents_{:08d}.png"]
    model = GPVAE(GPVAEConfig(**fields))
    probe = {k: v[:2] for k, v in arrays.items()}
    cb = analysis.make_artifact_callback(model, probe, str(tmp_path / "art"))
    train.fit(model, Batcher(arrays, 2), train.TrainConfig(
        num_steps=4, log_every=4), device="cpu", verbose=False,
        callbacks=[(2, cb)])
    assert sorted(p.name for p in (tmp_path / "art").iterdir()) == sorted(
        w.format(s) for w in want for s in (2, 4))


def test_cli_trains_and_evaluates_healing_mnist(tmp_path, capsys):
    """The preset at its widths (Z=64, 28 x 28 frames, the Cauchy kernel)
    at T=3 and batch 4: two steps with ``--plots`` every step, then
    evaluate prints the missing-pixel metrics of the held-out sequences."""
    common = ["--preset", "healing_mnist", "--device", "cpu", "--num-seqs",
              "20", "--time-len", "3", "--seed", "0", "--ckpt-dir",
              str(tmp_path / "ck")]
    main(["train", *common, "--steps", "2", "--batch-size", "4",
          "--plots", str(tmp_path / "plots"), "--plots-every", "1"])
    assert "done at step 2" in capsys.readouterr().out
    assert len(list((tmp_path / "plots").iterdir())) == 4
    main(["evaluate", *common, "--batch-size", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 2"
    metrics = json.loads(lines[1])
    assert sorted(metrics) == ["missing_pixels", "mse_marginal_baseline",
                               "mse_model", "nll_marginal_baseline",
                               "nll_model"]
    # the last 10% of 20 sequences: 2 x 3 frames of 28 x 28, half missing
    assert 0 < metrics["missing_pixels"] < 2 * 3 * 28 * 28
    assert all(np.isfinite(v) for v in metrics.values())


def test_cli_generate_data_is_read_back_by_train(tmp_path, capsys):
    path = str(tmp_path / "toy.npz")
    main(["generate-data", "--out", path, "--num-seqs", "30", "--time-len",
          "12", "--seed", "1"])
    assert capsys.readouterr().out.strip() == (
        f"wrote 30 sequences to {path}")
    want = generate_toy_data(np.random.default_rng(1), 30, t=12)
    with np.load(path) as f:
        assert set(f.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(f[k], v)
    main(["train", "--preset", "syn_data", "--data", path, "--time-len",
          "12", "--steps", "2", "--device", "cpu"])
    assert "done at step 2" in capsys.readouterr().out
