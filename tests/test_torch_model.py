"""The port's model, training step and entry points against the JAX
package, on the CPU: the flax-params converter, the whole ``syn_data``
ELBO (loss, nll, kl, every gradient), a 3-step Adam loss trajectory, the
CLI, and the import boundary (the port never imports JAX).

The ELBO's noise is the JAX model's own: the key its ``sample`` stream
hands ``gp_sample``, drawn as ``normal(key, (S, B, Z, T))`` and fed to the
port as ``eps``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpvae_tpu import configs as jconfigs
from gpvae_tpu import gp as jgp
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.utils import reference_math
from gpvae_tpu_torch import configs, convert, train
from gpvae_tpu_torch.data import Batcher
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4  # the preset's widths (T=45, Z=2, 15 observed dims) at batch 4
# The JAX model's float64 ELBO carries float32 rounding: gp_sample's
# einsum asks for float32 results (gpvae_tpu/gp.py:546-553).  Against it
# the port's float64 ELBO is held to 1e-7; against the float64 oracle
# (reference_math, which clamps p + 1e-10 in its NLL) to 1e-8.
FP64_VS_JAX_REL = 1e-7
FP64_VS_ORACLE_REL = 1e-8
# float32, the JAX kernel route (Pallas interpret mode) against the port's
# plain path: loss and gradients to 2e-4 relative; the lengthscale
# gradient runs through the Cholesky reverse mode of a K with cond ~1e4,
# which amplifies float32 rounding, and is held to 2e-3
FP32_REL = 2e-4
FP32_LOG_LS_REL = 2e-3


@pytest.fixture
def jax_inverse_route():
    prev = jgp.FORCE_INVERSE_PATH
    jgp.FORCE_INVERSE_PATH = True
    try:
        yield
    finally:
        jgp.FORCE_INVERSE_PATH = prev


def _batch(seed, b=B, t=45, d=15):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    mask = rng.random((b, t)) > 0.4
    mask[:, 0] = True
    x = (rng.random((b, t, d)) < 0.4) * mask[..., None]
    return x.astype(np.float64), times, mask


def _jax_model(cfg, x, times, mask, dtype):
    model = JGPVAE(cfg)
    params = model.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.asarray(x, dtype), jnp.asarray(times, dtype), jnp.asarray(mask))
    return model, jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


def _jax_eps(model, params, key, shape, dtype):
    """The noise the JAX model draws under ``rngs={"sample": key}``."""
    sample_key = model.apply(params, method=lambda m: m.make_rng("sample"),
                             rngs={"sample": key})
    return np.asarray(jax.random.normal(sample_key, shape, dtype))


def _port_model(cfg, params, dtype):
    port_cfg = GPVAEConfig(**dataclasses.asdict(cfg))
    model = GPVAE(port_cfg).to(dtype)
    convert.load_flax_params(model, jax.device_get(params))
    return model


def _grads_by_port_name(jgrads):
    return {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.device_get(jgrads)).items()}


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def test_convert_flax_params():
    cfg = jconfigs.get("syn_data").model
    x, times, mask = _batch(0, b=2)
    jmodel, params = _jax_model(cfg, x, times, mask, jnp.float64)
    model = _port_model(cfg, params, torch.float64)
    p = params["params"]
    sd = model.state_dict()
    for net, head in (("encoder_net", "mean_head"),
                      ("decoder_net", "logits_head")):
        for i in range(4):
            np.testing.assert_array_equal(
                sd[f"{net}.dense.{i}.weight"].numpy(),
                np.asarray(p[net][f"Dense_{i}"]["kernel"]).T)
        np.testing.assert_array_equal(sd[f"{net}.{head}.bias"].numpy(),
                                      np.asarray(p[net][head]["bias"]))
    np.testing.assert_array_equal(sd["posterior_log_ls"].numpy(),
                                  np.asarray(p["posterior_log_ls"]))
    # the nets compute the same functions
    ref = jmodel.apply(params, jnp.asarray(x), method=lambda m, v: m.encode(v))
    got = model.encode(torch.tensor(x))
    assert _rel(got.detach().numpy(), ref) <= 1e-12
    with pytest.raises(KeyError, match="unknown flax parameter"):
        convert.flax_to_state_dict({"bogus": np.zeros(2)})


def test_port_init_follows_the_reference_initializers():
    model = GPVAE(configs.get("syn_data").model,
                  generator=torch.Generator().manual_seed(0))
    w = torch.cat([m.weight.reshape(-1) for m in model.modules()
                   if isinstance(m, torch.nn.Linear)])
    assert w.abs().max() <= 0.2  # truncated at two standard deviations
    assert 0.06 < w.std() < 0.1  # std of N(0, 0.1) cut at +-2 sd: 0.088
    assert all(torch.all(m.bias == 0.1) for m in model.modules()
               if isinstance(m, torch.nn.Linear))
    np.testing.assert_allclose(torch.exp(model.posterior_log_ls).detach().numpy(),
                               [9.0, 3.0], rtol=1e-6)


def test_syn_data_elbo_matches_jax_fp64():
    """Loss, nll and kl in float64; a learnable prior, because the JAX
    model holds a fixed prior's log-lengthscales as a float32 constant
    even in float64 mode (models.py:288).  Gradients are held in float32
    below: the JAX model's backward pins float32 (ops/chol.py:603) and
    does not run in float64."""
    cfg = dataclasses.replace(jconfigs.get("syn_data").model,
                              learn_prior_lengthscales=True)
    x, times, mask = _batch(1)
    jmodel, params = _jax_model(cfg, x, times, mask, jnp.float64)
    key = jax.random.key(3)
    ref = jmodel.apply(params, jnp.asarray(x), jnp.asarray(times),
                       jnp.asarray(mask), beta=0.5, rngs={"sample": key})
    eps = _jax_eps(jmodel, params, key, (1, B, 2, 45), jnp.float64)
    model = _port_model(cfg, params, torch.float64)
    out = model(torch.tensor(x), torch.tensor(times), torch.tensor(mask),
                beta=0.5, eps=torch.tensor(eps))
    # the injected noise reproduces the JAX draw
    assert _rel(out.latent_sample.detach().numpy(),
                ref.latent_sample) <= FP64_VS_JAX_REL
    for name in ("loss", "nll", "kl"):
        assert _rel(getattr(out, name).detach().numpy(),
                    getattr(ref, name)) <= FP64_VS_JAX_REL, name
    oracle = reference_math.fp64_elbo(
        jax.device_get(params["params"]), x, times, mask,
        out.latent_sample[0].detach().numpy(), 0.5)
    assert abs(out.kl.sum().item() - oracle["kl"]) <= (
        FP64_VS_ORACLE_REL * abs(oracle["kl"]))
    assert abs(out.loss.item() - oracle["loss"]) <= (
        FP64_VS_ORACLE_REL * abs(oracle["loss"]))


def test_syn_data_elbo_and_grads_match_jax_kernel_route_fp32(
        jax_inverse_route):
    """The preset as it is, the JAX side on its TPU route: the fused
    Pallas gram+Cholesky and the Pallas triangular inverse (interpret)."""
    cfg = dataclasses.replace(jconfigs.get("syn_data").model,
                              cov_impl="fused")
    x, times, mask = _batch(2)
    jmodel, params = _jax_model(cfg, x, times, mask, jnp.float32)
    key = jax.random.key(4)
    args = (jnp.asarray(x, jnp.float32), jnp.asarray(times, jnp.float32),
            jnp.asarray(mask))

    def loss_fn(p):
        out = jmodel.apply(p, *args, beta=0.3, rngs={"sample": key})
        return out.loss, out

    (_, ref), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    eps = _jax_eps(jmodel, params, key, (1, B, 2, 45), jnp.float32)
    model = _port_model(cfg, params, torch.float32)
    out = model(torch.tensor(x, dtype=torch.float32),
                torch.tensor(times, dtype=torch.float32),
                torch.tensor(mask), beta=0.3, eps=torch.tensor(eps))
    out.loss.backward()
    assert _rel(out.latent_sample.detach().numpy(),
                ref.latent_sample) <= FP32_REL
    for name in ("loss", "nll", "kl"):
        assert _rel(getattr(out, name).detach().numpy(),
                    getattr(ref, name)) <= FP32_REL, name
    ref_grads = _grads_by_port_name(jgrads["params"])
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref_grads)
    for name, g in got.items():
        band = FP32_LOG_LS_REL if name.endswith("log_ls") else FP32_REL
        assert _rel(g, ref_grads[name]) <= band, name


def test_adam_three_step_loss_trajectory_matches_jax():
    """Three Adam steps at lr 2e-4 from the same weights with the same
    noise: the losses agree (training parity is asserted on losses, not
    parameters: Adam's normalized update amplifies rounding in tiny
    gradient components).  float32, both packages on their CPU routes."""
    cfg = jconfigs.get("syn_data").model
    x, times, mask = _batch(5)
    jmodel, params = _jax_model(cfg, x, times, mask, jnp.float32)
    model = _port_model(cfg, params, torch.float32)
    tx = optax.adam(2e-4)
    opt_state = tx.init(params)
    state = train.TrainState(model, torch.optim.Adam(model.parameters(),
                                                     lr=2e-4), 0, None)
    beta = train.TrainConfig().beta
    batch = {"x": torch.tensor(x, dtype=torch.float32),
             "times": torch.tensor(times, dtype=torch.float32),
             "mask": torch.tensor(mask)}
    args = (jnp.asarray(x, jnp.float32), jnp.asarray(times, jnp.float32),
            jnp.asarray(mask))
    @jax.jit
    @jax.value_and_grad
    def loss_and_grad(p, key, beta_):
        return jmodel.apply(p, *args, beta=beta_, rngs={"sample": key}).loss

    jax_losses, port_losses = [], []
    for step in range(3):
        key = jax.random.key(10 + step)
        loss, grads = loss_and_grad(params, key, beta(step))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        eps = _jax_eps(jmodel, params, key, (1, B, 2, 45), jnp.float32)
        metrics = train.train_step(state, batch, beta(step),
                                   eps=torch.tensor(eps))
        jax_losses.append(float(loss))
        port_losses.append(metrics["loss"].item())
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-5)
    assert state.step == 3


def test_fit_trains_on_the_cpu_from_a_batcher(tmp_path):
    x, times, mask = _batch(6, b=12)
    data = {"x": x.astype(np.float32), "times": times.astype(np.float32),
            "mask": mask}
    batcher = Batcher(data, 4, seed=0)
    ref = Batcher(data, 4, seed=0)
    cfg = train.TrainConfig(num_steps=6, log_every=3, seed=0)
    model = GPVAE(configs.get("syn_data").model,
                  generator=torch.Generator().manual_seed(0))
    csv = tmp_path / "log.csv"
    state, log = train.fit(model, batcher, cfg, device="cpu",
                           csv_path=str(csv), verbose=False)
    assert state.step == 6 and [r["step"] for r in log.rows] == [3, 6]
    assert all(np.isfinite(r["loss"]) for r in log.rows)
    assert csv.read_text().splitlines()[0].startswith("step,loss,nll,kl,beta")
    assert len(log.rows[0]["lengthscale_posterior"]) == 2
    # fit consumed the index stream batch for batch
    for _ in range(6):
        ref.next_indices()
    np.testing.assert_array_equal(batcher.next_indices(), ref.next_indices())


def test_fit_refuses_what_is_not_ported():
    model = GPVAE(configs.get("syn_data").model)
    batcher = Batcher({"x": np.zeros((4, 45, 15), np.float32),
                       "times": np.zeros((4, 45), np.float32),
                       "mask": np.ones((4, 45), bool)}, 2)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        train.fit(model, batcher, train.TrainConfig(checkpoint_dir="ck"),
                  device="cpu")
    with pytest.raises(TypeError, match="Batcher"):
        train.fit(model, iter([]), train.TrainConfig(), device="cpu")


@pytest.mark.parametrize("overrides,slice_", [
    (dict(posterior="diag"), "slice 3"),
    (dict(prior="standard"), "slice 3"),
    (dict(encoder="conv"), "slice 3"),
    (dict(shared_time_grid=True), "slice 3"),
    (dict(prior="sparse_gp", posterior="diag",
          inducing_time_range=(0.0, 1.0)), "slice 4"),
])
def test_unported_configurations_name_their_slice(overrides, slice_):
    cfg = GPVAEConfig(**overrides)
    with pytest.raises(NotImplementedError, match=slice_):
        GPVAE(cfg)


def test_config_validation_matches_jax():
    fields = {f.name for f in dataclasses.fields(GPVAEConfig)}
    from gpvae_tpu.models import GPVAEConfig as JConfig
    assert fields == {f.name for f in dataclasses.fields(JConfig)}
    with pytest.raises(ValueError, match="cov_impl"):
        GPVAEConfig(cov_impl="cuda")
    assert configs.get("syn_data").model == GPVAEConfig(
        **dataclasses.asdict(jconfigs.get("syn_data").model))
    assert configs.get("syn_data_vm").train.beta == train.TrainConfig(
        beta=configs.get("syn_data_vm").train.beta).beta
    assert configs.get("syn_data").train.beta(25_000) == pytest.approx(
        float(jconfigs.get("syn_data").train.beta(jnp.asarray(25_000))))


def _run(args, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_import_leaves_jax_out():
    code = (
        "import sys, gpvae_tpu_torch, gpvae_tpu_torch.__main__, "
        "gpvae_tpu_torch.configs, gpvae_tpu_torch.convert, "
        "gpvae_tpu_torch.models, gpvae_tpu_torch.train, "
        "gpvae_tpu_torch.data; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'gpvae_tpu')]; "
        "assert not bad, bad"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_cli_trains_syn_data_on_the_cpu():
    proc = _run(["-m", "gpvae_tpu_torch", "train", "--preset", "syn_data",
                 "--steps", "5", "--device", "cpu", "--num-seqs", "64"])
    assert proc.returncode == 0, proc.stderr
    assert "done at step 5" in proc.stdout
    listing = _run(["-m", "gpvae_tpu_torch", "list-presets"])
    assert listing.returncode == 0 and "syn_data_vm" in listing.stdout
