"""The port's conv nets, Moving-MNIST data, zoo presets and CLI against the
JAX package, on the CPU.

* ``ConvEncoder`` (with its log-variance head) and ``ConvDecoder`` against
  flax, the weights carried by ``convert.load_flax_params``, in float64 to
  1e-10: at 64 x 64 with the full channel schedule (a 1 x 1 seed, six
  doublings, the stride-2 logits head), and at 28 x 28 (a 7 x 7 seed, the
  stride-1 logits head, odd sides under the encoder's asymmetric padding
  and the NHWC order of the seed);
* ``GPVAE.forward`` for every ported pair on the conv nets (8 x 8 frames),
  with and without a shared grid (``test_torch_zoo.check_elbo_matches_jax``);
* both likelihoods with a ``feature_mask`` on ``[B, T, H, W, C]`` frames;
* the zoo presets field for field, ``MovingMNIST`` and its batches, the
  reference's ``vanilla_vae`` evaluate error, a GP-less model's
  checkpoint and ``reconstruct`` without times, and ``train`` then
  ``evaluate`` of a conv preset through ``__main__.main``.
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
from gpvae_tpu import elbo as jelbo
from gpvae_tpu import nets as jnets
from gpvae_tpu.data import moving_mnist as jmm
from gpvae_tpu_torch import analysis, configs, convert, elbo, nets
from gpvae_tpu_torch.__main__ import main
from gpvae_tpu_torch.data import MovingMNIST, synthetic_moving_mnist
from gpvae_tpu_torch.models import GPVAE

from test_torch_zoo import check_elbo_matches_jax, zoo_cases

FP64_REL = 1e-10
ZOO = ("vanilla_vae", "gp_prior_diag", "full_gp_fixed", "full_gp_dynamic",
       "mnist_from_syndata", "gp_recog")


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _flax_params(module, x, seed):
    """float64 N(0, 0.1) kernels and 0.1 biases in ``module``'s parameter
    tree (``jax.eval_shape``: the initializer is not compiled)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), x)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (np.full(s.shape, 0.1) if "bias" in jax.tree_util.keystr(p)
                      else 0.1 * rng.standard_normal(s.shape)), shapes)


class _Nets(torch.nn.Module):
    def __init__(self, encoder_net, decoder_net):
        super().__init__()
        self.encoder_net, self.decoder_net = encoder_net, decoder_net


@pytest.mark.parametrize("size", [64, 28])
def test_conv_nets_match_flax_fp64(size):
    rng = np.random.default_rng(size)
    shape = (size, size, 1)
    x = rng.random((3,) + shape)
    z = rng.standard_normal((3, 4))
    jenc = jnets.ConvEncoder(4, with_log_var=True)
    jdec = jnets.ConvDecoder(shape)
    p_enc = _flax_params(jenc, jnp.asarray(x), 0)
    p_dec = _flax_params(jdec, jnp.asarray(z), 1)

    @jax.jit
    def ref(pe, pd, x, z):
        return (jenc.apply({"params": pe}, x),
                jdec.apply({"params": pd}, z))

    (mean, log_var), logits = ref(p_enc, p_dec, jnp.asarray(x),
                                  jnp.asarray(z))
    port = _Nets(nets.ConvEncoder(shape, 4, with_log_var=True),
                 nets.ConvDecoder(shape, 4)).double()
    convert.load_flax_params(port, {"encoder_net": p_enc,
                                    "decoder_net": p_dec})
    got_mean, got_log_var = port.encoder_net(torch.tensor(x))
    got_logits = port.decoder_net(torch.tensor(z))
    assert got_logits.shape == logits.shape == (3,) + shape
    assert _rel(got_mean.detach().numpy(), mean) <= FP64_REL
    assert _rel(got_log_var.detach().numpy(), log_var) <= FP64_REL
    assert _rel(got_logits.detach().numpy(), logits) <= FP64_REL
    # the ConvTranspose kernels are stored flipped, [in, out, kh, kw]
    k = np.asarray(p_dec["ConvTranspose_0"]["kernel"])
    np.testing.assert_array_equal(
        port.decoder_net.deconv[0].weight.detach().numpy(),
        k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


@pytest.mark.parametrize("pair,net,shared", zoo_cases("conv")[0],
                         ids=zoo_cases("conv")[1])
def test_conv_elbo_and_grads_match_jax_fp64(pair, net, shared, monkeypatch):
    check_elbo_matches_jax(pair, net, shared, monkeypatch)


@pytest.mark.parametrize("likelihood", ["bernoulli", "gaussian"])
def test_nll_on_image_frames_matches_jax_fp64(likelihood):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 3, 4, 6, 6, 1))
    x = (rng.random((3, 4, 6, 6, 1)) < 0.5).astype(np.float64)
    mask = rng.random((3, 4)) > 0.3
    fmask = rng.random((3, 4, 6, 6, 1)) > 0.2
    fn = f"{likelihood}_nll"
    ref = getattr(jelbo, fn)(*(jnp.asarray(a) for a in (logits, x, mask,
                                                          fmask)))
    got = getattr(elbo, fn)(*(torch.tensor(a) for a in (logits, x, mask,
                                                         fmask)))
    assert got.shape == (3,)
    assert _rel(got.numpy(), ref) <= FP64_REL


def test_zoo_presets_match_jax():
    for name in ZOO:
        ours, ref = configs.get(name), jconfigs.get(name)
        assert dataclasses.asdict(ours.model) == dataclasses.asdict(
            ref.model), name
        assert dataclasses.asdict(ours.train) == dataclasses.asdict(
            ref.train), name
        assert (ours.batch_size, ours.description, ours.data_family) == (
            ref.batch_size, ref.description, ref.data_family), name
        assert ours.resolved_data_family == ref.resolved_data_family == "mnist"
        GPVAE(ours.model)  # every zoo preset builds


def test_moving_mnist_matches_jax(tmp_path):
    """The same videos, splits, binarization and batches as the JAX
    pipeline, from arrays and from a ``uint8`` ``.npy``."""
    vids = synthetic_moving_mnist(23, t=6, size=16, seed=3)
    np.testing.assert_array_equal(
        vids, jmm.synthetic_moving_mnist(23, t=6, size=16, seed=3))
    raw = (np.random.default_rng(0).random((6, 23, 16, 16)) * 255).astype(
        np.uint8)
    np.save(tmp_path / "mm.npy", raw)
    for kwargs in (dict(data=vids), dict(data=vids, binarize=False),
                   dict(path=str(tmp_path / "mm.npy")),
                   dict(path=str(tmp_path / "mm.npy"), binarize=False)):
        ours, ref = MovingMNIST(batch_size=3, **kwargs), jmm.MovingMNIST(
            batch_size=3, **kwargs)
        assert set(ours.splits) == set(ref.splits) == {"train", "valid",
                                                       "test"}
        for split in ref.splits:
            for key, v in ref.splits[split].items():
                np.testing.assert_array_equal(ours.splits[split][key], v)
        assert ours.splits["train"]["x"].shape == (18, 6, 16, 16, 1)
        assert set(ours.batchers) == set(ref.batchers)
        for _ in range(8):  # past a reshuffle of the 18 train sequences
            got, want = ours.data_batch("train"), ref.data_batch("train")
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    binary = MovingMNIST(data=vids, batch_size=3).splits["test"]["x"]
    assert set(np.unique(binary)) <= {0.0, 1.0}
    for ds in (ours, ref):
        ds.make_shuffled_dataset(seed=1)
        ds.make_cropped_dataset(2, 3, 8)
    for split in ("mixed_train", "cropped_train"):
        for key, v in ref.splits[split].items():
            np.testing.assert_array_equal(ours.splits[split][key], v)


def test_vanilla_vae_analysis_raises_the_reference_error():
    """The JAX package's analysis reads a posterior GP's lengthscales from
    the config of a model that has none (``analysis.py:346-353``), and
    ``vanilla_vae``'s (9, 3) do not fit Z=100: the port raises the same
    error."""
    cfg = configs.get("vanilla_vae").model
    with pytest.raises(ValueError) as ref:
        janalysis._param_or_const(None, {}, "posterior_log_ls", cfg)
    with pytest.raises(ValueError) as ours:
        analysis._param_or_const(GPVAE(cfg), "posterior_log_ls")
    assert str(ours.value) == str(ref.value) == (
        "lengthscales (9.0, 3.0) incompatible with Z=100")


def test_cli_trains_and_evaluates_a_conv_preset(tmp_path, capsys):
    """``full_gp_dynamic`` at its widths (64 x 64 frames, Z=100, T=20,
    B=5) on the CPU: two steps, a checkpoint, then evaluate on it with
    plots; ``vanilla_vae``'s evaluate raises the reference's error."""
    common = ["--device", "cpu", "--num-seqs", "24", "--seed", "0"]
    main(["train", "--preset", "full_gp_dynamic", *common, "--steps", "2",
          "--ckpt-dir", str(tmp_path / "ck")])
    assert "done at step 2" in capsys.readouterr().out
    main(["evaluate", "--preset", "full_gp_dynamic", *common, "--ckpt-dir",
          str(tmp_path / "ck"), "--plots", str(tmp_path / "plots"),
          "--traversal", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 2"
    metrics = json.loads(lines[1])
    assert metrics["dropped_steps"] > 0
    assert all(np.isfinite(metrics[k]) for k in (
        "nll_gp_impute", "mse_gp_impute", "nll_baseline", "mse_baseline"))
    assert sorted(p.name for p in (tmp_path / "plots").iterdir()) == [
        "imputation.png", "latents.png", "traversal.png", "traversal_gp.png"]
    with pytest.raises(ValueError, match="incompatible with Z=100"):
        main(["evaluate", "--preset", "vanilla_vae", *common])


def test_model_without_a_gp_checkpoints_and_reconstructs(tmp_path):
    """A model with no log-lengthscales (``vanilla_vae`` on 8 x 8 frames)
    saves and restores its checkpoint, and ``reconstruct`` takes no
    times: its draw is ``sample_posterior``'s on the grid ``0 .. T-1``
    with the same ``[S, B, T, Z]`` noise."""
    from gpvae_tpu_torch import train

    cfg = dataclasses.replace(configs.get("vanilla_vae").model, latent_dim=3,
                              obs_dim=64, image_shape=(8, 8, 1), time_len=4)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    assert not any(n.endswith("_log_ls") for n, _ in model.named_parameters())
    state = train.create_train_state(model, train.TrainConfig(), "cpu")
    x = torch.rand((2, 4, 8, 8, 1), generator=torch.Generator().manual_seed(1))
    batch = {"x": x, "times": torch.arange(4.0).expand(2, 4),
             "mask": torch.ones(2, 4, dtype=torch.bool)}
    train.train_step(state, batch, 1.0)
    train.CheckpointManager(str(tmp_path)).save(state)
    fresh = train.create_train_state(
        GPVAE(cfg, generator=torch.Generator().manual_seed(5)),
        train.TrainConfig(), "cpu")
    assert train.CheckpointManager(str(tmp_path)).restore_latest(
        fresh).step == 1
    for a, b in zip(model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    eps = torch.randn(fresh.model.noise_shape(2, 2, 4))
    assert eps.shape == (2, 2, 4, 3)
    probs, z = analysis.reconstruct(fresh.model, x, num_samples=2, eps=eps)
    with torch.no_grad():
        want, *_ = fresh.model.sample_posterior(
            x, batch["times"], None, 2, eps=eps)
    assert probs.shape == (2, 2, 4, 8, 8, 1)
    assert torch.equal(z, want)
