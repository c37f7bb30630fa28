"""Named experiment presets of the port.

Counterpart of ``gpvae_tpu/configs.py:17-151`` and ``:215-227``: the
``Preset`` record, the reference model zoo on Moving-MNIST frames
(``vanilla_vae``, ``gp_prior_diag``, ``full_gp_fixed``,
``full_gp_dynamic``, ``mnist_from_syndata``, ``gp_recog``), the toy
presets ``syn_data`` and ``syn_data_vm``, and the BASELINE configs
``bench_t100``, which runs the large-T covariance path (T=100; the CLI's
``--time-len`` takes it to T=1024), ``healing_mnist`` (missing pixels,
the Cauchy kernel, short sequences), ``sparse_t4096`` (T=4096 under the
FITC prior) and ``t1024_toeplitz`` (T=1024 under the Toeplitz structured
prior, on fully observed sequences of one uniform grid), and
``dp_scale`` (``:204-213``: ``t1024_toeplitz``'s model at a global batch
of 4096 under data parallelism, ``parallel.fit_data_parallel``).
"""
from __future__ import annotations

import dataclasses

from gpvae_tpu_torch import elbo as elbo_lib
from gpvae_tpu_torch.models import GPVAEConfig
from gpvae_tpu_torch.train import TrainConfig


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    model: GPVAEConfig
    train: TrainConfig
    batch_size: int
    description: str = ""
    # which data pipeline the CLI builds: "toy" (masked GP draws),
    # "toy_full" (the same, every step observed), "mnist" (video frames),
    # or "healing" (missing-pixel regime with per-feature masks); None
    # infers it from the encoder type
    data_family: str | None = None

    @property
    def resolved_data_family(self) -> str:
        if self.data_family is not None:
            return self.data_family
        return "mnist" if self.model.encoder == "conv" else "toy"


# Reference toy β schedules, src/Models/syndata/GP_VAE_syn_data.py:344,361-364
# and GP_VAE_syn_data_VM.py:346-347
_TOY_BETA = elbo_lib.BetaSchedule(init=1e-3, rate=1e-7, start_step=20_000)
_TOY_BETA_VM = elbo_lib.BetaSchedule(init=1e-4, rate=1e-6, start_step=20_000)

_MNIST_CONV = dict(
    obs_dim=64 * 64, time_len=20, encoder="conv", decoder="conv",
    image_shape=(64, 64, 1), latent_dim=100,
)
# fixed 0..19 grid -> factor each latent's gram once per step and share it
# across the batch (the reference tiles one gram, Full_GP_VAE_fixed:99)
_MNIST_CONV_FIXED = dict(_MNIST_CONV, shared_time_grid=True)
# Reference MNIST batch = 5 sequences (= 100 frames),
# src/Models/Full_GP_VAE_dynamic_time.py:311-318
_MNIST_TRAIN = TrainConfig(
    learning_rate=2e-4, num_steps=5_000_000,
    beta=elbo_lib.CONSTANT_BETA, checkpoint_every=25_000,
)

PRESETS: dict[str, Preset] = {}


def register(preset: Preset) -> Preset:
    PRESETS[preset.name] = preset
    return preset


# --- the reference model zoo ------------------------------------------------

register(Preset(
    "vanilla_vae",
    GPVAEConfig(prior="standard", posterior="diag", **_MNIST_CONV),
    _MNIST_TRAIN, batch_size=5,
    description="Baseline conv VAE (src/Models/Vanilla_VAE.py)",
))
register(Preset(
    "gp_prior_diag",
    GPVAEConfig(
        prior="gp", posterior="diag",
        prior_lengthscales=(1.0,), learn_prior_lengthscales=False,
        **_MNIST_CONV_FIXED,
    ),
    _MNIST_TRAIN, batch_size=5,
    description="GP prior + diagonal posterior "
    "(src/Models/VAE_GPprior_diag_cov.py)",
))
register(Preset(
    "full_gp_fixed",
    GPVAEConfig(
        prior="gp", posterior="gp",
        prior_lengthscales=(1.0,), learn_prior_lengthscales=True,
        posterior_lengthscales=(1.0,), learn_posterior_lengthscales=True,
        **_MNIST_CONV_FIXED,
    ),
    _MNIST_TRAIN, batch_size=5,
    description="Full GP prior+posterior, fixed times 1..20 "
    "(src/Models/Full_GP_VAE_fixed_for_MovMnist.py; learnable prior l :96)",
))
register(Preset(
    "full_gp_dynamic",
    GPVAEConfig(
        prior="gp", posterior="gp",
        prior_lengthscales=(1.0,), learn_prior_lengthscales=False,
        posterior_lengthscales=(1.0,), learn_posterior_lengthscales=True,
        **_MNIST_CONV,
    ),
    _MNIST_TRAIN, batch_size=5,
    description="Full GP, irregular per-sequence times "
    "(src/Models/Full_GP_VAE_dynamic_time.py)",
))


register(Preset(
    "syn_data",
    GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=45,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), learn_prior_lengthscales=False,
        posterior_lengthscales=(9.0, 3.0), learn_posterior_lengthscales=True,
        encoder="dense", decoder="dense", num_samples=1,
    ),
    TrainConfig(num_steps=3_000_000, beta=_TOY_BETA),
    batch_size=20,
    description="Dense GP-VAE on toy GP draws "
    "(src/Models/syndata/GP_VAE_syn_data.py)",
))
register(Preset(
    "syn_data_vm",
    dataclasses.replace(PRESETS["syn_data"].model),
    TrainConfig(num_steps=3_000_000, beta=_TOY_BETA_VM),
    batch_size=20,
    description="VM hyperparameter variant "
    "(src/Models/syndata/GP_VAE_syn_data_VM.py; differs only in the beta "
    "schedule)",
))

register(Preset(
    "mnist_from_syndata",
    dataclasses.replace(PRESETS["full_gp_dynamic"].model),
    TrainConfig(
        num_steps=5_000_000,
        beta=elbo_lib.BetaSchedule(init=1e-3, rate=5e-6, start_step=20_000),
    ),
    batch_size=5,
    description="Dynamic-time machinery + conv nets on MovingMNIST "
    "(src/Models/syndata/GP_VAE_mnist_from_syndata.py)",
))
register(Preset(
    "gp_recog",
    GPVAEConfig(
        prior="standard", posterior="gp_plus_diag",
        posterior_lengthscales=(1.0,), learn_posterior_lengthscales=True,
        **_MNIST_CONV,
    ),
    _MNIST_TRAIN, batch_size=5,
    description="GP recognition + N(0,1) prior "
    "(src/Models/GP_recog_VAE_prior.py); set reference_recog_kl=True on "
    "the model config for behavioral parity with the reference's "
    "mismatched standard KL",
))

# --- BASELINE.json benchmark configs ----------------------------------------

register(Preset(
    "bench_t100",
    GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=100,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0),
        posterior_lengthscales=(9.0, 3.0),
        encoder="dense", decoder="dense",
    ),
    TrainConfig(num_steps=1000, beta=_TOY_BETA),
    batch_size=32,
    description="BASELINE config 1: synthetic T=100 RBF, batch 32",
))
register(Preset(
    "healing_mnist",
    GPVAEConfig(
        latent_dim=64, obs_dim=28 * 28, time_len=10,
        prior="gp", posterior="gp", kernel="cauchy",
        prior_lengthscales=(2.0,), learn_prior_lengthscales=False,
        posterior_lengthscales=(2.0,), learn_posterior_lengthscales=True,
        encoder="conv", decoder="conv", image_shape=(28, 28, 1),
        shared_time_grid=True,
    ),
    TrainConfig(num_steps=100_000, beta=elbo_lib.BetaSchedule(
        init=1e-3, rate=1e-6, start_step=10_000)),
    batch_size=64,
    description="BASELINE config 2: healing-MNIST-style missing-pixel "
    "imputation, Cauchy kernel, short sequences (the GP-VAE paper's "
    "benchmark; the reference repo itself has no healing-MNIST script)",
    data_family="healing",
))
register(Preset(
    "sparse_t4096",
    GPVAEConfig(
        latent_dim=8, obs_dim=15, time_len=4096,
        prior="sparse_gp", posterior="diag",
        prior_lengthscales=(256.0,), learn_prior_lengthscales=False,
        num_inducing=64, inducing_time_range=(0.0, 4096.0),
        encoder="dense", decoder="dense",
    ),
    TrainConfig(num_steps=100_000, beta=_TOY_BETA),
    batch_size=8,
    description="BASELINE config 4: T=4096 sequences under an m=64 "
    "inducing-point (FITC) GP prior — O(T m^2) KL",
))


register(Preset(
    "t1024_toeplitz",
    GPVAEConfig(
        latent_dim=2, obs_dim=15, time_len=1024,
        prior="gp", posterior="gp",
        prior_lengthscales=(9.0, 3.0), learn_prior_lengthscales=False,
        posterior_lengthscales=(9.0, 3.0), learn_posterior_lengthscales=True,
        encoder="dense", decoder="dense",
        shared_time_grid=True, structured_prior="toeplitz",
    ),
    TrainConfig(num_steps=100_000, beta=_TOY_BETA),
    batch_size=8,
    description="BASELINE config 3: T=1024 uniform grid — Toeplitz "
    "structured prior (O(T^2) Durbin + Gohberg-Semencul inverse, "
    "gp.gp_kl_toeplitz_prior) with the blocked-Cholesky posterior bank",
    data_family="toy_full",
))
register(Preset(
    "dp_scale",
    dataclasses.replace(PRESETS["t1024_toeplitz"].model),
    TrainConfig(num_steps=100_000, beta=_TOY_BETA),
    batch_size=4096,
    description="BASELINE config 5: 4096 sequences x T=1024 under data "
    "parallelism — the global batch shards over a device mesh "
    "(parallel.make_parallel_train_step / __graft_entry__.dryrun_multichip);"
    " shrink --num-seqs and the batch for single-chip smoke runs",
    data_family="toy_full",
))


def get(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
