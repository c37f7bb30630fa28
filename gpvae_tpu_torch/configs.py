"""Named experiment presets of the port.

Counterpart of ``gpvae_tpu/configs.py:17-64`` and ``:108-128``: the
``Preset`` record and the two presets of the main path, ``syn_data`` and
``syn_data_vm``.  The other presets arrive with their slices (ROADMAP).
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
    # which data pipeline the CLI builds; the port has "toy" only
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

PRESETS: dict[str, Preset] = {}


def register(preset: Preset) -> Preset:
    PRESETS[preset.name] = preset
    return preset


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


def get(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
