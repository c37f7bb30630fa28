"""The GP-VAE as a PyTorch module.

Counterpart of ``gpvae_tpu/models.py:49-172`` and ``:251-511``, with
``sample_posterior`` (:396-418) for the GP posterior.
``GPVAEConfig`` keeps the JAX package's field names and validation, so a
preset reads the same in both packages.  ``GPVAE`` ports the main path:
a GP posterior with learnable lengthscales against a GP prior, dense
nets, irregular masked time grids.  The other combinations of the zoo
raise ``NotImplementedError`` naming their ROADMAP slice.

One step of the main path: factor ONE stacked 2Z-wide gram bank
(posterior and prior lengthscales side by side) with the fused
``gram_chol`` kernel (T <= 64) or the blocked large-T factorization, and
take every factor's logdet in the same autograd node, encode the means,
draw ``z = mu + L_q eps``, take the KL from one ``tri_inv`` of ``L_p``,
decode and take the Bernoulli NLL.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from gpvae_tpu_torch import elbo as elbo_lib
from gpvae_tpu_torch import gp, nets
from gpvae_tpu_torch.ops.logdet import logdet_from_chol

PRIORS = ("standard", "gp", "sparse_gp")
POSTERIORS = ("diag", "gp", "gp_plus_diag")
NETS = ("dense", "conv")


@dataclasses.dataclass(frozen=True)
class GPVAEConfig:
    """Field for field the JAX package's ``GPVAEConfig``; see there for
    what each field means."""
    latent_dim: int = 2
    obs_dim: int = 15
    time_len: int = 45
    prior: str = "gp"
    posterior: str = "gp"
    encoder: str = "dense"
    decoder: str = "dense"
    image_shape: tuple[int, int, int] = (64, 64, 1)
    kernel: str = "rbf"
    noise: float = 1e-3
    likelihood: str = "bernoulli"
    prior_lengthscales: tuple[float, ...] = (9.0, 3.0)
    posterior_lengthscales: tuple[float, ...] = (9.0, 3.0)
    learn_prior_lengthscales: bool = False
    learn_posterior_lengthscales: bool = True
    num_samples: int = 1
    reference_recog_kl: bool = False
    shared_time_grid: bool = False
    structured_prior: str = "auto"
    num_inducing: int = 64
    inducing_time_range: tuple[float, float] | None = None
    # "auto" and "fused" both take the port's fused route (the kernels on
    # CUDA); "xla" the composed baseline, gp.chol_gram_bank(impl="xla")
    cov_impl: str = "auto"
    # a float32 matmul is full float32 here unless TF32 is switched on, so
    # both settings compute the same
    dense_precision: str = "highest"

    def __post_init__(self):
        if self.prior not in PRIORS:
            raise ValueError(f"prior must be one of {PRIORS}")
        if self.posterior not in POSTERIORS:
            raise ValueError(f"posterior must be one of {POSTERIORS}")
        if self.encoder not in NETS or self.decoder not in NETS:
            raise ValueError(f"nets must be one of {NETS}")
        if self.likelihood not in ("bernoulli", "gaussian"):
            raise ValueError("likelihood must be bernoulli or gaussian")
        if self.posterior == "gp_plus_diag" and self.prior != "standard":
            raise ValueError(
                "gp_plus_diag posterior pairs with the standard prior "
                "(reference GP_recog_VAE_prior.py)"
            )
        if self.prior == "sparse_gp":
            if self.posterior != "diag":
                raise ValueError(
                    "sparse_gp prior requires a diagonal posterior (the "
                    "full-GP posterior is itself O(T^3))"
                )
            if self.inducing_time_range is None:
                raise ValueError(
                    "sparse_gp prior needs inducing_time_range=(t0, t1)"
                )
        if self.structured_prior not in ("auto", "dense", "toeplitz"):
            raise ValueError(
                "structured_prior must be auto, dense, or toeplitz"
            )
        if self.cov_impl not in ("auto", "fused", "xla"):
            raise ValueError("cov_impl must be auto, fused, or xla")
        if self.dense_precision not in ("highest", "default"):
            raise ValueError("dense_precision must be highest or default")
        if self.structured_prior == "toeplitz" and not self.shared_time_grid:
            raise ValueError(
                "the toeplitz structured prior requires shared_time_grid "
                "(one uniform grid for the whole batch)"
            )

    def _ls_tuple(self, raw: tuple[float, ...]) -> tuple[float, ...]:
        if len(raw) == 1:
            return raw * self.latent_dim
        if len(raw) != self.latent_dim:
            raise ValueError(
                f"lengthscales {raw} incompatible with Z={self.latent_dim}"
            )
        return raw

    @property
    def needs_log_var(self) -> bool:
        return self.posterior in ("diag", "gp_plus_diag")

    @property
    def needs_times(self) -> bool:
        return (
            self.prior in ("gp", "sparse_gp")
            or self.posterior in ("gp", "gp_plus_diag")
        )

    @property
    def toeplitz_prior(self) -> bool:
        return (self.prior == "gp" and self.shared_time_grid
                and self.structured_prior == "toeplitz")


def check_ported(config: GPVAEConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration outside the
    port's first slice, naming the ROADMAP slice that brings it."""
    if config.prior == "sparse_gp":
        raise NotImplementedError("sparse_gp (FITC) prior: ROADMAP slice 5")
    if config.structured_prior == "toeplitz":
        raise NotImplementedError(
            "toeplitz structured prior: ROADMAP slice 5"
        )
    if config.prior != "gp" or config.posterior != "gp":
        raise NotImplementedError(
            f"prior={config.prior!r} posterior={config.posterior!r}: "
            "ROADMAP slice 4 (the port has gp/gp)"
        )
    if config.encoder != "dense" or config.decoder != "dense":
        raise NotImplementedError("conv nets: ROADMAP slice 4")
    if config.likelihood != "bernoulli":
        raise NotImplementedError("gaussian likelihood: ROADMAP slice 4")
    if config.shared_time_grid:
        raise NotImplementedError("shared_time_grid: ROADMAP slice 4")


@dataclasses.dataclass
class ELBOOutput:
    loss: torch.Tensor           # scalar: mean over batch of (nll + beta*kl)
    nll: torch.Tensor            # [B]
    kl: torch.Tensor             # [B]
    beta: float
    latent_mean: torch.Tensor    # [B, T, Z]
    latent_sample: torch.Tensor  # [S, B, T, Z]
    logits: torch.Tensor         # [S, B, T, obs_dim]
    aux: dict[str, Any]


class GPVAE(nn.Module):
    """GP-VAE with a GP posterior (learnable log-lengthscales) against a
    GP prior and dense nets.

    Parameters: ``encoder_net``, ``decoder_net`` and ``posterior_log_ls``
    (a buffer when ``learn_posterior_lengthscales`` is False);
    ``prior_log_ls`` is a buffer unless ``learn_prior_lengthscales``.
    Weights are drawn from ``generator`` (float32, on the CPU; move the
    module with ``.to(device)``).
    """

    def __init__(self, config: GPVAEConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_ported(config)
        self.config = c = config
        self.encoder_net = nets.DenseEncoder(c.obs_dim, c.latent_dim,
                                             generator=generator)
        self.decoder_net = nets.DenseDecoder(c.latent_dim, c.obs_dim,
                                             generator=generator)
        self._log_ls("posterior_log_ls", c.posterior_lengthscales,
                     c.learn_posterior_lengthscales)
        self._log_ls("prior_log_ls", c.prior_lengthscales,
                     c.learn_prior_lengthscales)

    def _log_ls(self, name: str, raw, learn: bool) -> None:
        init = torch.tensor([math.log(v) for v in self.config._ls_tuple(raw)],
                            dtype=torch.float32)
        if learn:
            self.register_parameter(name, nn.Parameter(init))
        else:
            self.register_buffer(name, init)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, obs_dim]`` -> means ``[B, T, Z]``."""
        b, t = x.shape[:2]
        return self.encoder_net(x.reshape(b * t, -1)).reshape(b, t, -1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[..., Z]`` -> logits ``[..., obs_dim]``."""
        lead = z.shape[:-1]
        logits = self.decoder_net(z.reshape(-1, z.shape[-1]))
        return logits.reshape(*lead, logits.shape[-1])

    def chol_banks(self, times: torch.Tensor, mask: torch.Tensor | None,
                   *, logdets: bool = False) -> dict[str, torch.Tensor]:
        """``{"l_q", "l_p"}`` from ONE factorization of the stacked
        2Z-wide bank (``models.py:350-394``).  ``logdets=True`` (the
        ELBO) adds ``{"ld_q", "ld_p"}``, ``logdet K [B, Z]`` of each
        factor: on the fused routes from the factorization's own autograd
        node (one ``diag_logdet`` over the whole bank, its gradient folded
        into the Cholesky backward); with ``cov_impl="xla"`` from
        ``logdet_from_chol`` of each half, on plain autograd."""
        c = self.config
        z = c.latent_dim
        ls = torch.cat([torch.exp(self.posterior_log_ls),
                        torch.exp(self.prior_log_ls)]).to(times.dtype)
        bank = dict(mask=mask, kernel=c.kernel, noise=c.noise)
        if logdets and c.cov_impl != "xla":
            l_all, ld = gp._chol_gram_bank_logdet(times, ls, **bank)
            return {"l_q": l_all[:, :z], "l_p": l_all[:, z:],
                    "ld_q": ld[:, :z], "ld_p": ld[:, z:]}
        l_all = gp.chol_gram_bank(times, ls, impl=c.cov_impl, **bank)
        out = {"l_q": l_all[:, :z], "l_p": l_all[:, z:]}
        if logdets:
            out["ld_q"] = logdet_from_chol(out["l_q"])
            out["ld_p"] = logdet_from_chol(out["l_p"])
        return out

    def sample_posterior(
        self,
        x: torch.Tensor,
        times: torch.Tensor,
        mask: torch.Tensor | None,
        num_samples: int,
        *,
        aux: dict[str, torch.Tensor] | None = None,
        eps: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ):
        """Encode and draw from the GP posterior (``models.py:396-418``):
        ``(z [S, B, T, Z], mean [B, T, Z], log_var, aux)``, with ``log_var``
        None (the GP posterior has none) and ``aux`` the factors of
        :meth:`chol_banks` unless given.  The noise is ``eps [S, B, Z, T]``
        when given, else drawn from ``generator`` on ``x``'s device."""
        mean = self.encode(x)
        if mask is not None:
            mean = mean * mask.to(mean.dtype)[..., None]
        if aux is None:
            aux = self.chol_banks(times, mask)
        z = gp.gp_sample(mean, aux["l_q"], num_samples, mask, eps=eps,
                         generator=generator)
        return z, mean, None, aux

    def forward(
        self,
        x: torch.Tensor,
        times: torch.Tensor,
        mask: torch.Tensor | None = None,
        *,
        beta: float = 1.0,
        num_samples: int | None = None,
        eps: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> ELBOOutput:
        """The ELBO of a batch.  ``x [B, T, obs_dim]``, ``times [B, T]``,
        ``mask [B, T]`` bool.  The posterior noise is ``eps [S, B, Z, T]``
        when given, else drawn from ``generator`` on ``x``'s device."""
        c = self.config
        s = num_samples if num_samples is not None else c.num_samples
        aux = self.chol_banks(times, mask, logdets=True)
        z, mean, _, aux = self.sample_posterior(x, times, mask, s, aux=aux,
                                                eps=eps, generator=generator)
        kl_b = torch.sum(gp.gp_kl(mean, aux["l_q"], aux["l_p"], mask,
                                  logdet_q=aux["ld_q"],
                                  logdet_p=aux["ld_p"]), dim=-1)
        logits = self.decode(z)
        nll_b = elbo_lib.bernoulli_nll(logits, x, mask)
        loss = torch.mean(nll_b + beta * kl_b)
        return ELBOOutput(loss=loss, nll=nll_b, kl=kl_b, beta=beta,
                          latent_mean=mean, latent_sample=z, logits=logits,
                          aux=aux)
