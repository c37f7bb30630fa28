"""The GP-VAE as a PyTorch module.

Counterpart of ``gpvae_tpu/models.py:49-511``.  ``GPVAEConfig`` keeps the
JAX package's field names and validation, so a preset reads the same in
both packages.  ``GPVAE`` covers the zoo's capability matrix:

| prior    | posterior     | KL                                    |
|----------|---------------|---------------------------------------|
| gp       | gp            | ``gp.gp_kl``                          |
| gp       | diag          | ``gp.gp_prior_diag_kl``               |
| standard | diag          | ``gp.standard_kl``                    |
| standard | gp_plus_diag  | ``gp.recog_gp_kl`` (``standard_kl``   |
|          |               | with ``reference_recog_kl``)          |
| standard | gp            | ``gp.gp_kl`` against an identity      |
| sparse_gp| diag          | ``sparse.fitc_diag_kl`` (FITC)        |
| gp, Toeplitz | gp        | ``gp.gp_kl_toeplitz_prior``           |
| gp, Toeplitz | diag      | ``gp.gp_prior_diag_kl_toeplitz``      |

on dense or conv nets, Bernoulli or Gaussian likelihoods, irregular
masked time grids or one grid shared by the batch (``shared_time_grid``),
with ``feature_mask``.  The Toeplitz structured prior (a uniform shared
grid, ``structured_prior="toeplitz"``) takes the prior's first rows in
place of its factors; with ``learn_prior_lengthscales`` its gradient runs
through the Durbin recursion's reverse (``csrc/durbin.cu`` on the card).

One step: factor the gram banks the pair needs in ONE call (the
posterior's and the prior's lengthscales side by side in one stacked
2Z-wide bank when both are GPs) with the fused ``gram_chol`` kernel
(T <= 64) or the blocked large-T factorization, each factor's logdet
from the same autograd node; encode; draw ``z``; take the KL (the GP
priors' from one ``tri_inv`` of ``L_p``, the Toeplitz prior's from one
Durbin recursion of its first rows, ``csrc/durbin.cu``); decode and take
the NLL.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from gpvae_tpu_torch import elbo as elbo_lib
from gpvae_tpu_torch import gp, nets, sparse
from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops.logdet import logdet_from_chol
from gpvae_tpu_torch.utils.profiling import span

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


def check_structured_grid(config: GPVAEConfig, times, mask=None) -> None:
    """Host-side validation of the grid a Toeplitz structured prior
    assumes (``models.py:174-213``): ``times [B, T]`` at T =
    ``config.time_len``, an arithmetic first row, a full mask.  Nothing to
    check for any other prior."""
    if not config.toeplitz_prior:
        return
    t_arr = np.asarray(times)
    if t_arr.ndim != 2:
        raise ValueError(f"times must be [B, T], got {t_arr.shape}")
    t = t_arr.shape[1]
    if t != config.time_len:
        raise ValueError(
            f"structured_prior='toeplitz': batch T={t} != config.time_len="
            f"{config.time_len}; the prior row is built at time_len"
        )
    steps = np.diff(t_arr[0].astype(np.float64))
    if steps.size and not np.allclose(steps, steps[0], rtol=1e-4, atol=1e-6):
        raise ValueError(
            "structured_prior='toeplitz' requires an arithmetic (uniform) "
            f"time grid; got steps in [{steps.min():.6g}, {steps.max():.6g}]"
        )
    if mask is not None and not np.all(np.asarray(mask)):
        raise ValueError(
            "structured_prior='toeplitz' requires a full mask (shared "
            "uniform grid, no missing steps)"
        )


def resolve_structured_prior(config: GPVAEConfig, times,
                             mask=None) -> GPVAEConfig:
    """``structured_prior="auto"`` resolved against the first real batch
    (``models.py:216-248``): ``"dense"``, the JAX package's measured
    winner at every size; an explicit setting is validated by
    :func:`check_structured_grid` and returned unchanged.  ``train.fit``
    calls it with its first batch."""
    if config.structured_prior != "auto":
        check_structured_grid(config, times, mask)
        return config
    return dataclasses.replace(config, structured_prior="dense")


@dataclasses.dataclass
class ELBOOutput:
    loss: torch.Tensor           # scalar: mean over batch of (nll + beta*kl)
    nll: torch.Tensor            # [B]
    kl: torch.Tensor             # [B]
    beta: float
    latent_mean: torch.Tensor    # [B, T, Z]
    latent_sample: torch.Tensor  # [S, B, T, Z]
    logits: torch.Tensor         # [S, B, T, obs_dim] or [S, B, T, H, W, C]
    aux: dict[str, Any]


class GPVAE(nn.Module):
    """Configurable GP-VAE; see the module docstring for the capability
    matrix.

    Parameters: ``encoder_net`` and ``decoder_net`` (dense or conv, with
    a log-variance head for the diagonal and recognition posteriors), and
    the log-lengthscales of each GP side, ``posterior_log_ls`` (GP and
    recognition posteriors) and ``prior_log_ls`` (GP and FITC priors),
    each a buffer where the config does not learn it.  Weights are drawn from
    ``generator`` (float32, on the CPU; move the module with
    ``.to(device)``).
    """

    def __init__(self, config: GPVAEConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = c = config
        if c.encoder == "dense":
            self.encoder_net = nets.DenseEncoder(
                c.obs_dim, c.latent_dim, with_log_var=c.needs_log_var,
                generator=generator)
        else:
            self.encoder_net = nets.ConvEncoder(
                c.image_shape, c.latent_dim, with_log_var=c.needs_log_var,
                generator=generator)
        if c.decoder == "dense":
            self.decoder_net = nets.DenseDecoder(c.latent_dim, c.obs_dim,
                                                 generator=generator)
        else:
            self.decoder_net = nets.ConvDecoder(c.image_shape, c.latent_dim,
                                                generator=generator)
        if self._gp_posterior:
            self._log_ls("posterior_log_ls", c.posterior_lengthscales,
                         c.learn_posterior_lengthscales)
        if c.prior in ("gp", "sparse_gp"):
            self._log_ls("prior_log_ls", c.prior_lengthscales,
                         c.learn_prior_lengthscales)

    @property
    def _gp_posterior(self) -> bool:
        return self.config.posterior in ("gp", "gp_plus_diag")

    @property
    def _gp_prior(self) -> bool:
        return self.config.prior == "gp"

    def _log_ls(self, name: str, raw, learn: bool) -> None:
        init = torch.tensor([math.log(v) for v in self.config._ls_tuple(raw)],
                            dtype=torch.float32)
        if learn:
            self.register_parameter(name, nn.Parameter(init))
        else:
            self.register_buffer(name, init)

    def inducing_times(self, *, dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None
                       ) -> torch.Tensor:
        """The FITC prior's ``num_inducing`` points spread over
        ``inducing_time_range`` (``models.py:345-348``)."""
        lo, hi = self.config.inducing_time_range
        return sparse.uniform_inducing_times(lo, hi, self.config.num_inducing,
                                             dtype=dtype, device=device)

    def noise_shape(self, num_samples: int, b: int, t: int) -> tuple:
        """The layout of the posterior sampler's noise ``eps``: ``[S, B,
        T, Z]`` for the diagonal posterior (``gp.diag_sample``), ``[S, B,
        Z, T]`` for the others."""
        z = self.config.latent_dim
        if self.config.posterior == "diag":
            return (num_samples, b, t, z)
        return (num_samples, b, z, t)

    def encode(self, x: torch.Tensor):
        """``[B, T, ...]`` -> means ``[B, T, Z]``, or ``(mean, log_var)``
        where the posterior needs a variance (``config.needs_log_var``)."""
        b, t = x.shape[:2]
        out = self.encoder_net(x.reshape(b * t, *x.shape[2:]))
        if self.config.needs_log_var:
            mean, log_var = out
            return mean.reshape(b, t, -1), log_var.reshape(b, t, -1)
        return out.reshape(b, t, -1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[..., Z]`` -> logits ``[..., obs_dim]`` (dense) or
        ``[..., H, W, C]`` (conv)."""
        lead = z.shape[:-1]
        logits = self.decoder_net(z.reshape(-1, z.shape[-1]))
        return logits.reshape(*lead, *logits.shape[1:])

    def _grid(self, times: torch.Tensor, mask: torch.Tensor | None):
        """With ``shared_time_grid``, the first row of ``times`` and no
        mask: one gram bank (leading dim 1) that the KLs and samplers
        share across the batch (``models.py:331-336``)."""
        if self.config.shared_time_grid:
            return times[:1], None
        return times, mask

    def chol_banks(self, times: torch.Tensor, mask: torch.Tensor | None,
                   *, logdets: bool = False) -> dict[str, torch.Tensor]:
        """Every Cholesky factor the configuration needs, from ONE
        factorization (``models.py:350-394``): ``"l_q"`` for a GP or
        recognition posterior, ``"l_p"`` for a GP prior, both from one
        stacked 2Z-wide bank when both sides are GPs.  ``[B, Z, T, T]``,
        or ``[1, Z, T, T]`` on a shared grid.  A FITC prior needs no bank:
        its KL factors the inducing grams itself.

        ``logdets=True`` (the ELBO) adds ``logdet K [B or 1, Z]`` of each
        factor a KL reads, ``"ld_q"`` of a GP posterior and ``"ld_p"`` of
        a GP prior: on the fused routes from the factorization's own
        autograd node (one ``diag_logdet`` over the whole bank, its
        gradient folded into the Cholesky backward); with
        ``cov_impl="xla"`` from ``logdet_from_chol``, on plain autograd.

        A Toeplitz prior is no factor but ``"prior_row"``, the first rows
        ``[Z, T]`` of its grams on the batch's uniform grid
        (``kernels.toeplitz_row`` at ``config.time_len``, in the dtype of
        ``times``): no ``[Z, T, T]`` prior gram is built."""
        c = self.config
        times, mask = self._grid(times, mask)
        out = {}
        if c.toeplitz_prior:
            out["prior_row"] = kernels_lib.toeplitz_row(
                c.time_len, times[0, 1] - times[0, 0],
                torch.exp(self.prior_log_ls), kernel=c.kernel,
                noise=c.noise, dtype=times.dtype)
        sides = []
        if self._gp_posterior:
            sides.append(("q", self.posterior_log_ls,
                          logdets and c.posterior == "gp"))
        if self._gp_prior and not c.toeplitz_prior:
            sides.append(("p", self.prior_log_ls, logdets))
        if not sides:
            return out
        ls = torch.cat([torch.exp(log_ls) for _, log_ls, _ in sides]
                       ).to(times.dtype)
        bank = dict(mask=mask, kernel=c.kernel, noise=c.noise)
        ld = None
        if any(with_ld for *_, with_ld in sides) and c.cov_impl != "xla":
            l_all, ld = gp._chol_gram_bank_logdet(times, ls, **bank)
        else:
            l_all = gp.chol_gram_bank(times, ls, impl=c.cov_impl, **bank)
        z = c.latent_dim
        for i, (side, _, with_ld) in enumerate(sides):
            out[f"l_{side}"] = l_all[:, i * z:(i + 1) * z]
            if with_ld:
                out[f"ld_{side}"] = (
                    ld[:, i * z:(i + 1) * z] if ld is not None
                    else logdet_from_chol(out[f"l_{side}"]))
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
        """Encode and draw from the posterior (``models.py:396-418``):
        ``(z [S, B, T, Z], mean [B, T, Z], log_var or None, aux)``, with
        ``aux`` the factors of :meth:`chol_banks` unless given.  The noise
        is ``eps`` in the layout of :meth:`noise_shape` when given, else
        drawn from ``generator`` on ``x``'s device."""
        c = self.config
        if c.needs_log_var:
            mean, log_var = self.encode(x)
        else:
            mean, log_var = self.encode(x), None
        if mask is not None:
            mean = mean * mask.to(mean.dtype)[..., None]
        if aux is None:
            aux = self.chol_banks(times, mask)
        noise = dict(eps=eps, generator=generator)
        if c.posterior == "diag":
            z = gp.diag_sample(mean, log_var, num_samples, mask, **noise)
        elif c.posterior == "gp":
            z = gp.gp_sample(mean, aux["l_q"], num_samples, mask, **noise)
        else:
            z = gp.recog_sample(mean, log_var, aux["l_q"], num_samples, mask,
                                **noise)
        return z, mean, log_var, aux

    def kl(self, mean: torch.Tensor, log_var: torch.Tensor | None,
           times: torch.Tensor, mask: torch.Tensor | None,
           aux: dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-sequence KL ``[B]`` of the configured pair
        (``models.py:420-468``), from the factors, logdets and Toeplitz
        rows in ``aux`` (:meth:`chol_banks`); the FITC prior's from
        ``times`` and the inducing grid."""
        c = self.config
        if c.prior == "sparse_gp":
            kl_bz = sparse.fitc_diag_kl(
                mean, log_var, times,
                self.inducing_times(dtype=times.dtype, device=times.device),
                torch.exp(self.prior_log_ls), mask=mask, kernel=c.kernel,
                noise=c.noise)
            return torch.sum(kl_bz, dim=-1)
        if c.prior == "gp" and "prior_row" in aux:
            # the Toeplitz structured prior: a full shared grid, no mask
            if c.posterior == "gp":
                kl_bz = gp.gp_kl_toeplitz_prior(mean, aux["l_q"],
                                                aux["prior_row"],
                                                logdet_q=aux.get("ld_q"))
            else:
                kl_bz = gp.gp_prior_diag_kl_toeplitz(mean, log_var,
                                                     aux["prior_row"])
            return torch.sum(kl_bz, dim=-1)
        if c.prior == "gp":
            if c.posterior == "gp":
                kl_bz = gp.gp_kl(mean, aux["l_q"], aux["l_p"], mask,
                                 logdet_q=aux.get("ld_q"),
                                 logdet_p=aux.get("ld_p"))
            else:
                kl_bz = gp.gp_prior_diag_kl(mean, log_var, aux["l_p"], mask,
                                            logdet_p=aux.get("ld_p"))
            return torch.sum(kl_bz, dim=-1)
        # the standard N(0, I) prior
        if c.posterior == "diag" or (c.posterior == "gp_plus_diag"
                                     and c.reference_recog_kl):
            return gp.standard_kl(mean, log_var, mask)
        if c.posterior == "gp_plus_diag":
            return torch.sum(gp.recog_gp_kl(mean, log_var, aux["l_q"], mask),
                             dim=-1)
        # a GP posterior against the identity factor
        l_q = aux["l_q"]
        eye = torch.eye(l_q.shape[-1], dtype=l_q.dtype,
                        device=l_q.device).expand_as(l_q)
        return torch.sum(gp.gp_kl(mean, l_q, eye, mask,
                                  logdet_q=aux.get("ld_q")), dim=-1)

    def forward(
        self,
        x: torch.Tensor,
        times: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        *,
        beta: float = 1.0,
        num_samples: int | None = None,
        feature_mask: torch.Tensor | None = None,
        eps: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> ELBOOutput:
        """The ELBO of a batch (``models.py:470-511``).  ``x [B, T, ...]``,
        ``times [B, T]`` (None for a model with no GP: ``0 .. T-1``),
        ``mask [B, T]`` bool observed steps, ``feature_mask [B, T, ...]``
        observed features (missing ones zero-filled in ``x``).  The
        posterior noise is ``eps`` in the layout of :meth:`noise_shape`
        when given, else drawn from ``generator`` on ``x``'s device."""
        c = self.config
        s = num_samples if num_samples is not None else c.num_samples
        if times is None:
            if c.needs_times:
                raise ValueError(f"{c.prior}/{c.posterior} model needs times")
            times = torch.arange(x.shape[1], dtype=x.dtype,
                                 device=x.device).expand(x.shape[:2])
        with span("gpvae.factor", device=True):
            aux = self.chol_banks(times, mask, logdets=True)
        z, mean, log_var, aux = self.sample_posterior(
            x, times, mask, s, aux=aux, eps=eps, generator=generator)
        with span("gpvae.kl", device=True):
            kl_b = self.kl(mean, log_var, times, mask, aux)
        logits = self.decode(z)
        nll = (elbo_lib.bernoulli_nll if c.likelihood == "bernoulli"
               else elbo_lib.gaussian_nll)
        nll_b = nll(logits, x, mask, feature_mask)
        loss = torch.mean(nll_b + beta * kl_b)
        if log_var is not None:
            aux = {**aux, "log_var": log_var}
        return ELBOOutput(loss=loss, nll=nll_b, kl=kl_b, beta=beta,
                          latent_mean=mean, latent_sample=z, logits=logits,
                          aux=aux)
