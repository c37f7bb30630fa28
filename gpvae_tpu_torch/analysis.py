"""Imputation and analysis of a trained GP-VAE.

Counterpart of ``gpvae_tpu/analysis.py:36-400``:

* :func:`encode`, :func:`decode`, :func:`reconstruct`;
* :func:`drop_timesteps` -- drop a fraction of the observed steps;
* :func:`impute` -- GP-posterior imputation of the dropped steps, through
  ``gp.posterior_conditional`` (the Cholesky of a pre-built gram on the
  hand-written kernels, ``ops.chol.cholesky``, and ``ops.trsm``);
* :func:`impute_vae_prior` -- the N(0, 1)-fill baseline;
* :func:`latent_traversal`, :func:`traversal_from_gp`, :func:`prior_draws`
  (circulant embedding under the Toeplitz prior), :func:`activation_stats`;
* :func:`imputation_metrics` -- the synthetic-imputation evaluation;
* :func:`pixel_imputation_metrics` -- the missing-pixel evaluation of the
  healing-MNIST regime;
* :func:`make_artifact_callback` -- periodic PNGs during ``train.fit``.

The model is the port's ``GPVAE`` module, which holds its parameters, so
no ``params`` argument goes with it.  Every function runs under
``torch.no_grad()``.  Each random draw is an explicit argument (``eps``,
``kept``) or comes from ``generator``; a draw from a generator is made in
float32 on the generator's device and then moved to the data, so a CPU
generator with one seed gives the same draws for a run on the card and
one on the CPU, in either dtype.  (The JAX package draws from keys; its
tests and this port's feed both the same numpy draws instead.)
Frames may be ``[B, T, obs_dim]`` (dense nets) or ``[B, T, H, W, C]``
(conv nets).  A model with the FITC prior (``sparse_gp``) imputes under
its prior's exact kernel: FITC approximates only the training KL.
"""
from __future__ import annotations

import numpy as np
import torch

from gpvae_tpu_torch import gp, kernels, toeplitz
from gpvae_tpu_torch.models import GPVAE
from gpvae_tpu_torch.utils.profiling import span, spanned


def _draw(kind, shape: tuple, generator: torch.Generator | None):
    """``torch.randn`` or ``torch.rand`` of ``shape`` from ``generator``
    (the default CPU generator when None), float32 on its device."""
    dev = generator.device if generator is not None else torch.device("cpu")
    return kind(shape, generator=generator, dtype=torch.float32, device=dev)


def _given(eps: torch.Tensor | None, shape: tuple, like: torch.Tensor,
           generator: torch.Generator | None) -> torch.Tensor:
    """``eps`` (its shape checked), else a standard normal draw moved to
    the dtype and device of ``like``."""
    if eps is None:
        return _draw(torch.randn, shape, generator).to(like)
    if tuple(eps.shape) != shape:
        raise ValueError(f"eps must be {shape}, got {tuple(eps.shape)}")
    return eps


def _param_or_const(model: GPVAE, name: str) -> torch.Tensor:
    """The log-lengthscales ``name`` the JAX package's analysis reads
    (``analysis.py:346-353``): the learned parameter where the model
    learns it, else the config's constant, ``log`` taken in float32 as
    the JAX model takes it.  As there, a model without that GP side falls
    back on the config's lengthscales, which raise ``ValueError`` where
    they do not fit ``latent_dim`` (``vanilla_vae``'s default (9, 3)
    against Z=100)."""
    params = dict(model.named_parameters())
    if name in params:
        return params[name]
    cfg = model.config
    raw = (cfg.prior_lengthscales if name == "prior_log_ls"
           else cfg.posterior_lengthscales)
    device = next(model.parameters()).device
    return torch.log(torch.tensor(cfg._ls_tuple(raw),
                                  dtype=torch.float32)).to(device)


def _mean(model: GPVAE, x: torch.Tensor) -> torch.Tensor:
    """The encoder's means ``[B, T, Z]``, without a log-variance."""
    enc = model.encode(x)
    return enc[0] if isinstance(enc, tuple) else enc


@torch.no_grad()
def encode(model: GPVAE, x: torch.Tensor):
    """``[B, T, ...]`` -> latent means ``[B, T, Z]``, or ``(mean,
    log_var)`` where the posterior has a variance head."""
    return model.encode(x)


@torch.no_grad()
def decode(model: GPVAE, z: torch.Tensor) -> torch.Tensor:
    """Latents ``[..., Z]`` -> Bernoulli logits ``[..., obs_dim]`` or
    ``[..., H, W, C]``."""
    return model.decode(z)


@torch.no_grad()
def reconstruct(model: GPVAE, x, times=None, mask=None, *,
                num_samples: int = 1, eps=None, generator=None):
    """Encode, draw from the posterior (``eps`` in the layout of
    ``model.noise_shape``), decode; returns ``(probs [S, B, T, ...], z [S,
    B, T, Z])``.  ``times`` defaults to ``0 .. T-1``."""
    b, t = x.shape[:2]
    if times is None:
        times = torch.arange(t, dtype=x.dtype, device=x.device).expand(b, t)
    eps = _given(eps, model.noise_shape(num_samples, b, t), x, generator)
    z, *_ = model.sample_posterior(x, times, mask, num_samples, eps=eps)
    return torch.sigmoid(model.decode(z)), z


@torch.no_grad()
def drop_timesteps(mask: torch.Tensor, drop_fraction: float, *,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """The kept mask: each observed step of ``mask [B, T]`` is dropped
    with probability ``drop_fraction``."""
    u = _draw(torch.rand, tuple(mask.shape), generator).to(mask.device)
    return mask & (u >= drop_fraction)


@spanned("gpvae.impute")
@torch.no_grad()
def impute(model: GPVAE, x, times, mask, kept_mask, *, sample: bool = False,
           use_prior_lengthscales: bool = True, eps=None, generator=None):
    """GP-posterior imputation: encode, condition each latent dim's GP on
    the kept steps, predict (``sample=False``) or draw (``eps [1, B, Z,
    T]``) the latents on the full grid, keep the encoder means where kept,
    decode.  Returns ``(probs [B, T, ...], z_imputed [B, T, Z],
    post)``.  The GP is the prior's (its lengthscales, learned or the
    config's constant) unless ``use_prior_lengthscales=False``, which takes
    the posterior's.  ``mask`` is not read: ``kept_mask`` already lies
    inside it."""
    mean = _mean(model, x)
    cfg = model.config
    name = ("prior_log_ls" if cfg.prior in ("gp", "sparse_gp")
            and use_prior_lengthscales else "posterior_log_ls")
    ls = torch.exp(_param_or_const(model, name)).to(times.dtype)
    with span("gpvae.posterior", device=True):
        post = gp.posterior_conditional(
            times, mean * kept_mask[..., None].to(mean.dtype), times, ls,
            mask_obs=kept_mask, kernel=cfg.kernel, noise=cfg.noise,
            with_cov=sample)
    if sample:
        b, t, z = mean.shape
        z_full = gp.posterior_sample(
            post, eps=_given(eps, (1, b, z, t), mean, generator))[0]
    else:
        z_full = post.mean
    z_imputed = torch.where(kept_mask[..., None], mean, z_full)
    return torch.sigmoid(model.decode(z_imputed)), z_imputed, post


@torch.no_grad()
def impute_vae_prior(model: GPVAE, x, kept_mask, *, eps=None,
                     generator=None):
    """The baseline: dropped steps' latents are N(0, 1) draws (``eps [B, T,
    Z]``).  Returns ``(probs, z)``."""
    mean = _mean(model, x)
    noise = _given(eps, tuple(mean.shape), mean, generator)
    z = torch.where(kept_mask[..., None], mean, noise)
    return torch.sigmoid(model.decode(z)), z


@torch.no_grad()
def latent_traversal(model: GPVAE, z_base: torch.Tensor, dim: int, *,
                     num_points: int = 8,
                     prob_range: tuple[float, float] = (0.05, 0.95)):
    """Tile ``z_base [Z]`` and sweep ``dim`` over a probit grid; returns
    probs ``[num_points, obs_dim]``."""
    from scipy.stats import norm

    grid = torch.as_tensor(norm.ppf(np.linspace(*prob_range, num_points)),
                           dtype=z_base.dtype, device=z_base.device)
    z = z_base[None].repeat(num_points, 1)
    z[:, dim] = grid
    return torch.sigmoid(model.decode(z[None, :, None, :]))[0, :, 0]


@torch.no_grad()
def traversal_from_gp(model: GPVAE, times: torch.Tensor, dim: int, *,
                      z_base=None, eps=None, generator=None):
    """Sweep ``dim`` along a draw (``eps [1, 1, Z, T]``) from the learned
    posterior GP over ``times [T]``; returns probs ``[T, obs_dim]``."""
    cfg = model.config
    ls = torch.exp(_param_or_const(model, "posterior_log_ls")).to(times.dtype)
    l = gp.chol_gram_bank(times[None], ls, kernel=cfg.kernel, noise=cfg.noise)
    t = times.shape[0]
    eps = _given(eps, (1, 1, cfg.latent_dim, t), l, generator)
    draw = gp.prior_sample(l, eps=eps)[0, 0]                  # [T, Z]
    if z_base is None:
        z_base = torch.zeros(cfg.latent_dim, dtype=draw.dtype,
                             device=draw.device)
    z = z_base[None].repeat(t, 1)
    z[:, dim] = draw[:, dim]
    return torch.sigmoid(model.decode(z[None, None]))[0, 0]


@torch.no_grad()
def prior_draws(model: GPVAE, times: torch.Tensor, *, num_samples: int = 1,
                eps=None, generator=None) -> torch.Tensor:
    """Latent trajectories from the model's GP prior over ``times [T]`` ->
    ``[S, T, Z]`` (``analysis.py:191-222``): through a dense Cholesky
    (``eps [S, 1, Z, T]``), or with the Toeplitz structured prior by
    circulant embedding on the uniform grid
    (``toeplitz.circulant_prior_sample``, ``eps [S, Z, 2(T-1)]``)."""
    cfg = model.config
    ls = torch.exp(_param_or_const(model, "prior_log_ls")).to(times.dtype)
    if cfg.toeplitz_prior:
        row = kernels.toeplitz_row(times.shape[0], times[1] - times[0], ls,
                                   kernel=cfg.kernel, noise=cfg.noise,
                                   dtype=times.dtype)
        t = times.shape[0]
        eps = _given(eps, (num_samples, cfg.latent_dim, 2 * (t - 1)), row,
                     generator)
        return toeplitz.circulant_prior_sample(row, num_samples,
                                               eps=eps).mT
    l = gp.chol_gram_bank(times[None], ls, kernel=cfg.kernel, noise=cfg.noise)
    eps = _given(eps, (num_samples, 1, cfg.latent_dim, times.shape[0]), l,
                 generator)
    return gp.prior_sample(l, num_samples, eps=eps)[:, 0]


@torch.no_grad()
def activation_stats(model: GPVAE, x, times, mask, *,
                     num_samples: int = 100, eps=None, generator=None):
    """Monte-Carlo per-dim latent statistics over ``eps`` (the layout of
    ``model.noise_shape``): ``(mc_means [B, T, Z], per-dim variance of
    those means [Z], sorted descending)``."""
    b, t = x.shape[:2]
    eps = _given(eps, model.noise_shape(num_samples, b, t), x, generator)
    z, *_ = model.sample_posterior(x, times, mask, num_samples, eps=eps)
    mc_mean = z.mean(dim=0)
    if mask is not None:
        w = mask[..., None].to(mc_mean.dtype)
        flat_mean = (mc_mean * w).sum((0, 1)) / w.sum((0, 1))
        var = ((mc_mean - flat_mean) ** 2 * w).sum((0, 1)) / w.sum((0, 1))
    else:
        var = mc_mean.var(dim=(0, 1), unbiased=False)
    return mc_mean, var[torch.argsort(-var)]


@torch.no_grad()
def imputation_metrics(model: GPVAE, x, times, mask, *,
                       drop_fraction: float = 0.5, kept=None,
                       baseline_eps=None, generator=None) -> dict:
    """Drop ``drop_fraction`` of the observed steps (or take the kept mask
    ``kept``), GP-impute their latents, decode, and score against ``x`` on
    exactly the dropped steps: per-element Bernoulli NLL and MSE, beside
    the N(0, 1)-fill baseline (noise ``baseline_eps [B, T, Z]``).  Draws
    not given come from ``generator``, the kept mask first."""
    if kept is None:
        kept = drop_timesteps(mask, drop_fraction, generator=generator)
    dropped = mask & ~kept

    def score(probs):
        p = torch.clamp(probs, 1e-6, 1.0 - 1e-6)
        nll = -(x * torch.log(p) + (1.0 - x) * torch.log1p(-p))
        mse = (probs - x) ** 2
        w = dropped[(...,) + (None,) * (nll.dim() - 2)].to(
            p.dtype).expand_as(nll)
        denom = torch.clamp(w.sum(), min=1.0)
        return (float((nll * w).sum() / denom),
                float((mse * w).sum() / denom))

    probs_gp, _, _ = impute(model, x, times, mask, kept)
    nll_gp, mse_gp = score(probs_gp)
    probs_base, _ = impute_vae_prior(model, x, kept, eps=baseline_eps,
                                     generator=generator)
    nll_b, mse_b = score(probs_base)
    return {"dropped_steps": int(dropped.sum()),
            "nll_gp_impute": nll_gp, "mse_gp_impute": mse_gp,
            "nll_baseline": nll_b, "mse_baseline": mse_b}


@torch.no_grad()
def pixel_imputation_metrics(model: GPVAE, batch: dict) -> dict:
    """Missing-pixel scoring, the healing-MNIST regime
    (``analysis.py:296-343``).  ``batch`` is a ``data.make_healing_batch``
    dict (numpy arrays or tensors; moved to the model's device, frames in
    its dtype): the encoder sees the zero-filled ``x``, the decoded
    posterior means are scored against ``x_clean`` on exactly the missing
    pixels (``~feature_mask``), per pixel Bernoulli NLL and MSE, beside
    the predictor of the observed pixels' marginal on-rate."""
    p = next(model.parameters())

    def tensor(key, dtype=None):
        v = batch[key]
        v = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v))
        return v.to(device=p.device, dtype=dtype or v.dtype)

    x, x_clean = tensor("x", p.dtype), tensor("x_clean", p.dtype)
    fmask = tensor("feature_mask", torch.bool)
    probs = torch.sigmoid(model.decode(_mean(model, x)))
    missing = (~fmask).to(probs.dtype)
    denom = torch.clamp(missing.sum(), min=1.0)

    def score(q):
        q = torch.clamp(q, 1e-6, 1.0 - 1e-6)
        nll = -(x_clean * torch.log(q) + (1 - x_clean) * torch.log1p(-q))
        mse = (q - x_clean) ** 2
        return (float((nll * missing).sum() / denom),
                float((mse * missing).sum() / denom))

    nll_model, mse_model = score(probs)
    # the baseline predicts the observed marginal on-rate everywhere
    observed = fmask.to(probs.dtype)
    obs_rate = (x_clean * observed).sum() / torch.clamp(observed.sum(),
                                                         min=1.0)
    nll_base, mse_base = score(torch.full_like(probs, float(obs_rate)))
    return {"missing_pixels": int(missing.sum()),
            "nll_model": nll_model, "mse_model": mse_model,
            "nll_marginal_baseline": nll_base,
            "mse_marginal_baseline": mse_base}


def make_artifact_callback(model: GPVAE, probe_batch: dict, out_dir: str):
    """A ``train.fit`` callback ``fn(state, step)`` that writes PNGs of
    ``probe_batch`` (``x``, ``times``, ``mask``) each time it fires
    (``analysis.py:356-400``, the reference's in-loop ``savefig`` blocks):
    the first sequence's input and reconstruction film strips
    (``input_<step>.png``, ``recon_<step>.png``) for a conv decoder, its
    latent means against time (``latents_<step>.png``) for a dense one.
    The posterior noise of step ``s`` comes from a CPU generator seeded
    with ``s``."""
    import os

    from gpvae_tpu_torch.utils import plotting

    os.makedirs(out_dir, exist_ok=True)

    def host(v):
        return v.detach().cpu().numpy()

    @torch.no_grad()
    def cb(state, step):
        p = next(model.parameters())
        x = torch.as_tensor(np.asarray(probe_batch["x"])).to(p)
        times = torch.as_tensor(np.asarray(probe_batch["times"])).to(p)
        mask = torch.as_tensor(np.asarray(probe_batch["mask"])).to(p.device)
        b, t = x.shape[:2]
        eps = _draw(torch.randn, model.noise_shape(1, b, t),
                    torch.Generator().manual_seed(step)).to(p)
        out = model(x, times, mask, eps=eps)
        probs = torch.sigmoid(out.logits[0])  # the one sample
        if model.config.decoder == "conv":
            plotting.film_strip(
                host(x[0]), os.path.join(out_dir, f"input_{step:08d}.png"),
                title=f"input (step {step})")
            plotting.film_strip(
                host(probs[0]),
                os.path.join(out_dir, f"recon_{step:08d}.png"),
                title=f"reconstruction (step {step})")
        else:
            plotting.trajectory_plot(
                host(times[0]), host(out.latent_mean[0]),
                os.path.join(out_dir, f"latents_{step:08d}.png"),
                mask=host(mask[0]))

    return cb
