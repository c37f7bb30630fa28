"""What the benchmark makes from ``--seed``: the weights and the toy data.

Both are drawn on the run's device by a ``torch.Generator`` there, in a
few large calls, and handed alike to the measured program and to the
plain reference.

The toy data follows the reference's ``gen_toy_data``
(src/gen_data/simulate_toy_data.py, as ``gpvae_tpu_torch/data/
synthetic.py`` ports it to numpy): two latent GP draws a sequence,
RBF(l=9) and 0.75 Cosine(l=3) with a 1e-4 jitter, on ``linspace(0, xmax,
T)``; three groups of five Bernoulli features with the softmax-like
probabilities ``exp(f_d - max f) / sum(0.1 + exp(f - max f))``; and
``Poisson(hide_fraction T)`` draws with replacement that pick the hidden
steps.  Here the draws are float64 on the card (at T=8192 the host's
Cholesky of the two grams would take seconds), hidden steps are zero in
``x`` and False in ``mask``.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.gpvae import dense_layers, log_lengthscales

OBS_GROUPS = 3


def stream_seed(seed: int, stream: int) -> int:
    """The seed of one stream of draws (weights, data, noise, ...), all
    from ``seed``."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """The model's parameters and lengthscale buffers by name (float32):
    each weight a truncated normal (``init.weight_std``, cut at
    ``init.truncate_at_std`` of it) from ONE uniform draw by the inverse
    CDF, each bias ``init.bias``, the log-lengthscales the configuration's."""
    init = cfg["init"]
    layers = dense_layers(cfg)
    shapes = []
    for side, dims in layers.items():
        for i, (n_in, n_out) in enumerate(dims):
            name = (f"{side}_net.dense.{i}" if i < len(dims) - 1 else
                    f"{side}_net.{'mean_head' if side == 'encoder' else 'logits_head'}")
            shapes.append((name, n_out, n_in))
    total = sum(o * i for _, o, i in shapes)
    u = torch.rand(total, generator=generator(seed, device, 1),
                   dtype=torch.float64, device=device)
    cut = init["truncate_at_std"]
    lo, hi = (0.5 * (1.0 + math.erf(s * cut / math.sqrt(2.0))) for s in (-1, 1))
    draw = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
            * init["weight_std"]).to(torch.float32)
    out, at = {}, 0
    for name, n_out, n_in in shapes:
        out[f"{name}.weight"] = draw[at:at + n_out * n_in].view(n_out, n_in)
        out[f"{name}.bias"] = torch.full((n_out,), init["bias"],
                                         dtype=torch.float32, device=device)
        at += n_out * n_in
    m = cfg["model"]
    out["posterior_log_ls"] = log_lengthscales(m["posterior_lengthscales"]).to(device)
    out["prior_log_ls"] = log_lengthscales(m["prior_lengthscales"]).to(device)
    return out


def toy_sequences(g: torch.Generator, n: int, t: int, *, xmax: float,
                  hide_fraction: float, obs_dim: int) -> dict:
    """``n`` toy sequences of length ``t``: ``x [n, t, obs_dim]`` float32
    (zero at hidden steps), ``times [n, t]`` float32, ``mask [n, t]`` bool
    (True where observed), on ``g``'s device."""
    dev = g.device
    f64 = torch.float64
    grid = torch.linspace(0.0, xmax, t, dtype=f64, device=dev)
    dt = grid[:, None] - grid[None, :]
    jitter = 1e-4 * torch.eye(t, dtype=f64, device=dev)
    grams = torch.stack([torch.exp(-0.5 * (dt / 9.0) ** 2) + jitter,
                         0.75 * torch.cos(dt / 3.0) + jitter])
    chol = torch.linalg.cholesky(grams)                          # [2, T, T]
    del grams, dt, jitter
    eps = torch.randn((2, t, n), generator=g, dtype=f64, device=dev)
    f = (chol @ eps).permute(2, 0, 1)                             # [n, 2, T]
    del chol, eps
    shifted = torch.exp(f - f.max(dim=1, keepdim=True).values)
    p01 = shifted / (0.1 + shifted).sum(dim=1, keepdim=True)
    p = torch.cat([p01, 1.0 - p01.sum(dim=1, keepdim=True)], dim=1)
    group = torch.arange(obs_dim, device=dev) // (obs_dim // OBS_GROUPS)
    probs = p[:, group, :].mT                                     # [n, T, D]
    x = (torch.rand(probs.shape, generator=g, dtype=f64, device=dev)
         < probs).to(torch.float32)
    n_hidden = torch.poisson(torch.full((n,), hide_fraction * t, dtype=f64,
                                        device=dev), generator=g).clamp(max=t)
    draws = torch.randint(0, t, (n, t), generator=g, device=dev)
    active = torch.arange(t, device=dev)[None] < n_hidden[:, None]
    hidden = torch.zeros((n, t + 1), dtype=torch.bool, device=dev)
    hidden.scatter_(1, torch.where(active, draws, t), True)
    mask = ~hidden[:, :t]
    return {"x": x * mask[..., None], "times": grid.to(torch.float32).expand(n, t).contiguous(),
            "mask": mask}


def dropped(g: torch.Generator, mask: torch.Tensor, fraction: float) -> torch.Tensor:
    """The kept mask: each observed step of ``mask`` is dropped with
    probability ``fraction``."""
    u = torch.rand(mask.shape, generator=g, dtype=torch.float32, device=mask.device)
    return mask & (u >= fraction)
