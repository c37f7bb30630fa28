"""Synthetic GP-draw toy data in numpy.

Counterpart of ``gpvae_tpu/data/synthetic.py:37-171``, the reference
generator ``gen_toy_data`` (src/gen_data/simulate_toy_data.py:7-65):

* two latent trajectories on ``linspace(0, xmax, 45)``, drawn from
  GP(RBF, l=9, var=1) and GP(Cosine, l=3, var=0.75);
* ``p[d] = exp(f_d - max_f) / sum_d (0.1 + exp(f_d - max_f))`` for the
  first two groups, ``p2 = 1 - p0 - p1``;
* 15 Bernoulli observation dims in three groups of 5 sharing p0/p1/p2;
* ``Poisson(0.7 * 45)`` draws WITH replacement choose the hidden steps,
  so the hidden count is the number of distinct draws.

The draws come from a ``np.random.Generator``; they follow the same
distributions as the JAX package's ``jax.random`` draws, not the same
numbers.
"""
from __future__ import annotations

import numpy as np

TOY_T = 45
TOY_OBS_DIM = 15
TOY_XMAX = 60.0
TOY_TIME_GRID = np.linspace(0.0, TOY_XMAX, TOY_T)


def _gram(times: np.ndarray, lengthscale: float, kernel: str) -> np.ndarray:
    dt = (times[:, None] - times[None, :]) / lengthscale
    if kernel == "rbf":
        return np.exp(-0.5 * dt * dt)
    return np.cos(dt)


def generate_toy_data(
    rng: np.random.Generator,
    num_seqs: int,
    *,
    t: int = TOY_T,
    xmax: float = TOY_XMAX,
    obs_dim: int = TOY_OBS_DIM,
    hide_fraction: float = 0.7,
) -> dict:
    """Returns the reference pickle's fields as arrays:

    * ``x``     ``[N, T, obs_dim]`` float32 in {0, 1}, -1 at hidden steps,
    * ``f``     ``[N, 2, T]`` latent GP draws,
    * ``p``     ``[N, 3, T]`` group probabilities,
    * ``time``  ``[T]`` the shared grid,
    * ``mask``  ``[N, T]`` bool observed-step mask (True = observed).
    """
    times = np.linspace(0.0, xmax, t)
    # the cosine gram is exactly rank 2 and the l=9 RBF gram near-singular:
    # the same 1e-4 jitter as the JAX generator
    jitter = 1e-4 * np.eye(t)
    k_rbf = _gram(times, 9.0, "rbf") + jitter
    k_cos = 0.75 * _gram(times, 3.0, "cosine") + jitter
    l = np.linalg.cholesky(np.stack([k_rbf, k_cos]))           # [2, T, T]

    eps = rng.standard_normal((num_seqs, 2, t))
    f = np.einsum("dij,ndj->ndi", l, eps)                      # [N, 2, T]

    max_f = np.max(f, axis=1, keepdims=True)
    shifted = np.exp(f - max_f)
    denom = np.sum(0.1 + shifted, axis=1, keepdims=True)
    p01 = shifted / denom
    p2 = 1.0 - p01.sum(axis=1, keepdims=True)
    p = np.concatenate([p01, p2], axis=1)                      # [N, 3, T]

    group = np.repeat(np.arange(3), obs_dim // 3)              # [obs_dim]
    probs = p[:, group, :]                                     # [N, D, T]
    x = (rng.random(probs.shape) < probs).astype(np.float32)

    # Poisson(0.7 T) choices with replacement: the first n_hidden of T
    # uniform draws are hidden
    n_hidden = np.minimum(rng.poisson(hide_fraction * t, num_seqs), t)
    draws = rng.integers(0, t, (num_seqs, t))
    active = np.arange(t)[None, :] < n_hidden[:, None]
    hidden = np.zeros((num_seqs, t), bool)
    rows = np.broadcast_to(np.arange(num_seqs)[:, None], draws.shape)
    hidden[rows[active], draws[active]] = True
    mask = ~hidden

    x = np.where(mask[:, None, :], x, np.float32(-1.0))
    return {
        "x": np.ascontiguousarray(np.swapaxes(x, 1, 2)),  # [N, T, D]
        "f": f.astype(np.float32),
        "p": p.astype(np.float32),
        "time": times.astype(np.float32),
        "mask": mask,
    }


def toy_to_masked_batch(data: dict) -> dict:
    """Generator output (or a reference-format dict with sentinel ``x
    [N, obs_dim, T]`` and no mask) -> the batch format ``{x [N,T,D] in
    {0,1}, times [N,T], mask [N,T]}``."""
    x = np.asarray(data["x"])
    if x.ndim == 3 and x.shape[1] != x.shape[2] and "mask" not in data:
        x = np.swapaxes(x, 1, 2)  # reference pickle layout [N, obs_dim, T]
    n, t, _ = x.shape
    times = np.broadcast_to(
        np.asarray(data["time"]).reshape(-1)[:t], (n, t)
    ).copy()
    if "mask" in data:
        mask = np.asarray(data["mask"])
    else:
        mask = x[..., 0] > -1.0  # sentinel -1 marks a hidden step
    x_clean = np.where(mask[..., None], x, 0.0).astype(np.float32)
    return {"x": x_clean, "times": times.astype(np.float32), "mask": mask}
