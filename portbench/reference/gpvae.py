"""The plain reference of the benchmark's configurations: the GP-VAE's
ELBO, its Adam steps and its GP-posterior imputation in plain PyTorch.

It reads a configuration file of ``portbench/configs`` and the weights and
inputs the benchmark made, and works everything out again: the dense
nets, the RBF grams, their Cholesky factors by ``torch.linalg.cholesky``,
the KL against a dense prior (a Toeplitz prior is built as the dense
matrix of its first row), the Bernoulli NLL, the beta schedule, Adam, and
the posterior conditional.  Nothing of the measured package is imported.

Every function takes a ``Precision``: float64 is the reference; float32
with ``tf32`` rounds each matrix product's operands to TF32 (10 mantissa
bits, as the card's tensor cores take them), the precision one step below
the configuration's float32, which the benchmark's control runs.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False


FLOAT64 = Precision()
TF32 = Precision(torch.float32, tf32=True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10 mantissa bits (nearest, ties
    to even)."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with every product's operands rounded to TF32, in the
    reverse mode too (as the card computes each of its products)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = a.shape, b.shape
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        sa, sb = ctx.shapes
        return (round_tf32(rg) @ rb.mT).sum_to_size(sa), \
            (ra.mT @ rg).sum_to_size(sb)


def mm(a: torch.Tensor, b: torch.Tensor, p: Precision) -> torch.Tensor:
    """``a @ b`` at precision ``p``."""
    if p.tf32:
        return _TF32Product.apply(a, b)
    return a @ b


# -- the nets ----------------------------------------------------------------

def dense_layers(cfg: dict) -> dict[str, list[tuple[int, int]]]:
    """``(in, out)`` of each linear layer of the encoder and the decoder:
    the reference's ReLU MLPs obs -> 32 -> 32 -> 16 -> 8 -> Z and back."""
    m, hidden = cfg["model"], list(cfg["dense_hidden"])
    enc = [m["obs_dim"], *hidden, m["latent_dim"]]
    dec = [m["latent_dim"], *reversed(hidden), m["obs_dim"]]
    return {"encoder": list(zip(enc[:-1], enc[1:])),
            "decoder": list(zip(dec[:-1], dec[1:]))}


def mlp(x: torch.Tensor, layers: list, p: Precision) -> torch.Tensor:
    """ReLU between the layers, none after the last; ``layers`` a list of
    ``(weight [out, in], bias [out])``."""
    h = x
    for i, (w, b) in enumerate(layers):
        h = mm(h, w.mT, p) + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


# -- the GP side ---------------------------------------------------------------

def rbf_gram(times: torch.Tensor, ls: torch.Tensor, noise: float,
             mask: torch.Tensor | None) -> torch.Tensor:
    """``[B, Z, T, T]``: ``(1 - noise) exp(-dt^2 / 2 l^2) + noise I``, the
    rows and columns of masked steps the identity."""
    dt = times[:, None, :, None] - times[:, None, None, :]
    k = torch.exp(-0.5 * (dt / ls[None, :, None, None]) ** 2)
    t = times.shape[-1]
    eye = torch.eye(t, dtype=k.dtype, device=k.device)
    k = (1.0 - noise) * k + noise * eye
    if mask is not None:
        m = mask.to(k.dtype)[:, None]
        k = k * (m[..., :, None] * m[..., None, :]) + (1.0 - m[..., :, None]) * eye
    return k


def toeplitz_gram(t: int, step: float, ls: torch.Tensor, noise: float,
                  dtype, device) -> torch.Tensor:
    """The dense ``[Z, T, T]`` gram of a uniform grid of spacing ``step``."""
    lag = torch.arange(t, dtype=dtype, device=device) * step
    dt = (lag[:, None] - lag[None, :]).abs()
    k = torch.exp(-0.5 * (dt[None] / ls[:, None, None]) ** 2)
    return (1.0 - noise) * k + noise * torch.eye(t, dtype=dtype, device=device)


def gp_kl(mu: torch.Tensor, l_q: torch.Tensor, l_p: torch.Tensor,
          p: Precision) -> torch.Tensor:
    """KL(N(mu, L_q L_q^T) || N(0, L_p L_p^T)) -> ``[B, Z]``; ``mu [B, Z,
    T]`` (masked steps zero), factors ``[B or 1, Z, T, T]``:
    ``1/2 (||L_p^-1 L_q||_F^2 + ||L_p^-1 mu||^2 - T + logdet K_p - logdet
    K_q)``."""
    t = mu.shape[-1]
    a = torch.linalg.solve_triangular(l_p, l_q, upper=False)
    tr = (a * a).sum((-2, -1))
    v = torch.linalg.solve_triangular(l_p, mu[..., None], upper=False)
    quad = (v * v).sum((-2, -1))
    ld_p = 2.0 * torch.log(torch.diagonal(l_p, dim1=-2, dim2=-1)).sum(-1)
    ld_q = 2.0 * torch.log(torch.diagonal(l_q, dim1=-2, dim2=-1)).sum(-1)
    return 0.5 * (tr + quad - t + ld_p - ld_q)


def beta_at(cfg: dict, step: int) -> float:
    """The beta schedule at ``step`` (steps already taken), in float32 as
    the configuration states it: ``init`` until ``start_step``, then ``+=
    rate`` a step, at most ``max_value``."""
    b = cfg["beta"]
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    ramp = f32(max(step - b["start_step"], 0))
    return f32(min(f32(f32(b["init"]) + f32(f32(b["rate"]) * ramp)),
                   f32(b["max_value"])))


def elbo(cfg: dict, w: dict, batch: dict, eps: torch.Tensor, beta: float,
         p: Precision):
    """The loss ``mean_b(nll_b + beta kl_b)`` of one batch, with ``nll [B]``
    and ``kl [B]``.  ``w``: the parameters by name, at ``p.dtype``;
    ``batch``: ``x [B, T, D]`` (hidden steps zero), ``times [B, T]``,
    ``mask [B, T]``; ``eps [1, B, Z, T]`` the posterior noise."""
    m = cfg["model"]
    z_dim, noise = m["latent_dim"], m["noise"]
    dt = p.dtype
    x = batch["x"].to(dt)
    times = batch["times"].to(dt)
    mask = batch["mask"]
    b, t, d = x.shape
    mk = mask.to(dt)
    mean = mlp(x.reshape(b * t, d), net(w, "encoder"), p).reshape(b, t, z_dim)
    mean = mean * mk[..., None]
    mu = mean.mT                                              # [B, Z, T]
    ls_q = torch.exp(w["posterior_log_ls"])
    if m["shared_time_grid"]:
        k_q = rbf_gram(times[:1], ls_q, noise, None)          # [1, Z, T, T]
    else:
        k_q = rbf_gram(times, ls_q, noise, mask)
    l_q = torch.linalg.cholesky(k_q)
    ls_p = torch.exp(w["prior_log_ls"])
    if m["structured_prior"] == "toeplitz":
        step = float(batch["times"][0, 1] - batch["times"][0, 0])
        l_p = torch.linalg.cholesky(
            toeplitz_gram(t, step, ls_p, noise, dt, x.device))[None]
    else:
        l_p = torch.linalg.cholesky(rbf_gram(times, ls_p, noise, mask))
    kl = gp_kl(mu, l_q, l_p, p).sum(-1)
    corr = mm(l_q, eps[0].to(dt)[..., None], p)[..., 0]        # [B, Z, T]
    z = (mu + corr).mT * mk[..., None]                        # [B, T, Z]
    logits = mlp(z.reshape(b * t, z_dim), net(w, "decoder"), p)
    logits = logits.reshape(b, t, d)
    elem = torch.logaddexp(torch.zeros_like(logits), logits) - x * logits
    nll = (elem.sum(-1) * mk).sum(-1)
    return torch.mean(nll + beta * kl), nll, kl


def net(w: dict, side: str) -> list:
    """The layers of ``side`` in order, from the parameters by name."""
    out, i = [], 0
    head = "mean_head" if side == "encoder" else "logits_head"
    while f"{side}_net.dense.{i}.weight" in w:
        out.append((w[f"{side}_net.dense.{i}.weight"],
                    w[f"{side}_net.dense.{i}.bias"]))
        i += 1
    out.append((w[f"{side}_net.{head}.weight"], w[f"{side}_net.{head}.bias"]))
    return out


def trainable(cfg: dict, names) -> list[str]:
    """The names the optimizer updates: every net parameter, and each
    log-lengthscale the configuration learns."""
    m = cfg["model"]
    learned = {"posterior_log_ls": m["learn_posterior_lengthscales"],
               "prior_log_ls": m["learn_prior_lengthscales"]}
    return [n for n in names if learned.get(n, True)]


def train(cfg: dict, weights: dict, batches: list, noise: list,
          p: Precision = FLOAT64) -> dict:
    """``len(batches)`` Adam steps of the ELBO from ``weights`` (float
    tensors by name), batch ``s`` with noise ``noise[s]``.  Returns each
    step's ``loss``, the first step's gradient by name (``grad1``) and the
    parameters after the last step (``params``), at ``p.dtype``."""
    w = {k: v.detach().to(p.dtype).clone() for k, v in weights.items()}
    names = trainable(cfg, w)
    lr = cfg["learning_rate"]
    (b1, b2), eps_adam = cfg["adam"]["betas"], cfg["adam"]["eps"]
    m1 = {n: torch.zeros_like(w[n]) for n in names}
    m2 = {n: torch.zeros_like(w[n]) for n in names}
    losses, grad1 = [], None
    for s, (batch, eps) in enumerate(zip(batches, noise)):
        for n in names:
            w[n].requires_grad_(True)
        loss, _, _ = elbo(cfg, w, batch, eps, beta_at(cfg, s), p)
        grads = torch.autograd.grad(loss, [w[n] for n in names])
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {n: g.detach() for n, g in zip(names, grads)}
        with torch.no_grad():
            k = s + 1
            for n, g in zip(names, grads):
                m1[n] = b1 * m1[n] + (1.0 - b1) * g
                m2[n] = b2 * m2[n] + (1.0 - b2) * g * g
                step = lr / (1.0 - b1 ** k)
                denom = (m2[n] / (1.0 - b2 ** k)).sqrt() + eps_adam
                w[n] = (w[n] - step * m1[n] / denom).detach()
    return {"loss": losses, "grad1": grad1,
            "params": {n: w[n].detach() for n in names}}


@torch.no_grad()
def impute(cfg: dict, weights: dict, batch: dict, kept: torch.Tensor,
           p: Precision = FLOAT64) -> dict:
    """GP-posterior imputation of ``batch`` from its ``kept`` steps: the
    encoder's means, each latent's GP (the prior's lengthscales)
    conditioned on the kept steps, ``m* = K_qo (K_oo + jitter I)^-1 z``,
    the encoder's means where kept, decoded.  Returns ``z [B, T, Z]`` and
    ``probs [B, T, D]``."""
    m = cfg["model"]
    z_dim, noise, dt = m["latent_dim"], m["noise"], p.dtype
    w = {k: v.to(dt) for k, v in weights.items()}
    x, times = batch["x"].to(dt), batch["times"].to(dt)
    b, t, d = x.shape
    mean = mlp(x.reshape(b * t, d), net(w, "encoder"), p).reshape(b, t, z_dim)
    # the prior's constant lengthscales as the model takes them: the exp,
    # like the log, in float32
    ls = torch.exp(weights["prior_log_ls"].float()).to(dt)
    k_oo = rbf_gram(times, ls, noise, kept)
    k_oo = k_oo + cfg["impute_jitter"] * torch.eye(t, dtype=dt,
                                                    device=x.device)
    dtt = times[:, None, :, None] - times[:, None, None, :]
    k_oq = (1.0 - noise) * torch.exp(-0.5 * (dtt / ls[None, :, None, None]) ** 2)
    kf = kept.to(dt)
    k_oq = k_oq * kf[:, None, :, None]
    zo = (mean * kf[..., None]).mT[..., None]                 # [B, Z, T, 1]
    l = torch.linalg.cholesky(k_oo)
    y = torch.linalg.solve_triangular(l, zo, upper=False)
    y = torch.linalg.solve_triangular(l.mT, y, upper=True)
    post = mm(k_oq.mT, y, p)[..., 0].mT                        # [B, T, Z]
    z = torch.where(kept[..., None], mean, post)
    probs = torch.sigmoid(mlp(z.reshape(b * t, z_dim), net(w, "decoder"),
                              p)).reshape(b, t, d)
    return {"z": z, "probs": probs}


def log_lengthscales(values) -> torch.Tensor:
    """``log`` of the configuration's lengthscales, taken in float32 as the
    measured model takes it."""
    return torch.log(torch.tensor([float(v) for v in values],
                                  dtype=torch.float32))

