"""The data-parallel cases of ``tests/test_torch_parallel.py`` that run in
spawned gloo ranks (and their single-process references in the test).
Imports no JAX: each rank starts from a fresh import of this module."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gpvae_tpu_torch import elbo, train
from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.parallel import mesh as mesh_lib

B, T, K = 8, 10, 3
# irregular masked times, a per-feature mask, and the Toeplitz prior on
# one uniform grid: the three regimes the DP step must carry
CASES = ("dense", "feature_mask", "toeplitz")
SCHEDULE = elbo.BetaSchedule(init=0.5, rate=0.1, start_step=1)
LEARNING_RATE = 1e-3


def case(name: str) -> tuple[dict, dict]:
    """``(model config fields, global batch of B sequences)``."""
    fields = dict(latent_dim=2, obs_dim=15, time_len=T, prior="gp",
                  posterior="gp", prior_lengthscales=(9.0, 3.0),
                  posterior_lengthscales=(5.0, 2.0))
    rng = np.random.default_rng(3)
    if name == "toeplitz":
        fields.update(shared_time_grid=True, structured_prior="toeplitz")
        batch = toy_to_masked_batch(generate_toy_data(rng, B, t=T,
                                                      hide_fraction=0.0))
    else:
        batch = toy_to_masked_batch(generate_toy_data(rng, B, t=T))
    if name == "feature_mask":
        batch["feature_mask"] = rng.random(batch["x"].shape) >= 0.5
    return fields, batch


def fresh_state(name: str, seed: int = 0) -> tuple[train.TrainState, dict]:
    """A case's model (weights from ``seed``) on the CPU with Adam and a
    noise generator seeded as ``train.fit`` seeds it."""
    fields, batch = case(name)
    model = GPVAE(GPVAEConfig(**fields),
                  generator=torch.Generator().manual_seed(seed))
    state = train.create_train_state(
        model, train.TrainConfig(learning_rate=LEARNING_RATE), "cpu")
    return state, batch


def parameters(state: train.TrainState) -> dict:
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def run_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank: for each case one data-parallel step of a replicated
    state (rank 1 starts from other weights and noise, which
    :func:`replicate` overwrites), then ``K`` steps in one call of
    ``make_parallel_multi_step`` against ``K`` single steps, and the
    divisibility error; rank r's results saved to ``out.r``."""
    torch.set_num_threads(1)
    mesh_lib.init_process_group(store, rank, world, "cpu")
    try:
        mesh = mesh_lib.make_mesh()
        results = {}
        for name in CASES:
            state, batch = fresh_state(name, seed=rank)
            state.generator.manual_seed(1 + 100 * rank)
            mesh_lib.replicate(state, mesh)
            step = mesh_lib.make_parallel_train_step(SCHEDULE, mesh)
            _, metrics = step(state, mesh_lib.shard_batch(batch, mesh))
            results[name] = {"metrics": {k: metrics[k].item()
                                         for k in ("loss", "nll", "kl")},
                             "params": parameters(state)}
        single, batch = fresh_state("dense")
        step = mesh_lib.make_parallel_train_step(SCHEDULE, mesh)
        local = mesh_lib.shard_batch(batch, mesh)
        for _ in range(K):
            _, last = step(single, local)
        multi, _ = fresh_state("dense")
        _, last_multi = mesh_lib.make_parallel_multi_step(SCHEDULE, mesh)(
            multi, mesh_lib.shard_batch_stack([batch] * K, mesh))
        results["k_steps"] = {
            "single": (parameters(single), last["loss"].item()),
            "multi": (parameters(multi), last_multi["loss"].item()),
            "steps": (single.step, multi.step)}
        try:
            mesh_lib.shard_batch({k: v[:B - 1] for k, v in batch.items()},
                                 mesh)
        except ValueError as e:
            results["uneven"] = str(e)
        torch.save(results, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()
