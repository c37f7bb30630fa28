"""Data parallelism of the port (``gpvae_tpu_torch.parallel``) against the
JAX package's ``gpvae_tpu/parallel/mesh.py``.

* one data-parallel step on two gloo ranks (spawned processes, a file
  store in ``tmp_path``) against the port's single-process step on the
  global batch with the same weights and noise, for irregular masked
  times, a ``feature_mask`` and the Toeplitz prior, under the JAX
  package's bands (``tests/test_parallel.py``: loss rel 1e-5, parameters
  rtol 1e-4 and atol 1e-6; ``K`` steps in one call against ``K`` single
  steps rtol 2e-4);
* the JAX package's divisibility and device-count errors;
* ``fit_data_parallel``'s logged and checkpointed steps, tail clamp and
  early stop against JAX's on its virtual mesh (the port's on an
  in-process gloo group of one), and its resume;
* the ``dp_scale`` preset field for field.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_cases as cases
from gpvae_tpu import configs as jconfigs
from gpvae_tpu import train as jtrain
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.models import GPVAEConfig as JConfig
from gpvae_tpu.parallel import fit_data_parallel as jfit_data_parallel
from gpvae_tpu.parallel import make_mesh as jmake_mesh
from gpvae_tpu.parallel import shard_batch as jshard_batch
from gpvae_tpu_torch import configs, train
from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.parallel import (
    fit_data_parallel, make_mesh, shard_batch,
)
from gpvae_tpu_torch.parallel import mesh as mesh_lib

SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The results of :func:`torch_dp_cases.run_rank` on two gloo ranks,
    one spawn for the whole file."""
    root = tmp_path_factory.mktemp("dp")
    out = str(root / "results")
    ctx = mp.start_processes(cases.run_rank,
                             args=(2, str(root / "store"), out), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the gloo ranks ran past {SPAWN_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(f"{out}.{r}", weights_only=True) for r in (0, 1)]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", cases.CASES)
def test_two_rank_step_matches_the_single_process_step(two_ranks, name):
    state, batch = cases.fresh_state(name)
    metrics = train.train_step(state, train.device_arrays(batch, "cpu"),
                               cases.SCHEDULE(0))
    got = two_ranks[0][name]
    for k in ("loss", "nll", "kl"):
        assert _rel(got["metrics"][k], metrics[k].item()) <= 1e-5, k
    want = cases.parameters(state)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_ranks_hold_the_same_state_after_their_steps(two_ranks):
    """Rank 1 began from other weights and noise: after replicate and the
    all-reduced steps both ranks hold the same parameters and metrics."""
    for name in cases.CASES:
        r0, r1 = two_ranks[0][name], two_ranks[1][name]
        assert r0["metrics"] == r1["metrics"], name
        for n, p in r0["params"].items():
            assert torch.equal(p, r1["params"][n]), (name, n)


def test_k_steps_in_one_call_match_k_single_dp_steps(two_ranks):
    k_steps = two_ranks[0]["k_steps"]
    assert k_steps["steps"] == (cases.K, cases.K)
    single, loss_single = k_steps["single"]
    multi, loss_multi = k_steps["multi"]
    assert _rel(loss_multi, loss_single) <= 1e-4
    for n, p in multi.items():
        np.testing.assert_allclose(p.numpy(), single[n].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=n)


def test_uneven_batch_raises_the_jax_error(two_ranks):
    """On two ranks and on a mesh of eight, the JAX package's text."""
    assert two_ranks[0]["uneven"] == (
        f"batch axis of 'x' ({cases.B - 1}) is not divisible by the 'data' "
        f"mesh axis (2 devices); pad or resize the global batch")
    uneven = _toy(12)
    mesh8 = mesh_lib.Mesh(0, 8, "data", torch.device("cpu"))
    with pytest.raises(ValueError) as ours:
        shard_batch(uneven, mesh8)
    with pytest.raises(ValueError) as ref:
        jshard_batch(uneven, jmake_mesh(8))
    assert str(ours.value) == str(ref.value)


@pytest.fixture()
def world_of_one(tmp_path):
    """An in-process gloo group of one rank, destroyed after the test."""
    mesh_lib.init_process_group(str(tmp_path / "store"), 0, 1, "cpu")
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_make_mesh_raises_the_jax_device_count_error(world_of_one):
    n = len(jax.devices())
    with pytest.raises(ValueError) as ref:
        jmake_mesh(n + 1)
    assert str(ref.value) == f"need {n + 1} devices, have {n}"
    with pytest.raises(ValueError, match=r"^need 2 devices, have 1$"):
        make_mesh(2)
    assert make_mesh(1) == world_of_one == mesh_lib.Mesh(
        0, 1, "data", torch.device("cpu"))


def _toy(n=8, t=10):
    return toy_to_masked_batch(generate_toy_data(np.random.default_rng(0), n,
                                                 t=t))


class _Saves:
    """A checkpoint manager that records the steps it is asked to save."""
    steps: list

    def __init__(self, directory, keep=3):
        pass

    def save(self, state):
        self.steps.append(int(state.step))

    def restore_latest(self, state):
        return None


@pytest.mark.parametrize("num_batches, num_steps", [(10, 10), (7, 100)],
                         ids=["tail_clamp", "exhausted"])
def test_fit_data_parallel_steps_match_jax(world_of_one, monkeypatch,
                                           num_batches, num_steps):
    """k=4: chunks of 4, 4, 2 when ten batches meet ``num_steps`` 10; 4
    then the 3 that arrived when seven batches end a run of 100.  The
    same logged steps, checkpoint saves and final step as JAX's on a mesh
    of two."""
    arrays = {k: v[:4] for k, v in _toy().items()}
    # a model without a GP: the loop's step counting is the same for
    # every model, and the JAX step compiles in a third of the time
    fields = dict(latent_dim=2, obs_dim=15, time_len=10, prior="standard",
                  posterior="diag")
    config = dict(num_steps=num_steps, log_every=4, steps_per_call=4,
                  checkpoint_every=8, checkpoint_dir="unused")
    seen = {}
    for side, lib in (("jax", jtrain), ("torch", train)):
        saves = type("Saves", (_Saves,), {"steps": []})
        monkeypatch.setattr(lib, "CheckpointManager", saves)
        batches = iter([arrays] * num_batches)
        if side == "jax":
            state, log = jfit_data_parallel(
                JGPVAE(JConfig(**fields)), batches,
                jtrain.TrainConfig(**config), jmake_mesh(2), verbose=False)
        else:
            state, log = fit_data_parallel(
                GPVAE(GPVAEConfig(**fields)), batches,
                train.TrainConfig(**config), world_of_one, verbose=False)
        seen[side] = ([r["step"] for r in log.rows], saves.steps,
                      int(state.step))
    assert seen["torch"] == seen["jax"]
    assert seen["jax"][2] == min(num_batches, num_steps)


def test_fit_data_parallel_resumes_its_checkpoint(world_of_one, tmp_path):
    """Rank 0 saves at 6 and at the end (8); a second run to 12 resumes at
    8 and equals one run of 12 steps on the same batches."""
    arrays = {k: v[:4] for k, v in _toy().items()}
    fields = dict(latent_dim=2, obs_dim=15, time_len=10, prior="gp",
                  posterior="gp", prior_lengthscales=(9.0, 3.0),
                  posterior_lengthscales=(5.0, 2.0))
    config = train.TrainConfig(num_steps=8, log_every=4, steps_per_call=3,
                               checkpoint_every=6,
                               checkpoint_dir=str(tmp_path / "ck"))

    def run(cfg):
        model = GPVAE(GPVAEConfig(**fields),
                      generator=torch.Generator().manual_seed(0))
        state, _ = fit_data_parallel(model, iter(lambda: arrays, None), cfg,
                                     world_of_one, verbose=False)
        return state

    first = run(config)
    assert first.step == 8
    assert train.CheckpointManager(str(tmp_path / "ck")).steps() == [6, 8]
    resumed = run(dataclasses.replace(config, num_steps=12))
    whole = run(dataclasses.replace(config, num_steps=12,
                                    checkpoint_dir=str(tmp_path / "whole")))
    assert resumed.step == whole.step == 12
    for (n, p), q in zip(resumed.model.named_parameters(),
                         whole.model.parameters()):
        assert torch.equal(p, q), n


def test_dp_scale_preset_matches_jax():
    ours, ref = configs.get("dp_scale"), jconfigs.get("dp_scale")
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(ref.model)
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
    assert (ours.batch_size, ours.description, ours.data_family) == (
        ref.batch_size, ref.description, ref.data_family) == (
        4096, ref.description, "toy_full")
    assert ours.model == configs.get("t1024_toeplitz").model
    assert len(configs.PRESETS) == len(jconfigs.PRESETS) == 13
