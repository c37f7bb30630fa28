"""Data-parallel training over ``torch.distributed``.

Counterpart of ``gpvae_tpu/parallel/mesh.py`` (BASELINE config 5: 4096
sequences x T=1024 over several chips).  The JAX package shards the
batch over a device mesh with ``NamedSharding`` and lets XLA insert one
``psum`` of the gradients.  PyTorch's idiom is one process a device in a
process group:

* :func:`make_mesh` records this process's rank, the world size and its
  device, from a default group already joined (:func:`init_process_group`:
  NCCL on CUDA, gloo on the CPU, through a file store);
* every rank reads the same global batch and keeps its contiguous slice
  (:func:`shard_batch`, :func:`shard_batch_stack`);
* parameters, buffers, Adam's state and the noise generator are the same
  on every rank (:func:`replicate` broadcasts rank 0's);
* a step (:func:`make_parallel_train_step`) draws the global batch's
  noise from the replicated generator and keeps its rows, runs the
  forward and backward on its rows, and averages the gradients with one
  ``all_reduce`` of a flat buffer before Adam: the loss is a mean over
  the batch, so the mean of equal shards' gradients is the global
  gradient.

The step is :func:`train.train_step` itself with the all-reduce between
its backward and Adam, not ``DistributedDataParallel``: the same body
runs on one process and on many.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch
import torch.distributed as dist

from gpvae_tpu_torch import elbo as elbo_lib
from gpvae_tpu_torch import train as train_lib
from gpvae_tpu_torch.models import GPVAE, resolve_structured_prior
from gpvae_tpu_torch.train import TrainState


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis over the ``world_size`` ranks of the default group: this
    process's ``rank`` and its ``device``."""
    rank: int
    world_size: int
    axis_name: str
    device: torch.device


def init_process_group(init_file: str, rank: int = 0, world_size: int = 1,
                       device_type: str = "cuda") -> None:
    """Join a default group of ``world_size`` processes through a file
    store at ``init_file`` (a path every rank sees, not yet in use; no
    network): NCCL for ``device_type`` "cuda", gloo for "cpu"."""
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(init_file)}",
        rank=rank, world_size=world_size)


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              devices: list | None = None) -> Mesh:
    """The mesh over every rank of the default group, which must be joined
    (:func:`init_process_group`).  ``devices[r]`` is rank r's device; by
    default ``cuda:r`` (modulo the cards on the host) under NCCL and the
    CPU under gloo.  Raises the JAX package's ``ValueError`` when the
    world is smaller than ``n_devices``; unlike the JAX package's, it
    spans the whole world (no rank is left out of the group's
    collectives)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined process group: call "
                           "init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if n < world:
        raise ValueError(f"the mesh spans all {world} ranks, not {n}")
    if devices is not None:
        device = torch.device(devices[rank])
    elif dist.get_backend() == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, world, axis_name, device)


def _check_divisible(key: str, rows: int, mesh: Mesh, hint: str) -> None:
    if rows % mesh.world_size:
        raise ValueError(
            f"batch axis of {key!r} ({rows}) is not divisible by the "
            f"{mesh.axis_name!r} mesh axis ({mesh.world_size} devices)"
            + hint)


def _local_rows(v, mesh: Mesh):
    rows = v.shape[0] // mesh.world_size
    return v[mesh.rank * rows:(mesh.rank + 1) * rows]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous slice of the global ``batch`` (its leading
    axis split evenly over the mesh), as tensors on its device
    (:func:`train.device_arrays`; ``feature_mask`` shards like the
    rest)."""
    batch = {k: v for k, v in batch.items() if v is not None}
    for k, v in batch.items():
        _check_divisible(k, v.shape[0], mesh,
                         "; pad or resize the global batch")
    return train_lib.device_arrays(
        {k: _local_rows(v, mesh) for k, v in batch.items()}, mesh.device)


def shard_batch_stack(batches: list, mesh: Mesh) -> dict:
    """``k`` global batches as this rank's ``[k, B / n, ...]`` tensors:
    the second axis (the global batch) sharded, the operand of
    :func:`make_parallel_multi_step`."""
    keys = [k for k in batches[0] if batches[0].get(k) is not None]
    for k in keys:
        _check_divisible(k, batches[0][k].shape[0], mesh, "")
    return train_lib.stack_batches(
        [{k: _local_rows(b[k], mesh) for k in keys} for b in batches],
        mesh.device)


def _broadcast(t: torch.Tensor, mesh: Mesh) -> None:
    """``t`` set to rank 0's in place, through the mesh's device (NCCL
    takes only CUDA tensors; Adam's step count and a generator's state
    live on the CPU)."""
    if t.device == mesh.device:
        dist.broadcast(t, 0)
        return
    buf = t.to(mesh.device)
    dist.broadcast(buf, 0)
    t.copy_(buf)


def replicate(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's model parameters and buffers, Adam state, step and noise
    generator on every rank (in place; returns ``state``).  Every rank's
    optimizer state must have the same structure (all fresh, or all
    restored from one checkpoint)."""
    for t in state.model.state_dict().values():
        _broadcast(t, mesh)
    for per_param in state.optimizer.state.values():
        for v in per_param.values():
            if isinstance(v, torch.Tensor):
                _broadcast(v, mesh)
    gen = state.generator.get_state()
    _broadcast(gen, mesh)
    state.generator.set_state(gen)
    step = torch.tensor([state.step], dtype=torch.int64)
    _broadcast(step, mesh)
    state.step = int(step.item())
    return state


def _all_reduce_mean(params, mesh: Mesh) -> None:
    """Each gradient of ``params`` replaced by its mean over the mesh: one
    ``all_reduce`` of a flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_parallel_train_step(
    beta_schedule: elbo_lib.BetaSchedule, mesh: Mesh,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """One data-parallel step ``(state, local batch) -> (state, metrics)``
    on this rank's shard (:func:`shard_batch`) of a replicated state.
    The noise is the global batch's, ``model.noise_shape(S, B_global,
    T)`` drawn from the replicated generator, of which the rank keeps its
    rows: what a single-process step on the global batch draws (the JAX
    package shards one draw).  After the backward the gradients are
    averaged over the mesh, then Adam steps; ``loss``, ``nll`` and ``kl``
    are the global batch's means on every rank."""
    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.model
        b, t = batch["x"].shape[:2]
        dtype = next(model.parameters()).dtype
        eps = torch.randn(model.noise_shape(model.config.num_samples,
                                            b * mesh.world_size, t),
                          generator=state.generator, dtype=dtype,
                          device=mesh.device)
        metrics = train_lib.train_step(
            state, batch, beta_schedule(state.step),
            eps=eps.narrow(1, mesh.rank * b, b),
            before_update=lambda: _all_reduce_mean(model.parameters(), mesh))
        means = torch.stack([metrics["loss"], metrics["nll"], metrics["kl"]])
        dist.all_reduce(means)
        means /= mesh.world_size
        metrics.update(loss=means[0], nll=means[1], kl=means[2])
        return state, metrics

    return step


def make_parallel_multi_step(
    beta_schedule: elbo_lib.BetaSchedule, mesh: Mesh,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``k`` data-parallel steps a call over this rank's ``[k, B / n,
    ...]`` super-batch (:func:`shard_batch_stack`), ``k`` its leading
    axis: the mesh's :func:`train.make_multi_step`.  Returns the state and
    the last step's metrics."""
    step = make_parallel_train_step(beta_schedule, mesh)

    def run(state: TrainState, batches: dict) -> tuple[TrainState, dict]:
        for i in range(next(iter(batches.values())).shape[0]):
            state, metrics = step(state, {k: v[i]
                                          for k, v in batches.items()})
        return state, metrics

    return run


def fit_data_parallel(
    model: GPVAE,
    batches,
    config: train_lib.TrainConfig,
    mesh: Mesh | None = None,
    *,
    state: TrainState | None = None,
    axis_name: str = "data",
    verbose: bool = True,
) -> tuple[TrainState, train_lib.MetricsLog]:
    """``train.fit`` over a data-parallel mesh (``parallel/mesh.py:
    202-329``).  Every rank reads the same GLOBAL batches from
    ``batches`` and keeps its shard; ``config.steps_per_call`` steps run a
    call (:func:`make_parallel_multi_step`), the last chunk clamped to the
    steps left, and an iterator that ends mid-chunk stops the run after
    what arrived, through the final checkpoint.  Every rank resumes from
    the newest checkpoint of ``config.checkpoint_dir``; rank 0 alone
    saves checkpoints and prints the log while the others wait at a
    barrier.  Returns ``(state, MetricsLog)``, the same on every rank."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    first = next(batches)
    model.config = resolve_structured_prior(model.config, first["times"],
                                            first.get("mask"))
    if state is None:
        state = train_lib.create_train_state(model, config, mesh.device)
    lead = mesh.rank == 0
    ckpt = (train_lib.CheckpointManager(config.checkpoint_dir,
                                        config.keep_checkpoints)
            if config.checkpoint_dir else None)
    if ckpt is not None and ckpt.restore_latest(state) is not None \
            and verbose and lead:
        print(f"resumed from step {state.step}")
    state = replicate(state, mesh)

    def save():
        if lead:
            ckpt.save(state)
        dist.barrier()

    k = config.resolved_steps_per_call()
    multi = make_parallel_multi_step(config.beta, mesh)
    log = train_lib.MetricsLog()
    step = last_logged = state.step
    t_last = time.perf_counter()
    batch = first
    exhausted = False
    while step < config.num_steps:
        # the chunk clamped to the steps left; an iterator that ends
        # mid-chunk runs what arrived, then stops
        chunk = [batch]
        try:
            while len(chunk) < min(k, config.num_steps - step):
                chunk.append(next(batches))
        except StopIteration:
            exhausted = True
        state, metrics = multi(state, shard_batch_stack(chunk, mesh))
        took = len(chunk)
        step = state.step
        if step // config.log_every > last_logged // config.log_every or (
                step >= config.num_steps or exhausted):
            host = {key: train_lib.MetricsLog._host(v)
                    for key, v in metrics.items()}
            now = time.perf_counter()
            sps = (step - last_logged) / max(now - t_last, 1e-9)
            t_last, last_logged = now, step
            log.append(step, {**host, "steps_per_sec": sps})
            if verbose and lead:
                print(f"step {step}: loss={float(host['loss']):.4f} "
                      f"({sps:.1f} steps/s x {mesh.world_size} devices)")
        if ckpt is not None and not exhausted and (
                step % config.checkpoint_every < took
                and step >= config.checkpoint_every):
            # (when exhausted, the save after the loop covers this state)
            save()
        if exhausted:
            if verbose and lead:
                print(f"batches exhausted at step {step}; stopping")
            break
        if step < config.num_steps:
            try:
                batch = next(batches)
            except StopIteration:
                if verbose and lead:
                    print(f"batches exhausted at step {step}; stopping")
                break
    if ckpt is not None:
        save()
    return state, log
