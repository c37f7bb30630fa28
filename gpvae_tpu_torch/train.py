"""Training: the Adam step on the ELBO, metrics, checkpoints, and the
training loop.

Counterpart of ``gpvae_tpu/train.py:55-243`` (config, step, the
device-resident sampled loop, ``eval_step``), ``:250-300``
(``CheckpointManager``), ``:307-372`` (``MetricsLog``) and ``:375-519``
(``fit``).  PyTorch runs eagerly, so the JAX package's jitted
``lax.scan`` over ``k`` steps becomes a Python loop of steps whose work
is all queued on the device: from a ``Batcher`` the dataset lives on the
device, each step gathers its batch there from a row of a ``[k, B]``
index tensor, and the host waits for the device only at a log point, a
checkpoint or a callback; from any other iterator each batch is moved to
the device as it comes.  Checkpoints are ``torch.save`` files,
not the JAX package's orbax directories (weights cross from JAX through
``convert.load_flax_params``).
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
import warnings
from typing import Callable, Iterator

import numpy as np
import torch

from gpvae_tpu_torch import elbo as elbo_lib
from gpvae_tpu_torch.data.batching import Batcher
from gpvae_tpu_torch.models import GPVAE, resolve_structured_prior

_BATCH_KEYS = ("x", "times", "mask", "feature_mask")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4  # reference Adam lr, all scripts
    num_steps: int = 10_000
    beta: elbo_lib.BetaSchedule = elbo_lib.BetaSchedule()
    log_every: int = 500         # reference print cadence
    checkpoint_every: int = 25_000  # reference Saver cadence
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    model: GPVAE
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator  # posterior noise, on the model's device


def create_train_state(model: GPVAE, config: TrainConfig,
                       device: torch.device | str) -> TrainState:
    """Move ``model`` to ``device`` and pair it with Adam and a noise
    generator seeded from ``config.seed``."""
    device = torch.device(device)
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate)
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed + 1)
    return TrainState(model, optimizer, 0, generator)


def train_step(state: TrainState, batch: dict, beta: float, *,
               eps: torch.Tensor | None = None) -> dict:
    """One Adam step on the ELBO of ``batch`` (``x``, ``times``, ``mask``
    and, where the data has one, ``feature_mask``); returns the step's
    metrics as device tensors (reading them is the caller's choice of
    sync)."""
    model = state.model
    # lengthscale trajectories are a first-class observable (the
    # reference prints them every 500 steps); values before the update
    metrics = {
        "lengthscale_" + name.removesuffix("_log_ls"): torch.exp(p.detach())
        for name, p in model.named_parameters() if name.endswith("_log_ls")
    }
    out = model(batch["x"], batch["times"], batch["mask"], beta=beta,
                feature_mask=batch.get("feature_mask"), eps=eps,
                generator=state.generator)
    state.optimizer.zero_grad(set_to_none=True)
    out.loss.backward()
    state.optimizer.step()
    state.step += 1
    return {
        "loss": out.loss.detach(),
        "nll": out.nll.detach().mean(),
        "kl": out.kl.detach().mean(),
        "beta": beta,
        **metrics,
    }


@torch.no_grad()
def eval_step(model: GPVAE, batch: dict, *, beta: float = 1.0,
              eps: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> dict:
    """The ELBO of ``batch`` (``x``, ``times``, ``mask``) without a step
    (``train.py:234-243``): ``loss``, and ``nll`` and ``kl`` averaged over
    the batch, as device tensors.  The noise is ``eps`` (the layout of
    ``model.noise_shape``) or drawn from ``generator``."""
    out = model(batch["x"], batch["times"], batch["mask"], beta=beta,
                eps=eps, generator=generator)
    return {"loss": out.loss, "nll": out.nll.mean(), "kl": out.kl.mean()}


class CheckpointManager:
    """The last ``keep`` checkpoints of a run in ``directory``, one
    ``torch.save`` file per step, ``ckpt_<step>.pt``: the model's
    ``state_dict`` (parameters and buffers), Adam's state, the step and
    the noise generator's state.  ``restore_latest`` resumes a run
    exactly on the kind of device that saved it, and on another (a run
    trained on the card, scored on the CPU) restores all but the
    generator, whose state is device-specific."""

    _NAME = re.compile(r"ckpt_(\d+)\.pt")

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        found = (self._NAME.fullmatch(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.pt")

    def save(self, state: TrainState) -> str:
        """Write ``state`` (atomically: a reader sees all of a file or
        none) and drop all but the newest ``keep``; returns the path."""
        path = self._path(state.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step,
                    "generator": state.generator.get_state(),
                    "generator_device": state.generator.device.type}, tmp)
        os.replace(tmp, path)
        for step in self.steps()[:-self.keep]:
            os.remove(self._path(step))
        return path

    def restore_latest(self, state: TrainState, *,
                       optimizer: bool = True) -> TrainState | None:
        """Load the newest checkpoint into ``state``'s model, optimizer and
        generator (on their devices) and return it; None if there is
        none.  ``optimizer=False`` leaves the optimizer as it is: a model
        scored but not trained restores from a run whose optimizer held
        other parameters (a prior's lengthscales learned there, held fixed
        here)."""
        steps = self.steps()
        if not steps:
            return None
        payload = torch.load(self._path(steps[-1]), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        if optimizer:
            state.optimizer.load_state_dict(payload["optimizer"])
        if payload["generator_device"] == state.generator.device.type:
            state.generator.set_state(payload["generator"])
        state.step = int(payload["step"])
        return state


class MetricsLog:
    """In-memory metrics record + optional CSV, one column per scalar and
    per element of a vector metric (the lengthscale trajectories).  The
    header is fixed by the first appended row."""

    def __init__(self, csv_path: str | None = None):
        self.rows: list[dict] = []
        self._csv = csv_path
        self._columns: list[str] | None = None
        if csv_path:
            os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
            with open(csv_path, "w"):
                pass  # truncate; header written on first append

    @staticmethod
    def _host(v) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def append(self, step: int, metrics: dict):
        host = {k: self._host(v) for k, v in metrics.items()}
        row = {"step": step}
        flat = {"step": step}
        for k, arr in host.items():
            row[k] = arr.item() if arr.ndim == 0 else arr.tolist()
            if arr.ndim == 0:
                flat[k] = arr.item()
            else:
                for i, x in enumerate(arr.reshape(-1)):
                    flat[f"{k}_{i}"] = float(x)
        self.rows.append(row)
        if not self._csv:
            return
        if self._columns is None:
            head = [c for c in ("step", "loss", "nll", "kl", "beta")
                    if c in flat]
            self._columns = head + sorted(c for c in flat if c not in head)
            with open(self._csv, "a") as f:
                f.write(",".join(self._columns) + "\n")
        extra = set(flat) - set(self._columns)
        if extra:
            warnings.warn(
                f"MetricsLog: metric keys {sorted(extra)} appeared after the "
                f"CSV header was written and are dropped from {self._csv} "
                f"(present in .rows)",
                stacklevel=2,
            )
        with open(self._csv, "a") as f:
            f.write(",".join(str(flat.get(c, "")) for c in self._columns)
                    + "\n")


def device_arrays(arrays: dict, device: torch.device) -> dict:
    """The batch arrays (numpy arrays or tensors) of a dataset as tensors
    on ``device``: ``x`` and ``times`` float32, ``mask`` bool, and
    ``feature_mask`` (bool) where the dataset has one: without it the
    likelihood would train the model to predict the zero fill of missing
    features (``train.py:505-518``)."""
    dtypes = {"x": torch.float32, "times": torch.float32, "mask": torch.bool,
              "feature_mask": torch.bool}

    def tensor(v):
        return torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v))

    return {
        key: tensor(arrays[key]).to(device=device, dtype=dtypes[key])
        for key in _BATCH_KEYS if arrays.get(key) is not None
    }


def _stage_indices(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(idx)
    if device.type == "cuda":
        # pinned, so the copy is queued on the stream and the host does
        # not wait for the steps already in flight
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _train_loop(state: TrainState, batches, config: TrainConfig,
                ckpt, log: MetricsLog, callbacks, verbose: bool) -> None:
    """Steps ``state`` to ``config.num_steps`` on the device batches that
    ``batches(n)`` yields (``n`` steps' worth, one log window at a time),
    with the checkpoints, log rows and callbacks of :func:`fit`."""
    step = state.step
    t_last = time.perf_counter()
    while step < config.num_steps:
        # one window runs up to the next log point, which is its only sync
        # (a checkpoint or a callback reads the device too)
        stop = min((step // config.log_every + 1) * config.log_every,
                   config.num_steps)
        n = stop - step
        for batch in batches(n):
            metrics = train_step(state, batch, config.beta(step))
            step += 1
            if ckpt is not None and step % config.checkpoint_every == 0:
                ckpt.save(state)
            for every, fn in callbacks or ():
                if step % every == 0:
                    fn(state, step)
        host = {name: MetricsLog._host(v) for name, v in metrics.items()}
        now = time.perf_counter()
        sps = n / max(now - t_last, 1e-9)
        t_last = now
        log.append(step, {**host, "steps_per_sec": sps})
        if verbose:
            print(
                f"step {step}: loss={float(host['loss']):.4f} "
                f"nll={float(host['nll']):.4f} "
                f"kl={float(host['kl']):.4f} "
                f"beta={float(host['beta']):.2e} ({sps:.1f} steps/s)"
            )


def fit(
    model: GPVAE,
    batches: Batcher | Iterator[dict],
    config: TrainConfig,
    *,
    device: torch.device | str = "cuda",
    state: TrainState | None = None,
    csv_path: str | None = None,
    verbose: bool = True,
    callbacks: list[tuple[int, Callable[[TrainState, int], None]]]
    | None = None,
) -> tuple[TrainState, MetricsLog]:
    """Train ``model`` for ``config.num_steps`` on a :class:`Batcher` or
    any iterator of batch dicts (numpy arrays or tensors: ``x``,
    ``times``, ``mask`` and, where the data has one, ``feature_mask``).

    A Batcher's arrays are staged on ``device`` once; each step gathers
    its batch on the device from the Batcher's index stream (same wrap and
    reshuffle semantics as iterating it).  Another iterator's batches are
    moved to ``device`` one a step, and no batch is taken past the last
    step.  The host reads the device only at each log point (every
    ``config.log_every`` steps and at the end), checkpoint and callback.
    Pass ``state`` to continue a run.  With ``config.checkpoint_dir`` the
    run resumes from the newest checkpoint there, saves one every
    ``config.checkpoint_every`` steps and one at the end.  ``callbacks``
    are ``(every, fn(state, step))`` pairs, each called after every
    ``every``-th step (``train.py:375-392``: the home of periodic artifact
    dumps, ``analysis.make_artifact_callback``).  The model's
    ``structured_prior`` is first resolved against the first batch
    (``models.resolve_structured_prior``, ``train.py:412-415``).
    """
    sampler = batches if isinstance(batches, Batcher) else None
    if sampler is not None:
        first = {key: v[:sampler.batch_size]
                 for key, v in sampler.arrays.items()}
    else:
        first = next(batches)
    model.config = resolve_structured_prior(model.config, first["times"],
                                            first.get("mask"))
    device = torch.device(device)
    if state is None:
        state = create_train_state(model, config, device)
    ckpt = (CheckpointManager(config.checkpoint_dir, config.keep_checkpoints)
            if config.checkpoint_dir else None)
    if ckpt is not None and ckpt.restore_latest(state) is not None \
            and verbose:
        print(f"resumed from step {state.step}")
    if sampler is not None:
        dev = device_arrays(sampler.arrays, device)

        def window(n):
            # the window's indices cross to the device in one copy
            idx = _stage_indices(
                np.stack([sampler.next_indices() for _ in range(n)]), device)
            for row in idx:
                yield {key: v.index_select(0, row) for key, v in dev.items()}
    else:
        pending = [first]

        def window(n):
            for i in range(n):
                # the first batch was read above; the rest are taken as
                # they are needed, so a finite iterator may end at the
                # last step
                batch = pending.pop() if pending else next(batches)
                yield device_arrays(batch, device)

    log = MetricsLog(csv_path)
    _train_loop(state, window, config, ckpt, log, callbacks, verbose)
    if ckpt is not None:
        ckpt.save(state)
    return state, log
