"""Training: the Adam step on the ELBO, metrics, and the training loop.

Counterpart of ``gpvae_tpu/train.py:55-232`` (config, step, the
device-resident sampled loop), ``:307-372`` (``MetricsLog``) and
``:375-519`` (``fit``).  PyTorch runs eagerly, so the JAX package's jitted
``lax.scan`` over ``k`` steps becomes a Python loop of steps whose work is
all queued on the device: the dataset lives on the device, each step
gathers its batch there from a row of a ``[k, B]`` index tensor, and the
host waits for the device only at a log point.  Checkpoints are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from gpvae_tpu_torch import elbo as elbo_lib
from gpvae_tpu_torch.data.batching import Batcher
from gpvae_tpu_torch.models import GPVAE

_BATCH_KEYS = ("x", "times", "mask")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4  # reference Adam lr, all scripts
    num_steps: int = 10_000
    beta: elbo_lib.BetaSchedule = elbo_lib.BetaSchedule()
    log_every: int = 500         # reference print cadence
    checkpoint_dir: str | None = None  # not ported yet: fit raises
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
    """One Adam step on the ELBO of ``batch``; returns the step's metrics
    as device tensors (reading them is the caller's choice of sync)."""
    model = state.model
    # lengthscale trajectories are a first-class observable (the
    # reference prints them every 500 steps); values before the update
    metrics = {
        "lengthscale_" + name.removesuffix("_log_ls"): torch.exp(p.detach())
        for name, p in model.named_parameters() if name.endswith("_log_ls")
    }
    out = model(batch["x"], batch["times"], batch["mask"], beta=beta,
                eps=eps, generator=state.generator)
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
    """The batch arrays of a dataset as tensors on ``device``: ``x`` and
    ``times`` float32, ``mask`` bool."""
    dtypes = {"x": torch.float32, "times": torch.float32, "mask": torch.bool}
    return {
        key: torch.as_tensor(np.asarray(arrays[key])).to(
            device=device, dtype=dtypes[key])
        for key in _BATCH_KEYS
    }


def _stage_indices(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(idx)
    if device.type == "cuda":
        # pinned, so the copy is queued on the stream and the host does
        # not wait for the steps already in flight
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fit(
    model: GPVAE,
    batches: Batcher,
    config: TrainConfig,
    *,
    device: torch.device | str = "cuda",
    state: TrainState | None = None,
    csv_path: str | None = None,
    verbose: bool = True,
) -> tuple[TrainState, MetricsLog]:
    """Train ``model`` on a :class:`Batcher` for ``config.num_steps``.

    The Batcher's arrays are staged on ``device`` once; each step gathers
    its batch on the device from the Batcher's index stream (same wrap and
    reshuffle semantics as iterating it).  The host reads the device only
    at each log point (every ``config.log_every`` steps and at the end).
    Pass ``state`` to continue a run.
    """
    if not isinstance(batches, Batcher):
        raise TypeError("fit takes a gpvae_tpu_torch.data.Batcher")
    if config.checkpoint_dir:
        raise NotImplementedError("checkpoints: ROADMAP queue A item 6")
    device = torch.device(device)
    if state is None:
        state = create_train_state(model, config, device)
    dev = device_arrays(batches.arrays, device)
    log = MetricsLog(csv_path)
    step = state.step
    t_last = time.perf_counter()
    while step < config.num_steps:
        # one window runs up to the next log point; its indices cross to
        # the device in one copy, and the log point is its only sync
        stop = min((step // config.log_every + 1) * config.log_every,
                   config.num_steps)
        idx = _stage_indices(
            np.stack([batches.next_indices() for _ in range(stop - step)]),
            device)
        for row in idx:
            batch = {key: v.index_select(0, row) for key, v in dev.items()}
            metrics = train_step(state, batch, config.beta(step))
            step += 1
        host = {name: MetricsLog._host(v) for name, v in metrics.items()}
        now = time.perf_counter()
        sps = len(idx) / max(now - t_last, 1e-9)
        t_last = now
        log.append(step, {**host, "steps_per_sec": sps})
        if verbose:
            print(
                f"step {step}: loss={float(host['loss']):.4f} "
                f"nll={float(host['nll']):.4f} "
                f"kl={float(host['kl']):.4f} "
                f"beta={float(host['beta']):.2e} ({sps:.1f} steps/s)"
            )
    return state, log
