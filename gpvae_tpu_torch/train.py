"""Training: the Adam step on the ELBO, metrics, checkpoints, and the
training loop.

Counterpart of ``gpvae_tpu/train.py:55-243`` (config, the step and its
k-step forms, ``eval_step``), ``:250-300`` (``CheckpointManager``),
``:307-372`` (``MetricsLog``) and ``:375-519`` (``fit``).  PyTorch runs
eagerly, so the JAX package's jitted ``lax.scan`` over ``k`` steps
becomes a Python loop of ``k`` steps whose work is all queued on the
device (:func:`make_multi_step`, :func:`make_sampled_multi_step`): from a
``Batcher`` the dataset lives on the device and each step gathers its
batch there from a row of a ``[k, B]`` index tensor; from any other
iterator ``k`` batches are stacked and moved to the device in one copy.
The host waits for the device only at a log point, a checkpoint or a
callback.  Checkpoints are ``torch.save`` files, not the JAX package's
orbax directories (weights cross from JAX through
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
from gpvae_tpu_torch.utils.profiling import span, spanned

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
    # optimizer steps a call of the k-step functions; fit's loop may
    # overshoot num_steps by up to k - 1 steps.  None resolves to 1 (see
    # resolved_steps_per_call).
    steps_per_call: int | None = None

    def resolved_steps_per_call(self, device_resident: bool = False) -> int:
        """``k``: an explicit ``steps_per_call`` as given (at least 1), and
        for ``None`` 1 on every device (the JAX package's automatic value
        off the TPU; its cap at the run and the log cadence,
        ``train.py:75-83``, leaves 1 as it is).  A deliberate divergence:
        the JAX package picks 256 on a TPU for a device-resident dataset
        and 16 for staged batches, which buy it one dispatch for ``k``
        steps; the port's ``k`` steps are a Python loop that buys none, so
        a larger default would only overshoot ``num_steps``.  A CUDA
        default comes with the ``k`` steps captured in one CUDA graph,
        from that change's measurements.  ``device_resident`` is kept for
        the JAX package's signature."""
        if self.steps_per_call is not None:
            return max(1, self.steps_per_call)
        return 1


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


@spanned("gpvae.step", device=True)
def train_step(state: TrainState, batch: dict, beta: float, *,
               eps: torch.Tensor | None = None,
               before_update: Callable[[], None] | None = None) -> dict:
    """One Adam step on the ELBO of ``batch`` (``x``, ``times``, ``mask``
    and, where the data has one, ``feature_mask``); returns the step's
    metrics as device tensors (reading them is the caller's choice of
    sync).  The noise is ``eps`` when given, else drawn from the state's
    generator; ``before_update`` runs between the backward and Adam (the
    data-parallel step's gradient all-reduce)."""
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
    with span("gpvae.step.backward", device=True):
        out.loss.backward()
    if before_update is not None:
        before_update()
    state.optimizer.step()
    state.step += 1
    return {
        "loss": out.loss.detach(),
        "nll": out.nll.detach().mean(),
        "kl": out.kl.detach().mean(),
        "beta": beta,
        **metrics,
    }


def make_train_step(beta_schedule: elbo_lib.BetaSchedule
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """One step as a callable ``(state, batch) -> (state, metrics)``
    (``train.py:155-165``): :func:`train_step` with β from
    ``beta_schedule`` at the state's step, read on the host.  The state is
    updated in place and returned; ``batch`` holds device tensors
    (:func:`device_arrays`)."""
    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        return state, train_step(state, batch, beta_schedule(state.step))

    return step


def make_multi_step(beta_schedule: elbo_lib.BetaSchedule, num_steps: int
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``num_steps`` steps a call over a super-batch whose tensors carry a
    leading ``[num_steps]`` axis (``train.py:168-187``: the JAX package's
    ``lax.scan``, here a loop whose work is all queued on the device);
    returns the state and the last step's metrics."""
    step = make_train_step(beta_schedule)

    def run(state: TrainState, batches: dict) -> tuple[TrainState, dict]:
        for key, v in batches.items():
            if v.shape[0] != num_steps:
                raise ValueError(f"{key!r} holds {v.shape[0]} batches, not "
                                 f"{num_steps}")
        for i in range(num_steps):
            state, metrics = step(state, {key: v[i]
                                          for key, v in batches.items()})
        return state, metrics

    return run


def make_sampled_multi_step(beta_schedule: elbo_lib.BetaSchedule,
                            arrays: dict, device: torch.device | str
                            ) -> Callable[[TrainState, torch.Tensor],
                                          tuple[TrainState, dict]]:
    """Steps over a device-resident dataset (``train.py:190-231``).  The
    batch arrays of ``arrays`` are staged on ``device`` once; each call
    takes only an ``idx [k, B]`` index tensor on the device, gathers each
    step's batch there and runs ``k`` steps, so the host copies nothing
    but the indices.  Returns the state and the last step's metrics."""
    dev = device_arrays(arrays, torch.device(device))
    step = make_train_step(beta_schedule)

    def run(state: TrainState, idx: torch.Tensor) -> tuple[TrainState, dict]:
        for row in idx:
            state, metrics = step(state, {key: v.index_select(0, row)
                                          for key, v in dev.items()})
        return state, metrics

    return run


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


def stack_batches(chunk: list[dict], device: torch.device) -> dict:
    """``k`` batch dicts (numpy arrays or tensors) as ``[k, B, ...]``
    tensors on ``device``, one copy a key: the operand of
    :func:`make_multi_step`."""
    keys = [key for key in _BATCH_KEYS if chunk[0].get(key) is not None]
    return device_arrays({key: torch.stack([torch.as_tensor(c[key])
                                            for c in chunk])
                          for key in keys}, device)


def _stage_indices(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(idx)
    if device.type == "cuda":
        # pinned, so the copy is queued on the stream and the host does
        # not wait for the steps already in flight
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _index_window(sampler: Batcher, k: int, step: int, config: TrainConfig,
                  device: torch.device):
    """The ``[k, B]`` index tensors of the calls from ``step`` to the next
    log point (the first call that crosses a ``log_every`` boundary or
    ends the run), drawn from ``sampler``'s stream in order and copied to
    the device at once."""
    stop = min((step // config.log_every + 1) * config.log_every,
               config.num_steps)
    calls = -(-(stop - step) // k)
    idx = np.stack([sampler.next_indices() for _ in range(calls * k)])
    return iter(_stage_indices(idx, device).view(calls, k, -1))


@spanned("gpvae.fit")
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
    ``times``, ``mask`` and, where the data has one, ``feature_mask``), in
    calls of ``k = config.resolved_steps_per_call()`` steps, with the JAX
    package's semantics (``train.py:375-505``).

    A Batcher's arrays are staged on ``device`` once and each call takes
    ``k`` rows of its index stream (:func:`make_sampled_multi_step`; the
    stream is consumed exactly as at ``k = 1``, the indices of a log
    window copied at once).  Another iterator's batches are stacked ``k``
    a call and moved to ``device`` in one copy (:func:`make_multi_step`);
    no batch is taken past the last call.  Steps count in calls of ``k``,
    so the run may end up to ``k - 1`` steps past ``num_steps``.  A row
    of the last step's metrics is logged when a call crosses a
    ``config.log_every`` boundary or ends the run: the host reads the
    device only there and at checkpoints and callbacks.  Pass ``state``
    to continue a run.  With ``config.checkpoint_dir`` the run resumes
    from the newest checkpoint there, saves one after each call that
    reaches a multiple of ``config.checkpoint_every`` (``step % every <
    k``) and one after the loop.  ``callbacks`` are ``(every, fn(state,
    step))`` pairs, called on the same rule (``train.py:375-392``: the
    home of periodic artifact dumps, ``analysis.make_artifact_callback``).
    The model's ``structured_prior`` is first resolved against the first
    batch (``models.resolve_structured_prior``, ``train.py:412-415``).
    """
    sampler = batches if isinstance(batches, Batcher) else None
    k = config.resolved_steps_per_call(device_resident=sampler is not None)
    if sampler is not None:
        # init from the arrays without consuming the index stream
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
        with span("gpvae.fit.stage"):
            multi = make_sampled_multi_step(config.beta, sampler.arrays,
                                            device)
    else:
        multi = make_multi_step(config.beta, k)
    log = MetricsLog(csv_path)
    every = config.log_every
    last_logged = state.step
    t_last = time.perf_counter()
    window = iter(())
    batch = first
    while state.step < config.num_steps:
        if sampler is not None:
            idx = next(window, None)
            if idx is None:
                with span("gpvae.fit.indices"):
                    window = _index_window(sampler, k, state.step, config,
                                           device)
                idx = next(window)
            state, metrics = multi(state, idx)
        else:
            chunk = [batch] + [next(batches) for _ in range(k - 1)]
            with span("gpvae.fit.stage"):
                staged = stack_batches(chunk, device)
            state, metrics = multi(state, staged)
        step = state.step
        if step // every > last_logged // every or step >= config.num_steps:
            with span("gpvae.fit.log"):
                host = {name: MetricsLog._host(v)
                        for name, v in metrics.items()}
            now = time.perf_counter()
            sps = (step - last_logged) / max(now - t_last, 1e-9)
            t_last, last_logged = now, step
            log.append(step, {**host, "steps_per_sec": sps})
            if verbose:
                print(
                    f"step {step}: loss={float(host['loss']):.4f} "
                    f"nll={float(host['nll']):.4f} "
                    f"kl={float(host['kl']):.4f} "
                    f"beta={float(host['beta']):.2e} ({sps:.1f} steps/s)"
                )
        if ckpt is not None and (step % config.checkpoint_every < k
                                 and step >= config.checkpoint_every):
            ckpt.save(state)
        for n, fn in callbacks or ():
            if step % n < k and step >= n:
                fn(state, step)
        if step < config.num_steps and sampler is None:
            # only when another call runs: a finite iterator may end at
            # the last step
            batch = next(batches)
    if ckpt is not None:
        ckpt.save(state)
    return state, log
