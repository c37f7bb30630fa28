"""Traffic kind ``train``: the port's training loop, ``train.fit`` over a
``Batcher`` of a pool of toy sequences, continuing one ``TrainState`` in
chunks of ``chunk_steps`` steps, each chunk ended at ``fit``'s own log
point (the host reads the loss).

Set-up builds the one training state from the seed and drives it through
its first ``check_steps`` steps with the same ``fit`` and the same feed;
the window continues that state.  Those first steps, on rows that all
differ, are what the plain reference follows once the window has closed:
each step's loss, the norm of each parameter's first gradient as Adam got
it (from Adam's first moment after one step), and the norm of each
parameter's change over the steps, compared at the median parameter.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from portbench import inputs
from portbench.harness import RunError, model_config
from portbench.reference import gpvae as ref


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def leaf_gaps(prog: dict, refv: dict, names) -> list[float]:
    """Each leaf's gap of norms: ``| ||prog|| - ||ref|| |`` against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    norms = {n: float(refv[n].double().norm()) for n in names}
    median = float(np.median(list(norms.values())))
    gaps = []
    for n in names:
        p = prog.get(n)
        pn = float(p.double().norm()) if p is not None else 0.0
        gaps.append(abs(pn - norms[n]) / max(norms[n], median))
    return gaps


def leaf_gap(prog: dict, refv: dict, names) -> float:
    """The worst leaf's gap of norms."""
    return max(leaf_gaps(prog, refv, names), default=float("nan"))


def median_leaf_gap(prog: dict, refv: dict, names) -> float:
    """The median leaf's gap of norms."""
    gaps = leaf_gaps(prog, refv, names)
    return float(np.median(gaps)) if gaps else float("nan")


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from gpvae_tpu_torch import train as train_lib
        from gpvae_tpu_torch.data import Batcher
        from gpvae_tpu_torch.models import GPVAE

        self.cfg, self.mix, self.device = cell.config, cell.mix, device
        t0 = time.monotonic()
        mc, preset = model_config(cell)
        self.batch = b = self.cfg["batch_size"]
        mix = self.mix
        if mix["check_steps"] * b > mix["pool"]:
            raise RunError(f"{cell.name}: the checked steps need "
                           f"{mix['check_steps'] * b} distinct rows, the "
                           f"pool holds {mix['pool']}")
        data = inputs.toy_sequences(
            inputs.generator(seed, device, 2), mix["pool"], mix["time_len"],
            xmax=mix["xmax"], hide_fraction=mix["hide_fraction"],
            obs_dim=self.cfg["model"]["obs_dim"])
        self.host = {k: v.cpu().numpy() for k, v in data.items()}
        del data
        t1 = time.monotonic()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.weights = inputs.weights(self.cfg, seed, device)
        model = GPVAE(mc)
        model.load_state_dict(self.weights, strict=True)
        model.to(device)
        self.tcfg = train_lib.TrainConfig(
            learning_rate=preset.train.learning_rate, beta=preset.train.beta,
            num_steps=1, log_every=1)
        state = train_lib.create_train_state(model, self.tcfg, device)
        state.generator.manual_seed(inputs.stream_seed(seed, 3))
        self.noise_state = state.generator.get_state()
        self.batcher = Batcher(self.host, b, seed=seed)
        self.order = np.arange(mix["pool"])
        np.random.default_rng(seed).shuffle(self.order)
        self.fit, self.state = train_lib.fit, state
        t2 = time.monotonic()
        # the first steps, through the window's own call and feed
        opt = state.optimizer
        by_param = {id(p): n for n, p in model.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        rows = self._fit(1, 1).rows
        self.grad1 = {by_param[id(p)]: (s["exp_avg"] / (1.0 - beta1)).detach().cpu()
                      for p, s in opt.state.items()}
        rows += self._fit(mix["check_steps"] - 1, 1).rows
        self.losses = [float(r["loss"]) for r in rows]
        self.params = {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()}
        self.steps_checked = len(self.losses)
        self.phases = {"data": t1 - t0, "model": t2 - t1,
                       "first_steps": time.monotonic() - t2}

    def _fit(self, steps: int, log_every: int):
        cfg = dataclasses.replace(self.tcfg, num_steps=self.state.step + steps,
                                  log_every=log_every)
        _, log = self.fit(self.state.model, self.batcher, cfg,
                          device=self.device, state=self.state, verbose=False)
        return log

    def _chunk(self) -> tuple[int, bool]:
        k = self.mix["chunk_steps"]
        log = self._fit(k, k)
        return k, all(math.isfinite(float(r["loss"])) for r in log.rows)

    def window(self, seconds: float) -> dict:
        """Chunks until ``seconds`` have passed: the sequences of every
        completed step over the whole window's time."""
        steps = failed = 0
        chunks = []
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            k, finite = self._chunk()
            chunks.append(time.perf_counter() - t1)
            steps += k
            failed += 0 if finite else k
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"metrics": {"train_seqs_per_s": steps * self.batch / wall},
                "attempted": steps, "failed": failed, "units": steps,
                "seconds": wall,
                "detail": {"chunk_s": [chunks[0], min(chunks),
                                       float(np.median(chunks)), max(chunks)]}}

    def stretch(self) -> int:
        """One chunk, for the profiler."""
        k, _ = self._chunk()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return k

    def release(self) -> None:
        del self.state, self.batcher, self.fit
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self) -> tuple[list, list]:
        """The checked steps' batches (the Batcher's first rows, all
        different) and their noise, redrawn from the generator's state."""
        b, dev = self.batch, self.device
        batches = []
        for s in range(self.steps_checked):
            idx = self.order[s * b:(s + 1) * b]
            batches.append({k: torch.from_numpy(v[idx]).to(dev)
                            for k, v in self.host.items()})
        g = torch.Generator(device=dev)
        g.set_state(self.noise_state)
        z, t = self.cfg["model"]["latent_dim"], self.mix["time_len"]
        noise = [torch.randn((1, b, z, t), generator=g, dtype=torch.float32,
                             device=dev) for _ in batches]
        return batches, noise

    def check(self, against: dict | None = None) -> dict:
        """The readings: the program's first steps against the plain
        reference's (``against``: another run's outputs in the program's
        place, for the control)."""
        batches, noise = self.reference_inputs()
        want = ref.train(self.cfg, self.weights, batches, noise, ref.FLOAT64)
        got = against if against is not None else {
            "loss": self.losses, "grad1": self.grad1, "params": self.params}
        names = list(want["params"])
        start = {n: self.weights[n].double().cpu() for n in names}
        grads = {n: want["grad1"][n].cpu() for n in names}
        g_norms = {n: float(grads[n].norm()) for n in names}
        g_median = float(np.median(list(g_norms.values())))
        moved = [n for n in names if g_norms[n] >= 1e-3 * g_median]
        d_want = {n: want["params"][n].cpu() - start[n] for n in names}
        d_got = {n: got["params"][n].double().cpu() - start[n]
                 for n in names if n in got["params"]}
        return {
            "loss_gap": max(relative_gap(a, b) for a, b in
                            zip(got["loss"], want["loss"])),
            "grad_gap": leaf_gap({n: v.cpu() for n, v in got["grad1"].items()},
                                 grads, names),
            # the worst leaf's change, not compared: an element whose first
            # gradient is nought to float32 rounding can take either sign,
            # and Adam moves it a full step either way
            "update_gap": leaf_gap(d_got, d_want, moved),
            "update_gap_median": median_leaf_gap(d_got, d_want, moved),
        }
