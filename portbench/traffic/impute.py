"""Traffic kind ``impute``: one client calls ``analysis.impute`` back to
back, each call on one of ``pool_calls`` batches of ``seqs_per_call``
toy sequences staged on the card in set-up, half (``drop_fraction``) of
each batch's observed steps dropped.  A call ends when the host holds its
imputed probabilities and latents; its latency runs from its start to
then.

Once the window has closed, a sample of ``checked_calls`` of its calls,
drawn from the seed, is held against the plain reference: the posterior
mean at the dropped steps, and the decoded probabilities.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import inputs
from portbench.harness import model_config
from portbench.reference import gpvae as ref


def p95(values: list[float]) -> float:
    """The 95th percentile, by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        from gpvae_tpu_torch import analysis
        from gpvae_tpu_torch.models import GPVAE

        self.cfg, self.mix, self.device = cell.config, cell.mix, device
        t0 = time.monotonic()
        mc, _ = model_config(cell)
        mix = self.mix
        self.b = b = mix["seqs_per_call"]
        self.pool = mix["pool_calls"]
        data = inputs.toy_sequences(
            inputs.generator(seed, device, 2), self.pool * b, mix["time_len"],
            xmax=mix["xmax"], hide_fraction=mix["hide_fraction"],
            obs_dim=self.cfg["model"]["obs_dim"])
        data["kept"] = inputs.dropped(inputs.generator(seed, device, 4),
                                      data["mask"], mix["drop_fraction"])
        t1 = time.monotonic()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.batches = [{k: v[c * b:(c + 1) * b] for k, v in data.items()}
                        for c in range(self.pool)]
        self.weights = inputs.weights(self.cfg, seed, device)
        model = GPVAE(mc)
        model.load_state_dict(self.weights, strict=True)
        self.model = model.to(device)
        self.impute = analysis.impute
        self.rng = np.random.default_rng(seed)
        self.calls = 0
        self.sample: list[tuple[int, dict]] = []
        t2 = time.monotonic()
        self.call(0)                       # the one shape this mix uses
        self.phases = {"data": t1 - t0, "model": t2 - t1,
                       "warm": time.monotonic() - t2}

    def call(self, c: int) -> dict:
        """One call on batch ``c``: the imputed probabilities and latents,
        held by the host."""
        bt = self.batches[c]
        probs, z, _ = self.impute(self.model, bt["x"], bt["times"],
                                  bt["mask"], bt["kept"])
        return {"probs": probs.cpu(), "z": z.cpu()}

    def _keep(self, c: int, out: dict) -> None:
        """A uniform sample of the window's calls, drawn from the seed
        (reservoir sampling)."""
        k = self.mix["checked_calls"]
        if len(self.sample) < k:
            self.sample.append((c, out))
        else:
            j = int(self.rng.integers(0, self.calls))
            if j < k:
                self.sample[j] = (c, out)

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed.  A call that raises counts
        as failed; a sampled call whose answer is not finite fails the
        check."""
        lat, failed = [], 0
        t0 = time.perf_counter()
        while True:
            c = self.calls % self.pool
            t1 = time.perf_counter()
            try:
                out = self.call(c)
            except RuntimeError:
                failed, out = failed + 1, None
            lat.append(time.perf_counter() - t1)
            self.calls += 1
            if out is not None:
                self._keep(c, out)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        n = len(lat)
        s = sorted(lat)
        return {"metrics": {"impute_seqs_per_s": n * self.b / wall,
                            "impute_ms_p95": 1e3 * p95(lat)},
                "attempted": n, "failed": failed, "units": n,
                "seconds": wall,
                "detail": {"latency_ms": [1e3 * v for v in (
                    lat[0], s[0], s[n // 2], s[-1])],
                    "between_calls_ms": 1e3 * (wall - sum(lat)) / n,
                    "slowest_ms": [1e3 * v for v in s[-5:]]}}

    def stretch(self) -> int:
        n = self.mix["profiled_calls"]
        for i in range(n):
            self.call(i % self.pool)
        return n

    def release(self) -> None:
        del self.model, self.impute
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, against: dict | None = None) -> dict:
        """The readings: each sampled call's answer against the plain
        reference's for its batch (``against``: answers by batch in the
        program's place, for the control)."""
        want: dict[int, dict] = {}
        mean_gap = probs_gap = 0.0
        for c, out in self.sample:
            if c not in want:
                bt = self.batches[c]
                r = ref.impute(self.cfg, self.weights, bt, bt["kept"])
                want[c] = {k: v.cpu() for k, v in r.items()}
            if against is not None:
                out = against[c]
            bt = self.batches[c]
            drop = (bt["mask"] & ~bt["kept"]).cpu()
            zw, zg = want[c]["z"][drop], out["z"].double()[drop]
            scale = float(zw.abs().max()) if zw.numel() else 1.0
            mean_gap = max(mean_gap, float((zg - zw).abs().max()) / scale
                           if zw.numel() else 0.0)
            probs_gap = max(probs_gap, float(
                (out["probs"].double() - want[c]["probs"]).abs().max()))
        return {"mean_gap": mean_gap, "probs_gap": probs_gap}
