"""Profile training steps of a preset and print one JSON line.

    python -m gpvae_tpu_torch.profile_step [--preset bench_t100]
        [--time-len 1024] [--batch 32] [--steps 3] [--device cuda]

Trains the preset's model (random weights from seed 0, toy data from seed
0) for two warm-up steps, then profiles ``--steps`` steps of
``train.train_step`` under ``torch.profiler`` with the input shapes
recorded, and runs one more step to read the allocator's peak.  The line
holds, per step: the card's time (the summed durations of its kernels),
the kernel count, the kernels that took most of it; every operator that
ran on a tensor of the factor bank's shape, ``[B, Z, T, T]`` or ``[B, 2Z,
T, T]``, with its calls and its own device and host time; each of the
port's spans (``utils.profiling.span``: ``gpvae.step``, its
``gpvae.factor``, ``gpvae.kl`` and ``gpvae.step.backward``) with its
calls, its host time less its children's and its device interval
(None where the span records none); and the peak of allocated memory
above what was allocated before the step.  With ``--device cpu`` the
device times are zero, and the spans' None.

It reads nothing from the package that a user's training step does not
run, so the same file profiles another checkout of the package when it
is copied there; a checkout without ``utils.profiling.spans`` gives no
span table.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from gpvae_tpu_torch import configs, train
from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch
from gpvae_tpu_torch.models import GPVAE
from gpvae_tpu_torch.utils import profiling


def _card_line() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span_table(records: list, steps: int) -> dict:
    """Per span name, per step: ``calls``, ``host_self_ms`` (each span's
    host time less its children's) and ``device_ms`` (None where a span
    recorded no device interval)."""
    children: dict[int, float] = {}
    for r in records:
        if r.parent is not None:
            children[r.parent] = children.get(r.parent, 0.0) + r.host_ms
    table: dict[str, dict] = {}
    for r in records:
        row = table.setdefault(r.name, {"calls": 0.0, "host_self_ms": 0.0,
                                        "device_ms": 0.0})
        row["calls"] += 1 / steps
        row["host_self_ms"] += (r.host_ms - children.get(r.id, 0.0)) / steps
        if r.device_ms is None or row["device_ms"] is None:
            row["device_ms"] = None
        else:
            row["device_ms"] += r.device_ms / steps
    return table


def profile_steps(preset_name: str, t: int, b: int, steps: int,
                  device: torch.device) -> dict:
    preset = configs.get(preset_name)
    cfg = dataclasses.replace(preset.model, time_len=t)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, train.TrainConfig(), device)
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(0),
                                                 b, t=t))
    batch = train.device_arrays(data, device)
    beta = preset.train.beta(0)

    def step():
        train.train_step(state, batch, beta)

    for _ in range(2):
        step()
    _sync(device)
    traces = []
    read_spans = getattr(profiling, "spans", None)
    if read_spans is not None:
        profiling.clear_spans()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    # a dropped warm-up cycle first: without it the trace loses the first
    # launches of a window
    with profile(activities=activities, record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(
                     (list(p.events()),
                      p.key_averages(group_by_input_shape=True)))) as prof:
        for _ in range(2):
            for _ in range(steps):
                step()
            _sync(device)
            prof.step()
    events, averages = traces[0]
    spans = (span_table(read_spans(), steps) if read_spans is not None
             else None)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    z = cfg.latent_dim
    bank_shapes = ([b, z, t, t], [b, 2 * z, t, t])
    bank_ops = []
    for a in averages:
        if any(list(s) in bank_shapes for s in a.input_shapes):
            bank_ops.append({
                "op": a.key, "shapes": [list(s) for s in a.input_shapes],
                "calls_per_step": a.count / steps,
                "self_device_ms_per_step": a.self_device_time_total
                / steps / 1e3,
                "self_host_ms_per_step": a.self_cpu_time_total / steps / 1e3})
    bank_ops.sort(key=lambda r: -r["self_device_ms_per_step"])
    peak = None
    if device.type == "cuda":
        _sync(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        step()
        _sync(device)
        peak = (torch.cuda.max_memory_allocated(device) - before) / 2 ** 30
    return {
        "preset": preset_name, "time_len": t, "batch": b,
        "steps_profiled": steps, "device": str(device),
        "card": _card_line() if device.type == "cuda" else None,
        "device_ms_per_step": sum(by_name.values()) / steps / 1e3,
        "kernels_per_step": len(kernels) / steps,
        "top_kernels_ms_per_step": [
            (n[:100], us / steps / 1e3) for n, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]],
        "bank_ops": bank_ops,
        "spans_per_step": spans,
        "step_peak_gib_above_start": peak,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="bench_t100")
    ap.add_argument("--time-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device (use --device cpu)")
    print(json.dumps(profile_steps(args.preset, args.time_len, args.batch,
                                   args.steps, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
