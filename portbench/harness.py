"""The benchmark's driver: one cell of ``BENCHMARK.json``, one seed, one
run, one JSON line.

A cell is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``), whose ``kind`` names its generator
(``traffic/<kind>.py``); its per-layer metrics are readers
``metrics/<metric>.py``, its operation counts ``counts/<config>.py``.
Adding a cell, a configuration, a mix or a metric adds files; no file here
changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PACKAGE = "gpvae_tpu_torch"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "gpvae_tpu")


class RunError(RuntimeError):
    """A run that must end without a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark's own folders, by file path (names of
    cells and metrics hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise RunError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    benchmark: dict

    @property
    def kind(self) -> str:
        return self.mix["kind"]

    def counts(self):
        return load_module(HERE / "counts" / f"{self.config['name']}.py",
                           f"portbench_counts_{self.config['name']}")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.benchmark["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics read in this cell: those that list it, and
        those that list no cells, of an end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        raise RunError(f"no cell {name!r} in BENCHMARK.json")
    w = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name, load_json(HERE / "configs" / f"{w['config']}.json"),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                int(w["chips"]), w["limits"], bench)


def model_config(cell: Cell):
    """The port's model configuration of the cell: its preset with the
    configuration file's overrides, at the mix's ``time_len``; each value
    the file states is held to the preset's, so the benchmark never
    measures a model other than the one it names."""
    from gpvae_tpu_torch import configs

    cfg = cell.config
    preset = configs.get(cfg["preset"])
    mc = dataclasses.replace(preset.model, time_len=cell.mix["time_len"],
                             **cfg["overrides"])
    stated = dict(cfg["model"], batch_size=cfg["batch_size"],
                  learning_rate=cfg["learning_rate"], beta=cfg["beta"])
    runs = {k: getattr(mc, k) for k in cfg["model"]}
    runs.update(batch_size=preset.batch_size,
                learning_rate=preset.train.learning_rate,
                beta=dataclasses.asdict(preset.train.beta))
    for key, want in stated.items():
        got = runs[key]
        if isinstance(got, tuple):
            got = list(got)
        if got != want:
            raise RunError(f"configuration {cfg['name']}: {key} is {got!r} "
                           f"in the port's preset, {want!r} in the file")
    return mc, preset


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules, each
    compared whole (``gpvae_tpu_torch`` is not ``gpvae_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def check_package(root: Path) -> None:
    """The port must be the checkout's own, not one installed elsewhere."""
    spec = importlib.util.find_spec(PACKAGE)
    if spec is None or spec.origin is None:
        raise RunError(f"{PACKAGE} is not in this checkout ({root})")
    if Path(spec.origin).resolve().parent.parent != root.resolve():
        raise RunError(f"{PACKAGE} comes from {spec.origin}, not from the "
                       f"checkout {root}")


def compare(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared against its limit (``value <= limit``; a
    reading that is missing or not a number fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        good = value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def per_layer_metrics(cell: Cell, ctx) -> dict:
    """Each per-layer metric of the cell its reader found something to
    read for; a reader that finds nothing returns None and the metric is
    left out."""
    out = {}
    for m in cell.per_layer():
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the cell, its counts, the profiled
    stretch (``trace``), and the unprofiled window (``window_units`` steps
    or calls in ``window_s`` seconds)."""
    cell: Cell
    trace: object
    window_units: int
    window_s: float

    @property
    def kind(self) -> str:
        return self.cell.kind

    def groups(self) -> list[dict]:
        return self.cell.counts().kernel_groups(self.cell.config,
                                                self.cell.mix)

    def terms(self) -> list[tuple[str, float, str]]:
        counts, cfg, mix = self.cell.counts(), self.cell.config, self.cell.mix
        if self.kind == "train":
            return counts.step_terms(cfg, mix)
        return counts.call_terms(cfg, mix)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """Set up, measure, check: the result's fields, ``checks`` last."""
    import torch

    driver_mod = load_module(HERE / "traffic" / f"{cell.kind}.py",
                             f"portbench_traffic_{cell.kind}")
    on_card = device.type == "cuda"
    started = time.monotonic() - t0
    driver = driver_mod.Driver(cell, seed, device)
    setup_s = time.monotonic() - t0
    win = driver.window(seconds)
    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"]}
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        tr = None
        if on_card:
            from portbench import profiler

            tr = profiler.profile(driver.stretch)
            dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            result["profiler_takes"] = tr.takes
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
        ctx = Context(cell, tr, win["units"], win["seconds"])
        metrics = per_layer_metrics(cell, ctx)
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()
    t_check = time.monotonic()
    readings = driver.check()
    check_s = time.monotonic() - t_check
    ok, checks = compare(readings, cell.limits)
    result.update(correct=ok and win["failed"] == 0, metrics=metrics)
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak), **dev_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card_line() if on_card else "no card"
    result["setup_phases"] = {"start": started, **driver.phases}
    result["window"] = {"units": win["units"], "seconds": win["seconds"],
                        **win["detail"]}
    result["check_s"] = check_s
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
        check_package(ROOT)
        import torch

        # one host thread for PyTorch's own CPU work: the card's host is
        # shared, and idle worker threads spinning beside the one that
        # drives the card spread the runs
        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card "
                           "only")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{cell.name} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} found")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t0)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr, flush=True)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def process_start() -> float:
    """``time.monotonic()`` at this process's start, from its start time
    in ``/proc`` (Linux); the current time where that cannot be read."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(uptime - start, 0.0)
    except (OSError, ValueError, IndexError):
        return now
