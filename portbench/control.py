"""The readings that each cell's limits are set from, on the card at the
cell's own size (not run by the benchmark's runs):

    python portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2]

For each of ``--seeds``: the program's readings, as a run takes them (a
training cell's checked first steps; an imputation cell's sampled calls
from a window of ``--seconds`` at the cell's load).  For each of
``--control-seeds`` besides: the control, the plain reference put in the
program's place at the precision one step below the configuration's
(float32 with TF32 products, ``reference.gpvae.TF32``), and the faults a
cell can have, planted in the reference put in the program's place: half
of each batch left out (the mean over the rest), and, for imputation, one
answer altered where it is produced.  A step that returns its state
unchanged reads 1 in ``update_gap_median`` by its definition and needs no
run.
One JSON line a reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import gpvae as ref  # noqa: E402


def half(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def train_planted(d) -> dict:
    """Readings of the reference in the program's place: at TF32, and in
    float64 on the first half of each batch."""
    batches, noise = d.reference_inputs()
    out = {}
    tf = ref.train(d.cfg, d.weights, batches, noise, ref.TF32)
    out["control"] = d.check(against=tf)
    hb = ref.train(d.cfg, d.weights, [half(b) for b in batches],
                   [n[:, : n.shape[1] // 2] for n in noise], ref.FLOAT64)
    out["fault_half_batch"] = d.check(against=hb)
    return out


def impute_planted(d) -> dict:
    """Readings of the reference in the program's place: at TF32; with
    only the first half of each batch imputed (the rest the encoder's
    means, decoded); with one answer altered (the first dropped step's
    latents and probabilities negated and flipped)."""
    out = {}
    calls = {c for c, _ in d.sample}
    tf = {c: {k: v.cpu() for k, v in ref.impute(
        d.cfg, d.weights, d.batches[c], d.batches[c]["kept"], ref.TF32).items()}
        for c in calls}
    out["control"] = d.check(against=tf)
    f64 = {c: {k: v.cpu().float() for k, v in ref.impute(
        d.cfg, d.weights, d.batches[c], d.batches[c]["kept"]).items()}
        for c in calls}
    halfb = {}
    for c in calls:
        bt = d.batches[c]
        b = bt["x"].shape[0]
        if b < 2:
            continue
        first = ref.impute(d.cfg, d.weights, half(bt), half(bt)["kept"])
        rest = {k: v[b // 2:] for k, v in bt.items()}
        enc = ref.impute(d.cfg, d.weights, rest, rest["mask"])
        halfb[c] = {k: torch.cat([first[k], enc[k]]).cpu() for k in first}
    if len(halfb) == len(calls):
        out["fault_half_batch"] = d.check(against=halfb)
    altered = {}
    for c in calls:
        drop = (d.batches[c]["mask"] & ~d.batches[c]["kept"]).cpu()
        a = {k: v.clone() for k, v in f64[c].items()}
        i = drop.nonzero()[0]
        a["z"][i[0], i[1]] *= -1.0
        a["probs"][i[0], i[1]] = 1.0 - a["probs"][i[0], i[1]]
        altered[c] = a
    out["fault_altered_answer"] = d.check(against=altered)
    return out


def readings(cell, seed: int, seconds: float, planted: bool, device) -> list:
    mod = harness.load_module(harness.HERE / "traffic" / f"{cell.kind}.py",
                              f"portbench_traffic_{cell.kind}")
    t0 = time.monotonic()
    d = mod.Driver(cell, seed, device)
    setup_s = time.monotonic() - t0
    d.window(seconds)
    d.release()
    t1 = time.monotonic()
    rows = [{"seed": seed, "role": "program", "readings": d.check(),
             "setup_s": setup_s, "check_s": time.monotonic() - t1}]
    if planted:
        got = train_planted(d) if cell.kind == "train" else impute_planted(d)
        rows += [{"seed": seed, "role": role, "readings": r}
                 for role, r in got.items()]
    del d
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    planted = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(planted - set(seeds)):
        for row in readings(cell, seed, args.seconds, seed in planted, device):
            print(json.dumps({"cell": cell.name, **row}), flush=True)
    print(json.dumps({"cell": cell.name, "card": harness.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
