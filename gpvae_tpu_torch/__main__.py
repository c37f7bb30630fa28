"""Command-line entry point: ``python -m gpvae_tpu_torch <command>``.

    python -m gpvae_tpu_torch list-presets
    python -m gpvae_tpu_torch train --preset syn_data --steps 5000
    python -m gpvae_tpu_torch train --preset syn_data --steps 5 --device cpu
    python -m gpvae_tpu_torch train --preset bench_t100 --time-len 1024

``train`` runs on ``cuda`` unless ``--device`` says otherwise, and fails
when no CUDA device is present.  The data are toy GP draws generated
from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def cmd_list_presets(_args):
    from gpvae_tpu_torch import configs

    for name in sorted(configs.PRESETS):
        p = configs.get(name)
        print(f"{name:20s} batch={p.batch_size:<5d} {p.description}")


def cmd_train(args):
    import torch

    from gpvae_tpu_torch import configs, train as train_lib
    from gpvae_tpu_torch.data import (
        Batcher, generate_toy_data, toy_to_masked_batch,
    )
    from gpvae_tpu_torch.models import GPVAE

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: pass --device cpu to train on the CPU"
        )
    preset = configs.get(args.preset)
    model_cfg = preset.model
    if args.time_len:
        model_cfg = dataclasses.replace(model_cfg, time_len=args.time_len)
    train_cfg = preset.train
    overrides = {"seed": args.seed}
    if args.steps:
        overrides["num_steps"] = args.steps
    if args.log_every:
        overrides["log_every"] = args.log_every
    train_cfg = dataclasses.replace(train_cfg, **overrides)
    batch_size = args.batch_size or preset.batch_size

    rng = np.random.default_rng(args.seed)
    batch = toy_to_masked_batch(generate_toy_data(
        rng, args.num_seqs, t=model_cfg.time_len, obs_dim=model_cfg.obs_dim,
    ))
    n_train = int(0.9 * batch["x"].shape[0])
    train = {k: v[:n_train] for k, v in batch.items()}
    model = GPVAE(model_cfg,
                  generator=torch.Generator().manual_seed(args.seed))
    state, log = train_lib.fit(
        model, Batcher(train, batch_size, seed=args.seed), train_cfg,
        device=device, csv_path=args.csv,
    )
    final = log.rows[-1] if log.rows else {}
    print(f"done at step {state.step}: "
          f"loss={final.get('loss', float('nan')):.4f}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="gpvae_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("list-presets").set_defaults(fn=cmd_list_presets)

    t = sub.add_parser("train")
    t.add_argument("--preset", required=True)
    t.add_argument("--num-seqs", type=int, default=512,
                   help="toy sequences to generate (90%% train)")
    t.add_argument("--steps", type=int)
    t.add_argument("--log-every", type=int)
    t.add_argument("--csv")
    t.add_argument("--batch-size", type=int,
                   help="override the preset's batch size")
    t.add_argument("--time-len", type=int,
                   help="override the preset's sequence length T")
    t.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
