"""Command-line entry point: ``python -m gpvae_tpu_torch <command>``.

    python -m gpvae_tpu_torch list-presets
    python -m gpvae_tpu_torch generate-data --out toy.npz --num-seqs 10000
    python -m gpvae_tpu_torch train --preset syn_data --steps 5000 \
        --data toy.npz --ckpt-dir D
    python -m gpvae_tpu_torch train --preset syn_data --steps 5 --device cpu
    python -m gpvae_tpu_torch train --preset syn_data --num-seqs 10000 \
        --steps 100000 --steps-per-call 100 --data toy_data_v3.pkl
    python -m gpvae_tpu_torch train --preset bench_t100 --time-len 1024
    python -m gpvae_tpu_torch evaluate --preset syn_data --ckpt-dir D
    python -m gpvae_tpu_torch evaluate --preset bench_t100 --time-len 1024 \
        --num-seqs 320 --eval-batch 32 --ckpt-dir D
    python -m gpvae_tpu_torch train --preset full_gp_dynamic --steps 100 \
        --num-seqs 64 --ckpt-dir D
    python -m gpvae_tpu_torch evaluate --preset full_gp_dynamic --ckpt-dir D \
        --plots out/ --traversal 0
    python -m gpvae_tpu_torch train --preset healing_mnist --num-seqs 4608 \
        --ckpt-dir D --plots out/ --plots-every 10000
    python -m gpvae_tpu_torch evaluate --preset healing_mnist --ckpt-dir D
    python -m gpvae_tpu_torch train --preset sparse_t4096 --ckpt-dir D
    python -m gpvae_tpu_torch evaluate --preset sparse_t4096 --ckpt-dir D \
        --eval-batch 2

``train`` and ``evaluate`` run on ``cuda`` unless ``--device`` says
otherwise, and fail when no CUDA device is present.  The data follow the
preset's family (``gpvae_tpu/__main__.py:49-110``): toy GP draws for the
dense presets, of which ``evaluate`` scores the 10% that ``train`` holds
out; Moving-MNIST videos for the conv presets, whose test split (the
last 10%) ``evaluate`` scores; healing sequences with missing pixels for
``healing_mnist``, whose last 10% ``evaluate`` scores on the missing
pixels (``analysis.pixel_imputation_metrics``).  All are generated from
``--seed``; ``--data`` reads a ``.npz`` of toy fields (``generate-data``)
or the reference's pickle ``toy_data_v3.pkl`` (``data.load_toy_file``),
or a Moving-MNIST ``.npy`` instead.  ``train --steps-per-call k`` runs
``k`` optimizer steps a call of the training loop (``TrainConfig.
steps_per_call``).
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


def cmd_generate_data(args):
    """A ``.npz`` of ``data.generate_toy_data``'s fields from ``--seed``,
    which ``--data`` reads (``gpvae_tpu/__main__.py:32-42``)."""
    from gpvae_tpu_torch.data import generate_toy_data

    data = generate_toy_data(np.random.default_rng(args.seed), args.num_seqs,
                             t=args.time_len)
    np.savez(args.out, **data)
    print(f"wrote {args.num_seqs} sequences to {args.out}")


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: pass --device cpu to run on the CPU"
        )
    return device


def _model_config(args, preset):
    if args.time_len:
        return dataclasses.replace(preset.model, time_len=args.time_len)
    return preset.model


def _load_batches(args, preset, model_cfg):
    """``(train Batcher, test arrays)`` of the preset's data family
    (``gpvae_tpu/__main__.py:49-110``): Moving-MNIST videos (``--data``
    ``.npy``, or synthetic ones from ``--seed``) split 80/10/10; healing
    sequences split 90/10, the training split with its ``feature_mask``
    and the test split with ``x_clean`` too; or toy sequences split
    90/10."""
    from gpvae_tpu_torch.data import (
        Batcher, MovingMNIST, make_healing_batch, synthetic_moving_mnist,
    )

    batch_size = args.batch_size or preset.batch_size
    family = preset.resolved_data_family
    if family == "healing":
        # the feature_mask travels with every batch, or the NLL trains the
        # model to predict the zero fill
        batch = make_healing_batch(args.num_seqs, t=model_cfg.time_len,
                                   size=model_cfg.image_shape[0],
                                   seed=args.seed)
        n_train = int(0.9 * batch["x"].shape[0])
        train = {k: batch[k][:n_train]
                 for k in ("x", "times", "mask", "feature_mask")}
        test = {k: v[n_train:] for k, v in batch.items()}
        return Batcher(train, batch_size, seed=args.seed), test
    if family == "mnist":
        if args.data:
            ds = MovingMNIST(args.data, batch_size=batch_size)
        else:
            ds = MovingMNIST(data=synthetic_moving_mnist(
                args.num_seqs, t=model_cfg.time_len,
                size=model_cfg.image_shape[0], seed=args.seed),
                batch_size=batch_size)
        return ds.batchers["train"], ds.splits["test"]
    train, test = _toy_split(args, model_cfg, full=family == "toy_full")
    return Batcher(train, batch_size, seed=args.seed), test


def _toy_split(args, model_cfg, *, full: bool = False
               ) -> tuple[dict, dict]:
    """``(train, test)``: the first 90% of the toy sequences generated from
    ``--seed`` (or read from ``--data``: an ``.npz`` or the reference's
    pickle, ``data.load_toy_file``) and the rest
    (``gpvae_tpu/__main__.py:82-100``).  With ``full`` (the ``toy_full``
    family) no step is hidden: a Toeplitz prior needs a full uniform
    grid."""
    from gpvae_tpu_torch.data import (
        generate_toy_data, load_toy_file, toy_to_masked_batch,
    )

    if args.data:
        raw = load_toy_file(args.data)
    else:
        raw = generate_toy_data(np.random.default_rng(args.seed),
                                args.num_seqs, t=model_cfg.time_len,
                                obs_dim=model_cfg.obs_dim,
                                hide_fraction=0.0 if full else 0.7)
    batch = toy_to_masked_batch(raw)
    n_train = int(0.9 * batch["x"].shape[0])
    return ({k: v[:n_train] for k, v in batch.items()},
            {k: v[n_train:] for k, v in batch.items()})


def cmd_train(args):
    import torch

    from gpvae_tpu_torch import configs, train as train_lib
    from gpvae_tpu_torch.models import GPVAE

    device = _device(args.device)
    preset = configs.get(args.preset)
    model_cfg = _model_config(args, preset)
    train_cfg = preset.train
    overrides = {"seed": args.seed}
    if args.steps:
        overrides["num_steps"] = args.steps
    if args.log_every:
        overrides["log_every"] = args.log_every
    if args.ckpt_dir:
        overrides["checkpoint_dir"] = args.ckpt_dir
    if args.steps_per_call:
        overrides["steps_per_call"] = args.steps_per_call
    train_cfg = dataclasses.replace(train_cfg, **overrides)

    batches, _ = _load_batches(args, preset, model_cfg)
    model = GPVAE(model_cfg,
                  generator=torch.Generator().manual_seed(args.seed))
    callbacks = None
    if args.plots:
        # periodic input/reconstruction/latent artifacts during training,
        # the reference's savefig blocks every 10-20k steps
        from gpvae_tpu_torch import analysis

        probe = {k: v[:min(8, batches.batch_size)]
                 for k, v in batches.arrays.items()}
        callbacks = [(args.plots_every, analysis.make_artifact_callback(
            model, probe, args.plots))]
    state, log = train_lib.fit(model, batches, train_cfg, device=device,
                               csv_path=args.csv, callbacks=callbacks)
    final = log.rows[-1] if log.rows else {}
    print(f"done at step {state.step}: "
          f"loss={final.get('loss', float('nan')):.4f}")


def cmd_evaluate(args):
    """Restore the newest checkpoint of ``--ckpt-dir`` (its model only;
    without one, the model's seeded initial weights) and print the
    imputation metrics of the held-out sequences as one JSON line
    (``gpvae_tpu/__main__.py:152-272``; for the healing family the
    missing-pixel metrics of
    ``analysis.pixel_imputation_metrics``), with ``--stats`` the sorted
    activation variances, and
    with ``--plots DIR`` PNGs of the imputation and latents (and with
    ``--traversal D`` of latent D's sweeps).  The kept mask and the
    baseline's noise come from a CPU generator seeded with ``--seed``, so
    the card and the CPU score the same dropped steps."""
    import json

    import torch

    from gpvae_tpu_torch import analysis, configs, train as train_lib
    from gpvae_tpu_torch.models import GPVAE

    device = _device(args.device)
    preset = configs.get(args.preset)
    model_cfg = _model_config(args, preset)
    _, test = _load_batches(args, preset, model_cfg)
    batch = train_lib.device_arrays(
        {k: v[: args.eval_batch] for k, v in test.items()}, device)
    model = GPVAE(model_cfg,
                  generator=torch.Generator().manual_seed(args.seed))
    state = train_lib.create_train_state(
        model, train_lib.TrainConfig(seed=args.seed), device)
    if args.ckpt_dir:
        mgr = train_lib.CheckpointManager(args.ckpt_dir)
        if mgr.restore_latest(state, optimizer=False) is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
        print(f"restored step {state.step}")
    x, times, mask = batch["x"], batch["times"], batch["mask"]
    if preset.resolved_data_family == "healing":
        # missing pixels scored against the clean frames
        metrics = analysis.pixel_imputation_metrics(
            model, {k: v[: args.eval_batch] for k, v in test.items()})
    else:
        metrics = analysis.imputation_metrics(
            model, x, times, mask, drop_fraction=args.drop_fraction,
            generator=torch.Generator().manual_seed(args.seed))
    print(json.dumps(metrics))
    if args.stats:
        _, var_sorted = analysis.activation_stats(
            model, x, times, mask, num_samples=args.stats_samples,
            generator=torch.Generator().manual_seed(args.seed + 3))
        print(json.dumps({"activation_variance_sorted": [
            round(float(v), 6) for v in var_sorted.cpu()]}))
    if args.plots:
        _plots(args, model, x, times, mask)


def _plots(args, model, x, times, mask) -> None:
    """``evaluate --plots``: the imputation of the first sequence (input
    and imputed frames for a conv decoder) and its latents, and with
    ``--traversal D`` latent D swept over a probit grid and along a draw
    from the posterior GP (``gpvae_tpu/__main__.py:224-272``)."""
    import os

    import torch

    from gpvae_tpu_torch import analysis
    from gpvae_tpu_torch.utils import plotting

    def host(v):
        return v.detach().cpu().numpy()

    os.makedirs(args.plots, exist_ok=True)
    conv = model.config.decoder == "conv"
    kept = analysis.drop_timesteps(
        mask, args.drop_fraction,
        generator=torch.Generator().manual_seed(args.seed))
    probs, z_imp, _ = analysis.impute(model, x, times, mask, kept)
    if conv:
        plotting.comparison_grid(
            {"input": host(x[0]), "imputed": host(probs[0])},
            os.path.join(args.plots, "imputation.png"),
            kept_mask=host(kept[0]))
    plotting.trajectory_plot(host(times[0]), host(z_imp[0]),
                             os.path.join(args.plots, "latents.png"),
                             mask=host(kept[0]))
    if args.traversal is not None:
        d = args.traversal
        sweep = analysis.latent_traversal(
            model, torch.zeros(model.config.latent_dim, device=x.device), d)
        gp_sweep = analysis.traversal_from_gp(
            model, times[0], d,
            generator=torch.Generator().manual_seed(args.seed + 2))
        if conv:
            plotting.film_strip(
                host(sweep), os.path.join(args.plots, "traversal.png"),
                title=f"latent dim {d} probit sweep")
            plotting.film_strip(
                host(gp_sweep), os.path.join(args.plots, "traversal_gp.png"),
                title=f"latent dim {d} GP-draw sweep")
        else:
            plotting.trajectory_plot(
                np.arange(sweep.shape[0], dtype=np.float32), host(sweep),
                os.path.join(args.plots, "traversal.png"))
    print(f"plots written to {args.plots}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="gpvae_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("list-presets").set_defaults(fn=cmd_list_presets)

    g = sub.add_parser("generate-data")
    g.add_argument("--out", required=True)
    g.add_argument("--num-seqs", type=int, default=10_000)
    g.add_argument("--time-len", type=int, default=45)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate_data)

    t = sub.add_parser("train")
    t.add_argument("--preset", required=True)
    t.add_argument("--data", help=".npz toy data, the reference's toy "
                   "pickle, or a Moving-MNIST .npy in place of generated "
                   "sequences")
    t.add_argument("--num-seqs", type=int, default=512,
                   help="sequences to generate (toy, healing: 90%% train; "
                   "Moving-MNIST: 80%%)")
    t.add_argument("--steps", type=int)
    t.add_argument("--log-every", type=int)
    t.add_argument("--steps-per-call", type=int,
                   help="optimizer steps a call of the training loop (the "
                   "run may end up to k-1 steps past --steps)")
    t.add_argument("--ckpt-dir", help="resume from and save checkpoints "
                   "in this directory")
    t.add_argument("--csv")
    t.add_argument("--batch-size", type=int,
                   help="override the preset's batch size")
    t.add_argument("--time-len", type=int,
                   help="override the preset's sequence length T")
    t.add_argument("--plots", help="directory for periodic training "
                   "artifacts (film strips / latent trajectories; needs "
                   "matplotlib)")
    t.add_argument("--plots-every", type=int, default=10_000,
                   help="callback period for --plots (reference: 10-20k)")
    t.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    e.add_argument("--preset", required=True)
    e.add_argument("--ckpt-dir")
    e.add_argument("--data", help=".npz of toy data (the fields of "
                   "generate_toy_data), the reference's toy pickle, or a "
                   "Moving-MNIST .npy in place of generated sequences")
    e.add_argument("--num-seqs", type=int, default=128,
                   help="sequences to generate (the last 10%% scored)")
    e.add_argument("--time-len", type=int)
    e.add_argument("--eval-batch", type=int, default=16)
    e.add_argument("--drop-fraction", type=float, default=0.5)
    e.add_argument("--plots", help="directory for PNG artifacts (needs "
                   "matplotlib)")
    e.add_argument("--traversal", type=int,
                   help="with --plots, also latent-traversal strips for "
                   "this dim")
    e.add_argument("--stats", action="store_true",
                   help="print MC activation/variance statistics")
    e.add_argument("--stats-samples", type=int, default=100)
    e.add_argument("--batch-size", type=int,
                   help="the training batch size; evaluate scores "
                   "--eval-batch sequences at once and does not read it")
    e.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_evaluate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
