#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpvae_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failed check exits nonzero at once):

1. device: the card, its power limit, and the float32 matmul setting;
2. build: both CUDA kernels from ``gpvae_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version in float64 on
   the card, at T in {8, 45, 64}, N in {80, 1024}, masked and unmasked,
   all six kernel families for ``gram_chol``;
4. main path: ``train.fit`` of the ``syn_data`` preset at its full widths
   (B=20, T=45, Z=2, 15 observed dims) on 2,000 toy sequences, with both
   kernels' launch counters read around it, and the trained model's ELBO
   and gradients held against the same model on the CPU in float64;
5. timing: train steps/s, and each kernel against its plain version at
   the main path's shapes (CUDA events, medians).

Then one JSON line with the kernels' results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

# Bands of phase 3 (kernel vs its plain version in float64 on the card).
# L: the TPU verify recipe's 5e-5, or 4x the error of the library's own
# float32 factor (torch.linalg.cholesky on the card) on the same input,
# whichever is larger.  The forward error of a float32 Cholesky grows with
# cond(K), and with noise 1e-3 the smooth kernels reach cond(K) ~ 1e4-1e5
# at T = 64, where the library's float32 factor itself misses float64 by
# up to 2e-4 (measured with the CPU's LAPACK on these inputs).
L_MAX_ABS = 5e-5
L_VS_LIBRARY = 4.0
TRI_INV_REL_FRO = 1e-4
# Phase 4: the trained model's ELBO on the card (float32, kernels) vs the
# same model on the CPU (float64, plain versions), same noise.
ELBO_LOSS_REL = 1e-4
# A KL is a difference of terms of size T + KL (trace, quadratic form,
# logdets), and float32 errors scale with those terms, not with the KL:
# held to 1.3e-3 of T + |KL|, the toy KL band of the TPU package's
# float64-oracle accuracy table (BASELINE.md, round 5).
KL_REL_TERMS = 1.3e-3
GRAD_REL = 1e-3        # all parameters' gradients as one vector
# The lengthscale gradient runs through the Cholesky reverse mode of a K
# with cond ~ 1e4, which amplifies float32 rounding: the CPU's own float32
# path misses float64 by 1e-4 to 1.2e-3 on this batch.
LOG_LS_GRAD_REL = 5e-3

SYN_B, SYN_T, SYN_Z, SYN_D = 20, 45, 2, 15
MAIN_STEPS = 400


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of one call of ``fn`` over
    ``iters`` back-to-back calls, by CUDA events, after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    times.sort()
    return times[len(times) // 2]


def device_profile(fn, calls: int = 50) -> tuple[float, float, float]:
    """``(device µs per call, kernels per call, wall µs per call)`` of
    ``fn`` under ``torch.profiler``: the summed durations of the kernels
    it ran on the card (user annotations left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        fail("the profiler saw no kernel on the card")
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    return busy / calls, len(kernels) / calls, wall * 1e6 / calls


def bank_inputs(rng, b, t, z, masked, dev):
    import numpy as np
    import torch

    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    if masked:
        # each sequence hides a random subset, as the toy data does
        mask = rng.random((b, t)) > rng.uniform(0.0, 0.7, (b, 1))
        mask[:, 0] = True
    else:
        mask = np.ones((b, t), bool)
    ls = rng.uniform(1.0, 10.0, z)
    var = rng.uniform(0.5, 1.5, z)
    return (torch.tensor(times, dtype=torch.float32, device=dev),
            torch.tensor(ls, dtype=torch.float32, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(var, dtype=torch.float32, device=dev))


def check_kernels(dev) -> dict:
    """Phase 3.  Returns the worst error of each kernel."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import gram_chol, tri_inv

    rng = np.random.default_rng(0)
    z = 2 * SYN_Z  # the stacked posterior + prior bank
    worst = {"gram_chol": 0.0, "gram_chol_vs_library": 0.0,
             "tri_inv_abs": 0.0, "tri_inv_rel": 0.0}
    cases = 0
    for t in (8, 45, 64):
        for n in (80, 1024):
            for masked in (False, True):
                times, ls, mask, var = bank_inputs(rng, n // z, t, z, masked,
                                                   dev)
                for kernel in kernels_lib.KERNELS:
                    l = gram_chol.gram_chol_fused(
                        times, ls, mask=mask, kernel=kernel, variance=var)
                    ref = gram_chol.gram_chol_plain(
                        times.double(), ls.double(), mask=mask,
                        kernel=kernel, variance=var.double())
                    lib32 = gram_chol.gram_chol_plain(
                        times, ls, mask=mask, kernel=kernel, variance=var)
                    torch.cuda.synchronize()
                    err = (l.double() - ref).abs().max().item()
                    err_lib = (lib32.double() - ref).abs().max().item()
                    band = max(L_MAX_ABS, L_VS_LIBRARY * err_lib)
                    if not math.isfinite(err) or err > band:
                        fail(f"gram_chol {kernel} T={t} N={n} "
                             f"masked={masked}: max abs err {err:.3e} > "
                             f"{band:.3e} (library float32: {err_lib:.3e})")
                    worst["gram_chol"] = max(worst["gram_chol"], err)
                    worst["gram_chol_vs_library"] = max(
                        worst["gram_chol_vs_library"],
                        err / max(err_lib, 1e-30))
                    cases += 1
                # tri_inv on the factor the main path hands it
                lf = gram_chol.gram_chol_fused(
                    times, ls, mask=mask, variance=var).reshape(-1, t, t)
                x = tri_inv.tri_inv_cuda(lf.contiguous())
                xref = tri_inv.tri_inv_plain(lf.double())
                torch.cuda.synchronize()
                diff = x.double() - xref
                rel = (torch.linalg.matrix_norm(diff)
                       / torch.linalg.matrix_norm(xref)).max().item()
                if not math.isfinite(rel) or rel > TRI_INV_REL_FRO:
                    fail(f"tri_inv T={t} N={n} masked={masked}: rel Frobenius"
                         f" err {rel:.3e} > {TRI_INV_REL_FRO:.0e}")
                if bool((torch.triu(x, 1) != 0).any()):
                    fail(f"tri_inv T={t} N={n}: upper triangle not zero")
                worst["tri_inv_rel"] = max(worst["tri_inv_rel"], rel)
                worst["tri_inv_abs"] = max(worst["tri_inv_abs"],
                                           diff.abs().max().item())
                cases += 1
    # what the kernels refuse, they refuse loudly
    long_t = torch.zeros((1, 65), device=dev)
    try:
        gram_chol.gram_chol_fused(long_t, ls[:1])
    except NotImplementedError:
        pass
    else:
        fail("gram_chol accepted T=65 on CUDA")
    try:
        tri_inv.tri_inv_cuda(torch.eye(4, dtype=torch.float64,
                                       device=dev)[None])
    except TypeError:
        pass
    else:
        fail("tri_inv accepted a float64 CUDA tensor")
    worst["cases"] = cases
    return worst


def elbo_vs_cpu(model, dev) -> dict:
    """The trained model's ELBO and gradients on a small batch, on the card
    (kernels, float32) and on the CPU (plain versions, float64), with the
    same noise."""
    import numpy as np
    import torch

    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch

    rng = np.random.default_rng(7)
    b = 4
    batch = toy_to_masked_batch(generate_toy_data(rng, b))
    eps = rng.standard_normal((1, b, SYN_Z, SYN_T))
    ref_model = copy.deepcopy(model).to("cpu").double()

    def run(m, device, dtype):
        m.zero_grad(set_to_none=True)
        x = torch.tensor(batch["x"], dtype=dtype, device=device)
        times = torch.tensor(batch["times"], dtype=dtype, device=device)
        mask = torch.tensor(batch["mask"], device=device)
        out = m(x, times, mask, beta=1.0,
                eps=torch.tensor(eps, dtype=dtype, device=device))
        out.loss.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in m.named_parameters()}
        return out, grads

    out, grads = run(model, dev, torch.float32)
    ref, ref_grads = run(ref_model, "cpu", torch.float64)
    if tuple(out.logits.shape) != (1, b, SYN_T, SYN_D):
        fail(f"logits shape {tuple(out.logits.shape)}")
    loss_rel = abs(out.loss.item() - ref.loss.item()) / abs(ref.loss.item())
    kl_abs = (out.kl.double().cpu() - ref.kl).abs().max().item()
    kl_band = KL_REL_TERMS * (SYN_T + ref.kl.abs().max().item())
    names = sorted(ref_grads)
    g = torch.cat([grads[n].reshape(-1) for n in names])
    g_ref = torch.cat([ref_grads[n].reshape(-1) for n in names])
    grad_rel = (torch.linalg.norm(g - g_ref)
                / torch.linalg.norm(g_ref)).item()
    ls_rel = (torch.linalg.norm(grads["posterior_log_ls"]
                                - ref_grads["posterior_log_ls"])
              / torch.linalg.norm(ref_grads["posterior_log_ls"])).item()
    if not (loss_rel <= ELBO_LOSS_REL and kl_abs <= kl_band
            and grad_rel <= GRAD_REL and ls_rel <= LOG_LS_GRAD_REL):
        fail(f"ELBO on the card vs CPU float64: loss rel {loss_rel:.3e} "
             f"(<= {ELBO_LOSS_REL:.0e}), kl abs {kl_abs:.3e} "
             f"(<= {kl_band:.3e}), grad rel {grad_rel:.3e} "
             f"(<= {GRAD_REL:.0e}), log-lengthscale grad rel {ls_rel:.3e} "
             f"(<= {LOG_LS_GRAD_REL:.0e})")
    model.zero_grad(set_to_none=True)
    return {"loss_rel": loss_rel, "kl_abs": kl_abs, "kl_band": kl_band,
            "kl_ref": ref.kl.tolist(), "grad_rel": grad_rel,
            "log_ls_grad_rel": ls_rel}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import gpvae_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gpvae_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    import numpy as np
    import torch

    from gpvae_tpu_torch import configs, train as train_lib
    from gpvae_tpu_torch.data import (
        Batcher, generate_toy_data, toy_to_masked_batch,
    )
    from gpvae_tpu_torch.models import GPVAE
    from gpvae_tpu_torch.ops import _build, gram_chol, tri_inv

    # -- 1. device -------------------------------------------------------
    smi = nvidia_smi_line()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on")
    torch.backends.cudnn.allow_tf32 = False  # no convs here; stated anyway
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, allow_tf32=False)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    gram_chol.build()
    tri_inv.build()
    phase("build", seconds=time.perf_counter() - t0,
          nvcc_seconds=dict(_build.BUILD_SECONDS))

    # -- 3. kernels vs plain ---------------------------------------------
    worst = check_kernels(dev)
    phase("kernels_vs_plain", **worst, gram_chol_band=L_MAX_ABS,
          tri_inv_band_rel_fro=TRI_INV_REL_FRO)

    # -- 4. main path ----------------------------------------------------
    preset = configs.get("syn_data")
    cfg = preset.model
    if (preset.batch_size, cfg.time_len, cfg.latent_dim, cfg.obs_dim) != (
            SYN_B, SYN_T, SYN_Z, SYN_D):
        fail("syn_data preset widths changed")
    data = toy_to_masked_batch(
        generate_toy_data(np.random.default_rng(0), 2000))
    batcher = Batcher(data, preset.batch_size, seed=0)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    log_ls0 = model.posterior_log_ls.detach().clone()
    gram_chol.LAUNCHES = 0
    tri_inv.LAUNCHES = 0
    head_cfg = train_lib.TrainConfig(
        learning_rate=preset.train.learning_rate, num_steps=20,
        beta=preset.train.beta, log_every=1)
    state, head = train_lib.fit(model, batcher, head_cfg, device=dev,
                                verbose=False)
    main_cfg = train_lib.TrainConfig(
        learning_rate=preset.train.learning_rate, num_steps=MAIN_STEPS,
        beta=preset.train.beta, log_every=20)
    state, tail = train_lib.fit(model, batcher, main_cfg, device=dev,
                                state=state, verbose=False)
    torch.cuda.synchronize()
    launches = {"gram_chol": gram_chol.LAUNCHES, "tri_inv": tri_inv.LAUNCHES}
    first = [r["loss"] for r in head.rows]
    last = [r["loss"] for r in tail.rows[-5:]]
    if not all(math.isfinite(v) for v in first + [r["loss"] for r in
                                                   tail.rows]):
        fail("non-finite loss in the main path")
    if not np.mean(last) < np.mean(first):
        fail(f"loss did not fall: first 20 steps {np.mean(first):.4f}, "
             f"last logged {np.mean(last):.4f}")
    moved = (model.posterior_log_ls.detach().cpu() - log_ls0).abs().max()
    if not moved.item() > 0:
        fail("posterior_log_ls did not move")
    if state.step != MAIN_STEPS:
        fail(f"trained {state.step} steps, expected {MAIN_STEPS}")
    for name, count in launches.items():
        if count < 1:
            fail(f"the main path launched the {name} kernel {count} times")
    parity = elbo_vs_cpu(model, dev)
    phase("main_path", preset="syn_data", steps=state.step,
          batch=preset.batch_size, time_len=SYN_T, latent_dim=SYN_Z,
          loss_first20=float(np.mean(first)), loss_last=float(np.mean(last)),
          lengthscale_posterior=torch.exp(
              model.posterior_log_ls.detach()).tolist(),
          launches=launches, elbo_vs_cpu_fp64=parity)

    # -- 5. timing ---------------------------------------------------------
    timing_cfg = dataclasses.replace(main_cfg, num_steps=MAIN_STEPS + 1200,
                                     log_every=200)
    state, timed = train_lib.fit(model, batcher, timing_cfg, device=dev,
                                 state=state, verbose=False)
    sps = sorted(r["steps_per_sec"] for r in timed.rows[1:])
    steps_per_s = sps[len(sps) // 2]

    rng = np.random.default_rng(1)
    times, ls, mask, var = bank_inputs(rng, SYN_B, SYN_T, 2 * SYN_Z, True,
                                       dev)
    ms, plain_ms = {}, {}
    bank = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(
        -1, SYN_T, SYN_T).contiguous()
    fns = {"gram_chol": (
        lambda: gram_chol.gram_chol_fused(times, ls, mask=mask),
        lambda: gram_chol.gram_chol_plain(times, ls, mask=mask))}
    for n in (40, 80):
        lb = bank[:n].contiguous()
        fns[f"tri_inv_n{n}"] = (lambda lb=lb: tri_inv.tri_inv_cuda(lb),
                                lambda lb=lb: tri_inv.tri_inv_plain(lb))
    device_us = {}
    for name, (kernel_fn, plain_fn) in fns.items():
        ms[name] = cuda_ms(kernel_fn)
        plain_ms[name] = cuda_ms(plain_fn)
        kernel_us, kernel_launches, _ = device_profile(kernel_fn)
        plain_us, plain_launches, _ = device_profile(plain_fn)
        device_us[name] = {"kernel": kernel_us, "plain": plain_us,
                           "plain_kernels_per_call": plain_launches,
                           "kernel_kernels_per_call": kernel_launches}

    window = 100  # train steps in one profiled fit

    def fit_window():
        cfg_w = dataclasses.replace(main_cfg, num_steps=state.step + window,
                                    log_every=window)
        train_lib.fit(model, batcher, cfg_w, device=dev, state=state,
                      verbose=False)

    win_us, win_kernels, win_wall_us = device_profile(fit_window, calls=1)
    phase("timing", train_steps_per_s=steps_per_s,
          train_steps_per_s_windows=sps, window_steps=200,
          kernel_ms=ms, plain_ms=plain_ms, device_us=device_us,
          train_step_profiled={
              "device_us": win_us / window, "kernels": win_kernels / window,
              "wall_us_under_profiler": win_wall_us / window,
              "device_busy_share": win_us / win_wall_us},
          shapes={"gram_chol": "N=80 (B=20, 2Z=4), T=45, masked",
                  "tri_inv_n40": "N=40, T=45", "tri_inv_n80": "N=80, T=45"})

    print(json.dumps({"kernels": [
        {"name": "gram_chol", "route": "cuda",
         "source": "gpvae_tpu_torch/csrc/gram_chol.cu",
         "replaces": "gpvae_tpu/ops/pallas_chol.py:673",
         "launches": launches["gram_chol"],
         "max_abs_err": worst["gram_chol"],
         "ms": ms["gram_chol"], "plain_ms": plain_ms["gram_chol"]},
        {"name": "tri_inv", "route": "cuda",
         "source": "gpvae_tpu_torch/csrc/tri_inv.cu",
         "replaces": "gpvae_tpu/ops/pallas_tri.py:39",
         "launches": launches["tri_inv"],
         "max_abs_err": worst["tri_inv_abs"],
         "ms": ms["tri_inv_n80"], "plain_ms": plain_ms["tri_inv_n80"]},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
