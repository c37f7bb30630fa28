#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpvae_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failed check exits nonzero at once):

1. device: the card, its power limit, and TF32 off for matmuls and for
   cuDNN's convs (the package turns the latter off when imported);
2. build: the eight CUDA sources of ``gpvae_tpu_torch/csrc`` (twelve
   kernels, the Durbin recursion's reverse among them, and the Durbin
   kernels' two chain floors), one ``nvcc`` each,
   all started together, and each kernel's registers and spills as ptxas
   reports them;
3. kernels: each kernel against its plain PyTorch version in float64 on
   the card: ``gram_chol`` and ``tri_inv`` at T in ``GRAM_CHOL_TS`` (both
   sides of multiples of the kernel's panel width 16, up to 64), N in {80,
   1024}, and at the zoo's T=20: N=1000 (a GP posterior's and prior's
   stacked bank, B=5), 500 (one side), 200 and 100 (a shared grid, one
   row of times, no mask), with ``ops.chol.cholesky`` (one ``chol_block``
   launch) of evaluate's pre-built N=1600 bank and ``tri_inv`` of each
   factor; ``chol_block`` in both modes at T in {64, 100, 128}, N in {128,
   1024}, with L^-1, at the other sides of ``CHOL_BLOCK_TS`` with and
   without L^-1 (N=128), and at a row stride in place; the blocked
   factorization (``chol_block`` + ``gram_panel`` + ``panel_solve``) at T in
   {256, 1024}, N in {16, 128}; ``diag_logdet`` on the T=1024 bank whole,
   as the stacked [32, 4, T, T] training bank and as its strided half, and
   ``tri_inv`` at T in {100, 1024}; for the imputation path, ``hist_panel`` at T=1024 (o=512)
   and at a ragged T=300, ``ops.chol.cholesky`` of pre-built masked banks
   at T in {45, 100, 256, 1000, 1024}, N up to 128 (K left unchanged),
   ``panel_solve`` at w in {1, 16, 100, 128}, N in {64, 128}, row counts
   that are no multiple of its row tile, o = 3 (4-byte copies), and on a
   view inside a larger buffer (its zero tile exactly zero, nothing
   written outside),
   and ``ops.trsm.solve_triangular`` in its four forms; for the
   right-looking route, ``trail_panel`` and ``trail_update`` at nb in
   {64, 128}, R in {256, 1024}, N=128, and ``ops.chol.cholesky(method=m)``
   for every method on the same pre-built banks; at the shapes of
   ``healing_mnist`` and ``sparse_t4096``, ``gram_chol`` with the Cauchy
   kernel on a shared grid (N=128, T in {10, 17, 33}), ``chol_block`` at
   FITC's K_mm and B (N=64, m=64), ``tri_inv`` of each, and
   ``ops.chol.cholesky`` of evaluate's T=4096 bank (32 blocks); the Durbin
   kernel against its plain version, both in float64, at T in
   ``DURBIN_TS`` (Z=1 and 3), on ``t1024_toeplitz``'s prior rows and on
   two near-singular T=4096 rows, and the Gohberg-Semencul identity ``K
   (K^-1 X) = X`` through the FFT route in float32; the Cholesky
   backward's kernel (``chol_bwd``, three launches) at the training
   shapes T=1024 (N=128) and T=8192 (N=2) against float64 and its plain
   version, and its mean error away from zero; the Durbin kernel's
   reverse on the forward kernel's kept steps of the same rows and of two
   rows whose last coefficient clamps, against its plain version and
   against autograd of the plain forward, all in float64 (random
   cotangents on all three outputs, and on each alone at the preset's and
   the clamped rows; above T=4096 in phase 6).  Every L and L^-1 has an
   exactly zero strict upper triangle;
4. main paths, each with every kernel counter set to 0 just before it and
   read just after (and no call of ``torch.linalg.cholesky`` or
   ``solve_triangular`` in between), and the trained model's ELBO and
   gradients held against the same model on the CPU in float64 with the
   same noise, on four batches of B=2:
   a. ``train.fit`` of ``syn_data`` at its widths (B=20, T=45, Z=2, 15
      observed dims), 400 steps;
   b. ``bench_t100`` at its widths (B=32, T=100), 300 steps;
   c. ``bench_t100`` at T=1024 (the CLI's ``--time-len 1024``), 20 steps;
   each path's ``diag_logdet`` launches are exactly one per ELBO forward
   at T=1024 (both halves' logdets from one launch over the stacked bank,
   none in the backward) and none at T <= 100, in training and in each
   ELBO held against the CPU;
   each path's loss must fall on a fixed probe batch; each path saves a
   checkpoint through ``fit(checkpoint_dir=...)``, and then
   d. ``python -m gpvae_tpu_torch evaluate`` (``__main__.main``) restores
      it and imputes the held-out sequences at each of the three (B=20,
      32, 32), counters reset around it; its posterior mean and four
      metrics are held against the same restored model on the CPU in
      float64 with the same kept mask, and one ``posterior_sample`` runs
      at T=1024;
   e. the reference model zoo at its widths (64 x 64 frames, T=20,
      Z=100, B=5) on synthetic Moving-MNIST videos from a seed:
      ``full_gp_dynamic`` and ``gp_prior_diag`` (a shared grid and
      ``gp_prior_diag_kl``) 100 steps, ``full_gp_fixed``, ``gp_recog``
      (``recog_sample``, ``recog_gp_kl``) and ``vanilla_vae`` 20; each
      path's launches exactly one ``gram_chol`` a step and its
      ``tri_inv`` count (none for ``vanilla_vae``), no other kernel and no
      library call; its ELBO and gradients against the CPU in float64 on
      four batches of B=2 under the bands above; the first two evaluated
      from their checkpoints as in d. (one ``chol_block`` launch over
      N=1600), and ``vanilla_vae``'s evaluate raising the JAX package's
      ``ValueError``;
   g. ``healing_mnist`` (BASELINE config 2) at its widths (B=64, T=10,
      Z=64, 28 x 28 frames, the Cauchy kernel on a shared grid) 100 steps
      on synthetic healing sequences with their ``feature_mask``:
      ``gram_chol`` 1 and ``tri_inv`` 2 a step, no other kernel; its ELBO
      against the CPU as the zoo's; ``evaluate`` of its checkpoint (the
      missing-pixel metrics, no kernel) against the CPU in float64;
   h. ``sparse_t4096`` (BASELINE config 4) at its widths (B=8, T=4096,
      Z=8, m=64) 100 steps on unit-grid toy sequences: ``chol_block`` 2
      and ``tri_inv`` 3 a step, no other kernel; its ELBO, and
      ``fitc_diag_kl`` with its lengthscale gradient, against the CPU in
      float64 at the float32 jitter; ``evaluate`` of its checkpoint at
      ``--eval-batch 2`` (32 ``hist_panel``, 32 ``chol_block``, 31
      ``panel_solve``, the library's solve at T=4096), metrics and
      posterior mean against the CPU in float64, and its peak memory;
   i. ``t1024_toeplitz`` (BASELINE config 3) at its widths (B=8, T=1024,
      Z=2, one uniform grid, the fixed Toeplitz prior) 40 steps on fully
      observed toy sequences: exactly ``TOEP_LAUNCHES`` a step (the
      posterior bank's blocked factorization, its ``diag_logdet``, the
      backward's ``tri_inv``, one ``durbin``), no other kernel; its ELBO
      against the CPU in float64 under the T=1024 bands; its prior KL
      against the dense prior's on one batch of B=8; ``evaluate`` of its
      checkpoint (the T=1024 imputation: 8 ``hist_panel``, 8
      ``chol_block``, 7 ``panel_solve``, 1 ``tri_inv``);
   j. ``t1024_toeplitz``'s model with ``learn_prior_lengthscales`` at its
      widths, 40 steps: exactly ``TOEP_LEARN_LAUNCHES`` a step (i.'s and
      one ``durbin_bwd``), no other kernel; ``prior_log_ls`` moves and
      stays finite; its ELBO and every gradient, ``prior_log_ls``'s
      included, against the CPU in float64 under the T=1024 bands;
      ``evaluate`` of its checkpoint as in i.;
   k. ``steps_per_call``: ``syn_data`` at its widths 100 steps at k=25
      and ``t1024_toeplitz`` at its widths 20 steps at k=10, each over
      the Batcher's device-resident data and over a plain iterator of its
      batches, held bit for bit (every logged loss and parameter) against
      a k=1 run from the same seed and data; every run's launches exactly
      its path's a step (``gram_chol`` 1 and ``tri_inv`` 2;
      ``TOEP_LAUNCHES``);
   l. data parallelism: ``dp_scale`` (BASELINE config 5,
      ``t1024_toeplitz``'s model) through ``parallel.fit_data_parallel``
      on a world of one rank (NCCL, a file store), the global batch cut
      from 4096 to 128 on 512 toy sequences (its ``reduced`` field): one
      ``make_parallel_train_step`` bit for bit against ``train_step`` on
      the same global batch and noise, then 10 steps at k=1 and 10 at k=5
      (equal bit for bit), ``TOEP_LAUNCHES`` exactly a step, and the peak
      of ``utils.device_memory_stats``;
   m. ``t1024_toeplitz``'s model at T=8192 (``--time-len 8192``, the
      posterior bank [1, 2, 8192, 8192] in 64 column blocks; the Durbin
      kernels' long route), fully observed toy sequences on the unit grid
      0 .. 8191, 10 steps with the fixed prior and 10 with
      ``learn_prior_lengthscales``: exactly ``toeplitz_launches(8192)`` a
      step (one ``durbin`` call, its 257 kernels, and one ``durbin_bwd``
      call, its 514, with the learned prior), no other kernel; the prior KL against the dense prior's on
      a batch of 2 (as in i.; a float64 ELBO on the CPU at T=8192 would
      take minutes); ``evaluate`` of the fixed prior's checkpoint on one
      sequence (64 ``hist_panel``, 64 ``chol_block``, 63
      ``panel_solve``, the library's solve) against the CPU in float64;
   f. ``ops.chol.cholesky(method="blocked_fused")`` of a pre-built bank
      at T=1024, N=128, forward and backward: exactly 8 ``chol_block``
      (7 with L^-1), 7 ``trail_panel`` and 7 ``trail_update`` launches,
      no other factorization kernel and no library call, its gradient
      against ``method="xla"`` in float64; ``"blocked_fused_64"`` at
      T=256 (4 blocks); ``gp.chol_gram_bank(impl="xla")`` against
      ``impl="auto"`` at T=1024;
5. timing: train steps/s and device µs per step of each path (the zoo's
   too), ``gram_chol`` and ``tri_inv`` at the zoo's N=1000, T=20 and
   ``chol_block`` at its evaluate bank, and each
   kernel at its main-path shape against its plain version, the one
   PyTorch call that computes the same function where there is one, and
   the least time the card could take: CUDA-event medians of back-to-back
   calls, and the card's own time per call from ``torch.profiler``
   (``gram_chol_fused`` must be one kernel a call); ``chol_block`` with
   L^-1 and in its gram mode; the T=1024 evaluate path's sequences
   imputed per second; ``hist_panel`` and the whole pre-built
   factorization at the path's N=64, T=1024; ``tri_inv`` also at the
   T=1024 flat route's base call (N=1,024 matrices of 64); ``diag_logdet``
   on the whole stacked training bank (N=128), its bound one 32-byte
   sector per diagonal element;
   ``trail_panel`` and ``trail_update`` at the T=1024, N=128 middle step,
   and ``cholesky`` under ``auto``, ``blocked_fused`` and ``xla`` at
   (T, N) in {(256, 512), (512, 256), (1024, 128)}; the two BASELINE
   paths' steps/s and their evaluate calls, ``gram_chol`` (Cauchy, N=128,
   T=10), ``chol_block`` and ``tri_inv`` (N=64, m=64) and the pre-built
   factorization at T=4096 (N=16); ``t1024_toeplitz``'s steps/s, its
   evaluate call, its prior KL by both routes, the posterior bank's
   kernels at N=2, T=1024, and the Durbin kernel at T=1024 and 4096
   beside its plain version, the library's dense Cholesky and logdet, its
   bound and its chain floor, and on its long route at T in {8192, 16384,
   65536} (the reverse to 16384; there the plain versions' times are
   phase 6's); its reverse beside ``durbin_bwd_plain``,
   autograd of the plain forward, the library's autograd of the dense
   Cholesky and logdet, its bound and its chain floor; the learned
   prior's steps/s and device µs a step, and both at T=8192 (4m);
   ``syn_data``'s steps/s at k=1 and at k=25, in turns; the Cholesky
   backward's kernel at T=1024 (N=128) and T=8192 (N=2) beside its plain
   version, the 2 x 2-blocked library products it replaces, and its
   bound at the tensor cores' 3xTF32 rate.
6. the Durbin kernels' long route (above T=4096) against their plain
   versions in float64 on the card, after every profiled window of phase
   5 (the plain versions' millions of eager launches stay out of the
   windows the profiler reads): the forward at T in ``DURBIN_LONG_TS``
   (4097 to 65536) on the preset's rows, the reverse at 8192 on them, at
   4097 on a clamped row and at 16384 on a near-singular one, and the
   logdet against the library's dense float64 Cholesky on the card at
   8192 and 16384; each call's kernels counted exactly
   (:func:`durbin_kernels`); each plain call timed once.

Then one JSON line with the kernels' results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
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
# T = 1024 (noise 1e-3, cond(K) ~ 2e5): the t1024 row of the same table,
# KL rel 1.4e-3 and dKL/dlog ls rel 3.1e-3.  Each band of phase 4 is that
# band or 4x the error of the same model's float32 plain route on the CPU
# (the library's float32 error on the same batch), whichever is larger.
# The lengthscale gradient's error is set by the float32 prior gram the
# KL reads (cond ~2e5): with each entry built in float32 it was 6.5e-3 to
# 1.2e-2 on an H100, 2-7x the CPU float32 route's; built in float64 and
# rounded once (csrc/gram.cuh) 3.7e-4 to 1.7e-3, against the CPU's 4.0e-3
# to 5.9e-3.
KL_REL_TERMS_T1024 = 1.4e-3
LOG_LS_GRAD_REL_T1024 = 3.1e-3
ELBO_VS_LIBRARY = 4.0
# The zoo's conv nets (phase 4e): every ReLU's input on the card within
# 1e-4 (the loss band) of its largest float64 entry.  Where a float32
# input lies within its rounding of 0 the card and float64 may put it on
# either side of the kink, and the gradient then differs by that unit's
# whole share: on an H100, gp_prior_diag's gradient missed float64 by
# 2.8e-3 on one batch where the CPU's float32 missed by 1.3e-6, and
# full_gp_dynamic's CPU float32 gradient by 2.75e-4 on another where the
# card's missed by 5.4e-7.  The zoo's gradients are therefore held against
# float64 on the same side of each kink as the run it judges.
PREACT_REL = 1e-4
# the batches (toy data and noise from each seed) of phase 4's comparison
ELBO_SEEDS = (7, 8, 9, 10)
# Phase 3, the pre-built bank: ops.chol.cholesky within 2.5x the library's
# own float32 error of float64 (the gram-path factorization reached 1.89x
# on an H100), floored at L_MAX_ABS; hist_panel and the triangular solve
# against float64.
CHOL_VS_LIBRARY = 2.5
PANEL_ABS = 1e-4
TRSM_REL = 1e-4
# The right-looking route (method "blocked_fused", "blocked", and
# "blocked_fused_64") multiplies each panel by the diagonal block's
# explicit inverse, as the TPU does: in float32 that left the factor 3-4x
# the library's error of float64 in a CPU emulation, and more on masked
# banks whose diagonal blocks are ill-conditioned.  Its
# band is 5x the library's float32 error, or 2x the error of the same
# algorithm on its plain versions in float32 on the card (library factor,
# triangular solve for the inverse, cuBLAS products), whichever is larger,
# floored at L_MAX_ABS.  The other methods keep CHOL_VS_LIBRARY.
FUSED_VS_LIBRARY = 5.0
FUSED_VS_PLAIN = 2.0
FUSED_METHODS = ("blocked", "blocked_fused", "blocked_fused_64")
# trail_panel and trail_update against their float64 plain versions on the
# same inputs, per element, over the sum of the magnitudes of the terms
# (|P| |Ld^-T|, and |S| + |X| |X|^T): depth <= 128 float32 roundings
TERMS_REL = 1e-5
# Phase 4, the blocked_fused path's gradient (sum(L * W), W standard
# normal) against method="xla" in float64, as one vector: 1e-3, or 5x the
# float32 library route's own error (same reverse mode), whichever is
# larger
FUSED_GRAD_REL = 1e-3
# Phase 4, the evaluate path on the card (float32, kernels) against the
# same restored model on the CPU (float64, plain versions), same kept mask
# and noise: the posterior mean's max abs error over its largest entry,
# each metric's relative error, and a posterior draw's max abs error over
# its largest entry; each widened to ELBO_VS_LIBRARY x the same model's
# float32 error on the CPU where that is larger.
IMPUTE_MEAN_REL = 1e-4
METRIC_REL = 1e-4
SAMPLE_REL = 1e-3
METRICS = ("nll_gp_impute", "mse_gp_impute", "nll_baseline", "mse_baseline")
PIXEL_METRICS = ("nll_model", "mse_model", "nll_marginal_baseline",
                 "mse_marginal_baseline")

SYN_B, SYN_T, SYN_Z, SYN_D = 20, 45, 2, 15
MAIN_STEPS = 400
BENCH_B, BENCH_T = 32, 100
BENCH_STEPS = 300
LONG_T = 1024
LONG_STEPS = 20
# phase 3's sides of gram_chol and chol_block: both sides of multiples of
# the panel width 16 (csrc/chol_tile.cuh), ragged last panels included
GRAM_CHOL_TS = (1, 8, 15, 16, 17, 31, 32, 33, 45, 63, 64)
CHOL_BLOCK_TS = (1, 15, 16, 17, 31, 32, 33, 45, 63, 64, 65, 100, 127, 128)
# the sides of phase 3's pre-built banks: one chol_block launch (45, 100),
# the blocked loop, whole blocks and a ragged last one (1000)
PREBUILT_TS = (SYN_T, BENCH_T, 256, 1000, LONG_T)
# the reference model zoo on Moving-MNIST (phase 4): 64 x 64 frames,
# T=20, Z=100, B=5; (preset, steps, evaluate its checkpoint or not)
ZOO_T, ZOO_Z, ZOO_SIDE = 20, 100, 64
ZOO_PATHS = (("full_gp_dynamic", 100, True), ("gp_prior_diag", 100, True),
             ("full_gp_fixed", 20, False), ("gp_recog", 20, False),
             ("vanilla_vae", 20, False))
# each zoo path's launches a training step, every other counter 0: one
# gram_chol of the bank its pair needs, one tri_inv in a GP prior's KL,
# and one in the Cholesky backward where a lengthscale is learned
# (gp_prior_diag's fixed prior needs none)
ZOO_LAUNCHES = {"full_gp_dynamic": {"gram_chol": 1, "tri_inv": 2},
                "gp_prior_diag": {"gram_chol": 1, "tri_inv": 1},
                "full_gp_fixed": {"gram_chol": 1, "tri_inv": 2},
                "gp_recog": {"gram_chol": 1, "tri_inv": 1},
                "vanilla_vae": {}}
# synthetic videos of the zoo paths: 128 train, 16 valid, 16 test (the
# test split is the evaluate path's batch: N = 16 x 100 factors)
ZOO_SEQS = 160
ZOO_EVAL_B = 16
# steps in each timed window of a zoo path (phase 5)
ZOO_WINDOW = 20
# the error evaluate raises on vanilla_vae, as the JAX package's does
# (gpvae_tpu/analysis.py:346-353)
VANILLA_EVAL_ERROR = "lengthscales (9.0, 3.0) incompatible with Z=100"

# BASELINE config 2, healing_mnist at its widths (phase 4g): 28 x 28 frames,
# T=10, Z=64, B=64, the Cauchy kernel on one grid shared by the batch;
# synthetic healing sequences from seed 0, split as the CLI splits them
# (144 train, the last 16 the evaluate batch)
HEAL_T, HEAL_Z, HEAL_B = 10, 64, 64
HEAL_STEPS = 100
HEAL_SEQS = 160
HEAL_EVAL_B = 16
# phase 3's Cauchy sides of gram_chol at healing's N = 2Z: its T=10, and
# ragged last panels above one panel of 16
CAUCHY_TS = (HEAL_T, 17, 33)
# BASELINE config 4, sparse_t4096 at its widths (phase 4h): T=4096, Z=8,
# B=8, m=64 inducing points over [0, 4096].  Training and the ELBO take toy
# sequences on the unit grid 0 .. 4095, the inducing grid's range (the
# CLI's toy data lie on 0 .. 60: ROADMAP, "Found in the reference");
# evaluate takes the CLI's own, 20 sequences of which it scores the last 2
SPARSE_T, SPARSE_Z, SPARSE_B, SPARSE_M = 4096, 8, 8, 64
SPARSE_STEPS = 100
SPARSE_SEQS = 32
SPARSE_XMAX = 4095.0
SPARSE_EVAL_B = 2
# the FITC jitter of a float32 run (sparse._resolve_jitter), given to the
# float64 side of every sparse comparison: float64's own default (1e-6) is
# another prior by design
SPARSE_JITTER = 1e-4
# the sparse_t4096 row of the float64-oracle accuracy table (BASELINE.md):
# KL rel 9.8e-4 (of |KL|), dKL/dlog ls rel 1.0e-2
SPARSE_KL_REL = 9.8e-4
SPARSE_LOG_LS_GRAD_REL = 1.0e-2
# the batches of phase 4h's fitc_diag_kl comparison
FITC_SEEDS = (11, 12, 13, 14)
# launches a training step, every other counter 0: healing's one stacked
# Cauchy bank, the KL's inverse of L_p and the Cholesky backward's (the
# learned posterior lengthscale); FITC's K_mm and B, and its three solves
# (L_mm twice, as the JAX package solves, and L_B) with no backward
# through them (the prior lengthscale is fixed)
HEAL_LAUNCHES = {"gram_chol": 1, "tri_inv": 2}
SPARSE_LAUNCHES = {"chol_block": 2, "tri_inv": 3}

# BASELINE config 3, t1024_toeplitz at its widths (phase 4i): T=1024, Z=2,
# B=8, dense nets, one uniform grid 0 .. 60 shared by the batch, a fixed
# Toeplitz prior at (9, 3), the posterior's lengthscales learned; fully
# observed toy sequences (the CLI's toy_full family)
TOEP_T, TOEP_Z, TOEP_B = 1024, 2, 8
TOEP_STEPS = 40
TOEP_SEQS = 256
TOEP_EVAL_B = 8
TOEP_WINDOW = 10
# launches a training step, every other counter 0: the posterior bank
# [1, 2, T, T] factored blocked (8 column blocks of 128: gram_panel 8,
# chol_block 8, panel_solve 7), its logdet (diag_logdet 1), the Cholesky
# backward's flat tri_inv (1) and its three passes (chol_bwd 3), the
# prior's Durbin recursion (1); no prior factorization and no tri_inv of
# L_p
TOEP_LAUNCHES = {"gram_panel": 8, "chol_block": 8, "panel_solve": 7,
                 "diag_logdet": 1, "tri_inv": 1, "chol_bwd": 3,
                 "durbin": 1, "durbin_kernels": 1}
# the Durbin kernel against its float64 plain version on the same float64
# inputs: logdet and e relative, a and b over max |a|
DURBIN_REL = 1e-9
# the Durbin kernel's sides in phase 3: one and two steps, a ragged warp,
# the preset's T and one past it (8 lags a thread), the kernel's largest
DURBIN_TS = (2, 3, 33, TOEP_T, TOEP_T + 1, 4096)
# the reverse kernel against durbin_bwd_plain on the same kept steps and
# against autograd of durbin_plain, all float64, max error over max
# |reference|, stated before its first card run: the plain reverse's own
# distance to float64 autograd on the CPU was at most 2e-12 (the
# near-singular T=4096 rows), the kernel's logic run on the CPU 2e-11
DURBIN_BWD_REL = 1e-9
# the learnable Toeplitz prior (phase 4j): t1024_toeplitz's model with
# learn_prior_lengthscales; a step adds the reverse kernel's one launch
TOEP_LEARN_LAUNCHES = {**TOEP_LAUNCHES, "durbin_bwd": 1,
                       "durbin_bwd_kernels": 1}
# the Durbin kernels' long route (above T = 4096: a window of 32 steps a
# launch).  Phase 3: the forward against its plain version at
# DURBIN_LONG_TS on the preset's rows (Z=2; at DURBIN_NEAR_T on the
# near-singular row below instead), the reverse against
# durbin_bwd_plain and autograd at DURBIN_LONG_BWD_TS on them, at 4097 on
# a clamped row and at 16384 on a near-singular one (lengthscale 64 on the
# unit grid, Z=1: autograd of the plain forward keeps ~17 GB a row
# there), and the logdet against the library's dense float64 Cholesky on
# the card at DURBIN_DENSE_TS; bands DURBIN_REL and DURBIN_BWD_REL
DURBIN_LONG_TS = (4097, 8192, 16384, 65536)
DURBIN_LONG_BWD_TS = (8192,)
DURBIN_DENSE_TS = (8192, 16384)
# T=16384 is held on the near-singular row alone (forward, reverse, dense)
DURBIN_NEAR_T = 16384
# t1024_toeplitz's model at T=8192 (phase 4m): the CLI's toy_full
# sequences at --time-len 8192, the posterior bank [1, 2, 8192, 8192] in
# 64 column blocks; steps of each training run (the fixed prior and the
# learned one), the sequences they draw from, steps in each timed window
# (phase 5), and the sequences its evaluate call generates (the CLI
# scores the last 10%: one, --eval-batch 1)
TOEP_LONG_T = 8192
TOEP_LONG_STEPS = 10
TOEP_LONG_SEQS = 32
TOEP_LONG_WINDOW = 3
TOEP_LONG_EVAL_SEQS = 10
# multi-step training (phase 4k): steps a run and the steps a call of
# the k-step runs, each held bit for bit against a k=1 run from the same
# seed and data, on syn_data's widths and on t1024_toeplitz's; launches
# a step of syn_data's path (one factorization, the KL's and the
# backward's inverse)
KSTEP_PATHS = (("syn_data", 100, 25), ("t1024_toeplitz", 20, 10))
SYN_LAUNCHES = {"gram_chol": 1, "tri_inv": 2}
# phase 5's steps/s of syn_data at k=1 and k=25, in turns: steps a timed
# run, rows (windows) a run
KSTEP_TIME_STEPS, KSTEP_TIME_WINDOWS = 250, 5
# data parallelism (phase 4l): dp_scale (t1024_toeplitz's model, BASELINE
# config 5) through fit_data_parallel on a world of one rank (NCCL), the
# global batch of 4096 cut to DP_B on DP_SEQS toy_full sequences; steps
# at k=1 and at k=DP_K, each with TOEP_LAUNCHES exact a step
DP_B, DP_SEQS, DP_STEPS, DP_K = 128, 512, 10, 5
# The Cholesky backward's kernel (csrc/chol_bwd.cu) at the two training
# shapes: K_bar against float64 on the same float32 inputs, max error over
# max |reference|, within CHOL_BWD_VS_PLAIN x the plain version's (the
# library's float32 products): the CPU emulation of the kernel's
# arithmetic (python -m gpvae_tpu_torch.ops.split_emulation --backward)
# puts each pass within 2x an FMA loop's error and K_bar within 1.9x; 3x
# for the library's own order of sums.  Its mean error away from zero over
# the mean magnitude (the tensor cores truncate their sums) within
# CHOL_BWD_BIAS: on an H100 it read -3.6e-7 (T=1024) and -4.0e-7 (T=8192),
# the library's -1.8e-9; 2.5x the kernel's reading, 5e-3 of the float32
# route's own error in the T=1024 lengthscale gradient it feeds
CHOL_BWD_VS_PLAIN = 3.0
CHOL_BWD_BIAS = 1e-6
CHOL_BWD_SHAPES = ((LONG_T, 2 * BENCH_B * SYN_Z), (TOEP_LONG_T, TOEP_Z))
# the Gohberg-Semencul identity K (K^-1 X) = X through the FFT route in
# float32 (max abs error over max |X|): BASELINE.md's float32 figure at
# T=4096 for the blocked Schur/Durbin (1.7e-3), or 4x the same route's
# error on the CPU in float32, whichever is larger
GS_IDENTITY_REL = 1.7e-3
# the Toeplitz prior KL against the dense prior's on the same batch, max
# over [B, Z] of |difference| / |dense|: BASELINE.md's T=1024 figure
# (4.5e-4), or 4x the same gap on the CPU in float32
TOEP_KL_VS_DENSE = 4.5e-4

# sequences each evaluate run generates (the CLI scores the last 10%)
EVAL_SEQS = {"syn_data": 200, "bench_t100": 320,
             "full_gp_dynamic": ZOO_SEQS, "gp_prior_diag": ZOO_SEQS,
             "healing_mnist": HEAL_SEQS, "sparse_t4096": 20,
             "t1024_toeplitz": 10 * TOEP_EVAL_B}
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores and HBM3 bandwidth; a bound is the larger of the two times
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float64 outside the tensor cores (the Durbin kernel's arithmetic)
PEAK_FP64_FLOPS = 34e12
# DRAM moves whole 32-byte sectors: a strided gather of floats (the
# diagonal, stride T + 1) moves one sector per element
SECTOR_BYTES = 32
# dense TF32 on the tensor cores: the floor of the panel tile's kernels,
# which multiply float32 operands as three products of TF32 parts
# (gram_panel.cu)
PEAK_TF32_FLOPS = 495e12
# operations counted per gram element built in a kernel (difference,
# scale, square, exp, variance, noise, two mask products)
GRAM_OPS = 8
# calls in each profiled window of phase 5's kernel timing
PROFILED_CALLS = 20

SOURCES = ("gram_chol", "tri_inv", "chol_block", "gram_panel",
           "panel_solve", "diag_logdet", "durbin", "chol_bwd")
# the method comparison of phase 5: the JAX package's crossover shapes
METHOD_SHAPES = ((256, 512), (512, 256), (1024, 128))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# the script's start, for each phase line's "seconds" since it
T_START = time.perf_counter()


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields,
                      "t_seconds": time.perf_counter() - T_START}),
          flush=True)


def kernel_name(mangled: str) -> str:
    """``chol_block_kernel<0,1>`` from the kernel's mangled name."""
    import re

    # a name is mangled as its length, then itself; its template's bool
    # and int arguments as L[bi]<value>E between I and E
    for m in re.finditer(r"(?=(\d+))", mangled):
        digits = m.group(1)
        end = m.start() + len(digits)
        name = mangled[end:end + int(digits)]
        if name.endswith("_kernel"):
            args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[end + len(name):])
            if not args:
                return name
            values = re.findall(r"L[bi](\d+)E", args.group(1))
            return f"{name}<{','.join(values)}>"
    return mangled


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, budget_ms: float = 60.0, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of one call of ``fn`` over
    back-to-back calls (as many as fit ``budget_ms``, 3 to 200), by CUDA
    events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    iters = int(min(200, max(3, budget_ms / max(start.elapsed_time(stop),
                                                1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    times.sort()
    return times[len(times) // 2]


def once_ms(fn) -> float:
    """One call of ``fn`` after one warm-up, by CUDA events: for the plain
    versions of the Durbin kernels, whose hundreds of milliseconds a call
    are the host's."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def device_profile(fn, calls: int = 1, kernel: str | None = None,
                   label: str = "") -> dict:
    """``calls`` back-to-back calls of ``fn`` under ``torch.profiler``,
    after as many calls in a warm-up cycle whose events are dropped (the
    first kernels of a window otherwise go missing from the trace).  Per
    call: ``device_us``, the summed durations of the kernels it ran on the
    card (user annotations left out), ``kernels``, their number, and
    ``wall_us``, the host's time; and ``top``, the eight kernel names that
    took most of the device time, with their µs per call.  With ``kernel``
    (a launch counter's name): ``kernel_us``, the mean duration of that
    hand-written kernel's launches, ``kernel_seen``, how many the profiler
    saw, and ``kernel_counted``, how many its counter counted.  A window
    in which the profiler saw no kernel at all is taken again, up to three
    windows in all (``empty_windows`` counts them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for empty in range(3):
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traces.append(list(p.events()))
                     ) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
            before = read_counts()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts()
            prof.step()
        if len(traces) != 1:
            fail(f"{label}: the profiler returned {len(traces)} traces, "
                 f"not 1")
        kernels = [e for e in traces[0]
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        if kernels:
            break
    else:
        fail(f"{label}: the profiler saw no kernel on the card in three "
             f"windows")
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_us": busy / calls, "kernels": len(kernels) / calls,
           "wall_us": wall * 1e6 / calls, "empty_windows": empty,
           "top": [(n[:80], us / calls) for n, us in top]}
    if kernel is not None:
        symbol = f"{kernel}_kernel"  # the __global__ function's name
        mine = [e.time_range.elapsed_us() for e in kernels if symbol in e.name]
        if not mine:
            fail(f"{label}: the profiler saw no {symbol} on the card")
        out.update(kernel_us=sum(mine) / len(mine), kernel_seen=len(mine),
                   kernel_counted=after[kernel] - before[kernel])
    return out


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: bytes over its memory rate or
    float32 operations over ``peak_flops`` (the CUDA cores' rate unless
    given), whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- launch counters ----------------------------------------------------------

def counters():
    """``{kernel: (module, attribute)}`` of every launch counter."""
    from gpvae_tpu_torch.ops import (
        blocked, chol_block, chol_bwd, durbin, gram_chol, logdet, trail,
        tri_inv,
    )
    return {"gram_chol": (gram_chol, "LAUNCHES"),
            "tri_inv": (tri_inv, "LAUNCHES"),
            "chol_bwd": (chol_bwd, "LAUNCHES"),
            "chol_block": (chol_block, "LAUNCHES"),
            "gram_panel": (blocked, "PANEL_LAUNCHES"),
            "panel_solve": (blocked, "SOLVE_LAUNCHES"),
            "diag_logdet": (logdet, "LAUNCHES"),
            "hist_panel": (blocked, "HIST_LAUNCHES"),
            "trail_panel": (trail, "PANEL_LAUNCHES"),
            "trail_update": (trail, "UPDATE_LAUNCHES"),
            "durbin": (durbin, "LAUNCHES"),
            "durbin_bwd": (durbin, "BWD_LAUNCHES"),
            # the kernels those calls launched (the long route's windows)
            "durbin_kernels": (durbin, "KERNEL_LAUNCHES"),
            "durbin_bwd_kernels": (durbin, "BWD_KERNEL_LAUNCHES")}


def durbin_kernels(t, bwd=False) -> int:
    """The kernels one call of the Durbin recursion launches at sequence
    length ``t`` (``bwd``: its reverse): one up to T = 4096; above it one
    a window of 32 steps and a finishing one, and in reverse two a window,
    a starting and a finishing one."""
    if t <= 4096:
        return 1
    windows = -(-(t - 1) // 32)
    return 2 * windows + 2 if bwd else windows + 1


def reset_counts() -> None:
    for module, attr in counters().values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in counters().items()}


@contextlib.contextmanager
def plain_versions():
    """Every wrapper takes its plain PyTorch version, also on the card:
    for timing the plain versions of composite functions only."""
    from gpvae_tpu_torch.ops import dispatch

    real = dispatch.on_cuda
    dispatch.on_cuda = lambda t: False
    try:
        yield
    finally:
        dispatch.on_cuda = real


@contextlib.contextmanager
def library_calls():
    """Counts the calls of ``torch.linalg.cholesky``, ``cholesky_ex`` and
    ``solve_triangular`` made inside the block: the plain versions'
    factorization and solve, which a path on the kernels never calls."""
    import torch

    counts = {"cholesky": 0, "cholesky_ex": 0, "solve_triangular": 0}
    real = {name: getattr(torch.linalg, name) for name in counts}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(torch.linalg, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(torch.linalg, name, fn)


# -- inputs -------------------------------------------------------------------

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


def flat_inputs(rng, n, t, dev, masked=True):
    """A flat bank ``times, mask [n, t]`` (float mask), ``ls, var [n]``."""
    from gpvae_tpu_torch.ops import gram_chol

    times, ls, mask, var = bank_inputs(rng, n, t, 1, masked, dev)
    return gram_chol.flat_bank(times, ls, mask, var)


def check_l(name, l, ref, lib,
            vs_library: float = L_VS_LIBRARY) -> tuple[float, float]:
    """Max abs error of the factor ``l`` against the float64 ``ref`` and
    its ratio to the library's float32 factor ``lib``; fails outside the
    band (``L_MAX_ABS`` or ``vs_library`` x the library's error) or on a
    nonzero strict upper triangle."""
    import torch

    err = (l.double() - ref).abs().max().item()
    err_lib = (lib.double() - ref).abs().max().item()
    band = max(L_MAX_ABS, vs_library * err_lib)
    if not math.isfinite(err) or err > band:
        fail(f"{name}: max abs err {err:.3e} > {band:.3e} (library "
             f"float32: {err_lib:.3e})")
    if bool((torch.triu(l, 1) != 0).any()):
        fail(f"{name}: strict upper triangle of L not zero")
    return err, err / max(err_lib, 1e-30)


def check_inverse(name, x, l) -> tuple[float, float]:
    """Relative Frobenius error of ``x`` against the float64 inverse of
    the float32 factor ``l`` it inverts: 1e-4, or 4x the library's
    float32 inverse (``solve_triangular``), whichever is larger."""
    import torch

    from gpvae_tpu_torch.ops import tri_inv

    ref = tri_inv.tri_inv_plain(l.double())
    lib = tri_inv.tri_inv_plain(l)

    def rel(a):
        return (torch.linalg.matrix_norm(a.double() - ref)
                / torch.linalg.matrix_norm(ref)).max().item()

    err, err_lib = rel(x), rel(lib)
    band = max(TRI_INV_REL_FRO, L_VS_LIBRARY * err_lib)
    if not math.isfinite(err) or err > band:
        fail(f"{name}: rel Frobenius err {err:.3e} > {band:.3e} (library "
             f"float32: {err_lib:.3e})")
    if bool((torch.triu(x, 1) != 0).any()):
        fail(f"{name}: strict upper triangle of L^-1 not zero")
    return err, (x.double() - ref).abs().max().item()


# -- phase 3 ------------------------------------------------------------------

def check_kernels(dev) -> dict:
    """Phase 3, the two kernels of the syn_data path.  Returns the worst
    error of each kernel."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import gram_chol, tri_inv

    rng = np.random.default_rng(0)
    z = 2 * SYN_Z  # the stacked posterior + prior bank
    worst = {"gram_chol": 0.0, "gram_chol_vs_library": 0.0,
             "tri_inv_abs": 0.0, "tri_inv_rel": 0.0}
    cases = 0
    for t in GRAM_CHOL_TS:
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
                    err, ratio = check_l(
                        f"gram_chol {kernel} T={t} N={n} masked={masked}",
                        l, ref, lib32)
                    worst["gram_chol"] = max(worst["gram_chol"], err)
                    worst["gram_chol_vs_library"] = max(
                        worst["gram_chol_vs_library"], ratio)
                    cases += 1
                # tri_inv on the factor the main path hands it
                lf = gram_chol.gram_chol_fused(
                    times, ls, mask=mask, variance=var).reshape(-1, t, t)
                x = tri_inv.tri_inv_cuda(lf.contiguous())
                rel, err = check_inverse(f"tri_inv T={t} N={n}", x, lf)
                worst["tri_inv_rel"] = max(worst["tri_inv_rel"], rel)
                worst["tri_inv_abs"] = max(worst["tri_inv_abs"], err)
                cases += 1
    # what the kernels refuse, they refuse loudly
    try:
        tri_inv.tri_inv_cuda(torch.eye(4, dtype=torch.float64,
                                       device=dev)[None])
    except TypeError:
        pass
    else:
        fail("tri_inv accepted a float64 CUDA tensor")
    worst["cases"] = cases
    return worst


def check_zoo_kernels(dev) -> dict:
    """Phase 3, the zoo's shapes at T=20 (Z=100, B=5): ``gram_chol`` on
    the stacked bank of a GP posterior and prior (N=1000), a posterior's
    alone (N=500), and a shared grid's (one row of times 0..19, no mask:
    N=200 stacked, N=100 a side); ``tri_inv`` of each factor; and
    ``ops.chol.cholesky`` of evaluate's pre-built bank (16 sequences x
    100 latents, N=1600, masked, one ``chol_block`` launch) and
    ``tri_inv`` of its factor.  Returns the worst error of each."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol, chol_block, gram_chol, tri_inv

    rng = np.random.default_rng(5)
    t = ZOO_T
    worst = {"zoo_gram_chol": 0.0, "zoo_gram_chol_vs_library": 0.0,
             "zoo_tri_inv_rel": 0.0, "zoo_tri_inv_abs": 0.0,
             "zoo_cholesky": 0.0, "zoo_cholesky_vs_library": 0.0}
    cases = 0
    grid = torch.arange(t, dtype=torch.float32, device=dev)
    for b, z, masked in ((5, 2 * ZOO_Z, True), (5, ZOO_Z, True),
                         (5, 2 * ZOO_Z, False), (1, 2 * ZOO_Z, False),
                         (1, ZOO_Z, False)):
        times, ls, mask, var = bank_inputs(rng, b, t, z, masked, dev)
        if not masked:
            times, mask = grid.expand(b, t), None
        name = f"T={t} N={b * z} masked={masked}"
        l = gram_chol.gram_chol_fused(times, ls, mask=mask, variance=var)
        ref = gram_chol.gram_chol_plain(times.double(), ls.double(),
                                        mask=mask, variance=var.double())
        lib32 = gram_chol.gram_chol_plain(times, ls, mask=mask, variance=var)
        err, ratio = check_l(f"gram_chol {name}", l, ref, lib32)
        worst["zoo_gram_chol"] = max(worst["zoo_gram_chol"], err)
        worst["zoo_gram_chol_vs_library"] = max(
            worst["zoo_gram_chol_vs_library"], ratio)
        lf = l.reshape(-1, t, t)
        rel, err = check_inverse(f"tri_inv {name}",
                                 tri_inv.tri_inv_cuda(lf.contiguous()), lf)
        worst["zoo_tri_inv_rel"] = max(worst["zoo_tri_inv_rel"], rel)
        worst["zoo_tri_inv_abs"] = max(worst["zoo_tri_inv_abs"], err)
        cases += 2
    # evaluate's bank: each test sequence's kept steps, 100 latents, the
    # jitter posterior_conditional adds in float32
    times, ls, mask, var = bank_inputs(rng, 16, t, ZOO_Z, True, dev)
    eye = torch.eye(t, dtype=torch.float64, device=dev)
    k64 = kernels_lib.gram_bank(times.double(), ls.double(), mask=mask,
                                variance=var.double()) + 1e-5 * eye
    k = k64.float()
    before = chol_block.LAUNCHES
    l = chol.cholesky(k)
    if chol_block.LAUNCHES - before != 1:
        fail(f"cholesky of the [16, {ZOO_Z}, {t}, {t}] bank launched "
             f"chol_block {chol_block.LAUNCHES - before} times, not once")
    name = f"T={t} N={16 * ZOO_Z} pre-built"
    err, ratio = check_l(f"cholesky {name}", l, torch.linalg.cholesky(k64),
                         torch.linalg.cholesky(k), vs_library=CHOL_VS_LIBRARY)
    worst["zoo_cholesky"], worst["zoo_cholesky_vs_library"] = err, ratio
    lf = l.reshape(-1, t, t)
    rel, err = check_inverse(f"tri_inv {name}",
                             tri_inv.tri_inv_cuda(lf.contiguous()), lf)
    worst["zoo_tri_inv_rel"] = max(worst["zoo_tri_inv_rel"], rel)
    worst["zoo_tri_inv_abs"] = max(worst["zoo_tri_inv_abs"], err)
    worst["zoo_cases"] = cases + 2
    return worst


def check_large_t_kernels(dev) -> dict:
    """Phase 3, the kernels of the large-T path.  Returns the worst error
    of each kernel."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import blocked, chol_block, logdet, tri_inv

    rng = np.random.default_rng(2)
    worst = {"chol_block": 0.0, "chol_block_vs_library": 0.0,
             "chol_block_inv_rel": 0.0, "factorization": 0.0,
             "factorization_vs_library": 0.0, "gram_panel": 0.0,
             "panel_solve": 0.0, "diag_logdet": 0.0,
             "tri_inv_large_rel": 0.0, "tri_inv_large_abs": 0.0}
    cases = 0

    def gram64(times, mask, ls, var):
        return kernels_lib.gram(times.double(), ls.double()[:, None, None],
                                variance=var.double()[:, None, None],
                                mask=mask)

    # chol_block, both modes, with the inverse
    for t in (64, 100, 128):
        for n in (128, 1024):
            times, mask, ls, var = flat_inputs(rng, n, t, dev)
            k64 = gram64(times, mask, ls, var)
            ref = torch.linalg.cholesky(k64)
            lib = torch.linalg.cholesky(k64.float())
            for mode in ("gram", "prebuilt"):
                if mode == "gram":
                    l, x = chol_block.gram_chol_block(times, mask, ls, var,
                                                      inverse=True)
                else:
                    l, x = chol_block.chol_block(k64.float(), inverse=True)
                name = f"chol_block {mode} T={t} N={n}"
                err, ratio = check_l(name, l, ref, lib)
                rel, _ = check_inverse(name, x, l)
                worst["chol_block"] = max(worst["chol_block"], err)
                worst["chol_block_vs_library"] = max(
                    worst["chol_block_vs_library"], ratio)
                worst["chol_block_inv_rel"] = max(
                    worst["chol_block_inv_rel"], rel)
                cases += 1
    # the other sides, with and without L^-1 (their own draws, so that the
    # banks below stay those of earlier runs)
    rng_sides = np.random.default_rng(5)
    for t in sorted(set(CHOL_BLOCK_TS) - {64, 100, 128}):
        times, mask, ls, var = flat_inputs(rng_sides, 128, t, dev)
        k64 = gram64(times, mask, ls, var)
        ref = torch.linalg.cholesky(k64)
        lib = torch.linalg.cholesky(k64.float())
        for mode in ("gram", "prebuilt"):
            for inverse in (False, True):
                if mode == "gram":
                    l, x = chol_block.gram_chol_block(times, mask, ls, var,
                                                      inverse=inverse)
                else:
                    l, x = chol_block.chol_block(k64.float(),
                                                 inverse=inverse)
                name = f"chol_block {mode} T={t} inverse={inverse}"
                err, ratio = check_l(name, l, ref, lib)
                worst["chol_block"] = max(worst["chol_block"], err)
                worst["chol_block_vs_library"] = max(
                    worst["chol_block_vs_library"], ratio)
                if inverse:
                    rel, _ = check_inverse(name, x, l)
                    worst["chol_block_inv_rel"] = max(
                        worst["chol_block_inv_rel"], rel)
                cases += 1
    # in place at a row stride, nothing written outside the block
    times, mask, ls, var = flat_inputs(rng, 64, 128, dev)
    k64 = gram64(times, mask, ls, var)
    big = torch.full((64, 200, 200), float("nan"), device=dev)
    big[:, 40:168, 30:158] = k64.float()
    d = big[:, 40:168, 30:158]
    chol_block.chol_block(d, out=d)
    check_l("chol_block in place", d, torch.linalg.cholesky(k64),
            torch.linalg.cholesky(k64.float()))
    outside = big.clone()
    outside[:, 40:168, 30:158] = float("nan")
    if not bool(torch.isnan(outside).all()):
        fail("chol_block in place wrote outside its block")
    cases += 1

    # the blocked factorization, and each of its kernels on its own
    for t in (256, LONG_T):
        for n in (16, 128):
            times, mask, ls, var = flat_inputs(rng, n, t, dev)
            l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
            k64 = gram64(times, mask, ls, var)
            ref = torch.linalg.cholesky(k64)
            err, ratio = check_l(f"factorization T={t} N={n}", l, ref,
                                 torch.linalg.cholesky(k64.float()))
            worst["factorization"] = max(worst["factorization"], err)
            worst["factorization_vs_library"] = max(
                worst["factorization_vs_library"], ratio)
            del k64, ref
            cases += 1
    # gram_panel and panel_solve at the main path's middle step (T=1024,
    # o=512) on the factorization's own factor, against their plain versions in
    # float64 on the same inputs
    o, w = LONG_T // 2, 128
    got, ref = l.clone(), l.double()
    blocked.gram_panel(got, times, mask, ls, var, o, o, w)
    blocked.gram_panel_plain(ref, times.double(), mask.double(), ls.double(),
                             var.double(), o, o, w)
    worst["gram_panel"] = (got.double() - ref).abs().max().item()
    got, ref = l.clone(), l.double()
    blocked.panel_solve(got, o, w)
    blocked.panel_solve_plain(ref, o, w)
    worst["panel_solve"] = (got.double() - ref).abs().max().item()
    if not (worst["gram_panel"] <= 1e-4 and worst["panel_solve"] <= 1e-4):
        fail(f"panel kernels vs plain: gram_panel {worst['gram_panel']:.3e},"
             f" panel_solve {worst['panel_solve']:.3e} (band 1e-4)")
    del got, ref
    cases += 2

    # diag_logdet on the factor, whole, as the stacked training bank (the
    # main path's one call a step) and as a strided half of it
    lv = l.reshape(BENCH_B, 2 * SYN_Z, LONG_T, LONG_T)
    for view in (l, lv, lv[:, SYN_Z:]):
        got = logdet.logdet_from_chol(view)
        ref = logdet.diag_logdet_plain(view.double())
        err = (got.double() - ref).abs().max().item()
        if not err <= 1e-5 * (1.0 + ref.abs().max().item()):
            fail(f"diag_logdet: abs err {err:.3e}")
        worst["diag_logdet"] = max(worst["diag_logdet"], err)
        cases += 1

    # tri_inv at the two large-T routes: blocked at T=100, flat at 1024
    for t, n in ((BENCH_T, 64), (LONG_T, 64)):
        times, mask, ls, var = flat_inputs(rng, n, t, dev)
        lf = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
        rel, err = check_inverse(f"tri_inv T={t}", tri_inv.tri_inv(lf), lf)
        worst["tri_inv_large_rel"] = max(worst["tri_inv_large_rel"], rel)
        worst["tri_inv_large_abs"] = max(worst["tri_inv_large_abs"], err)
        cases += 1
    worst["large_t_cases"] = cases
    return worst


# (N, T, o, w, column offset of a view or None) of phase 3's panel_solve
# cases: the two paths' middle step, rows that are no multiple of the row
# tile (64 or 128), o = 3 (4-byte copies), w = 1 and 16, and a view
SOLVE_CASES = ((128, LONG_T, LONG_T // 2, 128, None),
               (64, LONG_T, LONG_T // 2, 128, None),
               (128, 300, 0, 128, None), (64, 300, 3, 100, None),
               (128, 300, 37, 1, None), (64, 300, 128, 16, None),
               (64, 300, 128, 128, 4), (64, 300, 128, 128, 5))


def solve_at(view, o, w) -> None:
    """``panel_solve``'s C entry point on a view of L at its own matrix and
    row strides (the wrapper takes contiguous banks only)."""
    import torch

    from gpvae_tpu_torch.ops import _build, blocked

    lib = _build.load("panel_solve", blocked._SOLVE_ENTRY_POINTS)
    status = lib.gpvae_panel_solve_f32(
        view.data_ptr(), view.stride(0), view.stride(1), o, w,
        view.shape[1], view.shape[0],
        torch.cuda.current_stream().cuda_stream)
    _build.check_status(lib, status, "panel_solve")


def check_solve_case(l64, o, w, col=None) -> float:
    """``panel_solve`` on the factored block ``L_d`` of the float64 factor
    ``l64 [N, T, T]`` and the panel below it as the factorization hands it
    over (P = L[o+w:, o:o+w] L_d^T), the rest of L noise, in float32 (in a
    view at column offset ``col`` where given): against the plain version
    in float64 on the same inputs (band ``PANEL_ABS``), the zero tile
    exactly zero, and nothing else written.  Returns the max abs error."""
    import torch

    from gpvae_tpu_torch.ops import blocked

    n, t, _ = l64.shape
    dev = l64.device
    l = torch.randn((n, t, t), dtype=torch.float64, device=dev)
    d = l64[:, o:o + w, o:o + w]
    l[:, o:o + w, o:o + w] = d
    l[:, o + w:, o:o + w] = l64[:, o + w:, o:o + w] @ d.mT
    l = l.float()
    ref = l.double()
    blocked.panel_solve_plain(ref, o, w)
    name = f"panel_solve N={n} T={t} o={o} w={w} view={col}"
    if col is None:
        got = l.clone()
        blocked.panel_solve(got, o, w)
    else:
        big = torch.full((n, t + 6, t + 16), float("nan"), device=dev)
        big[:, 3:t + 3, col:t + col] = l
        got = big[:, 3:t + 3, col:t + col]
        solve_at(got, o, w)
        outside = big.clone()
        outside[:, 3:t + 3, col:t + col] = float("nan")
        if not bool(torch.isnan(outside).all()):
            fail(f"{name}: wrote outside the view")
    torch.cuda.synchronize()
    err = (got.double() - ref).abs().max().item()
    if not err <= PANEL_ABS:
        fail(f"{name}: max abs err {err:.3e} > {PANEL_ABS:.0e}")
    if not bool((got[:, o:o + w, o + w:] == 0).all()):
        fail(f"{name}: the zero tile is not zero")
    keep = torch.ones((t, t), dtype=torch.bool, device=dev)
    keep[o + w:, o:o + w] = False
    keep[o:o + w, o + w:] = False
    if not torch.equal(got[:, keep], l[:, keep]):
        fail(f"{name}: wrote outside the panel and the zero tile")
    return err


def check_hist_case(l64, k, r0, o, w) -> float:
    """``hist_panel`` on the float32 rounding of the factor ``l64 [N, T,
    T]`` of ``k`` (its own history) against its plain version in float64
    on the same inputs (band ``PANEL_ABS``), ``k`` read, never written.
    Returns the max abs error."""
    import torch

    from gpvae_tpu_torch.ops import blocked

    n, t, _ = l64.shape
    k_copy = k.clone()
    got = l64.float().contiguous()
    ref = got.double()
    blocked.hist_panel(got, k, r0, o, w)
    blocked.hist_panel_plain(ref, k.double(), r0, o, w)
    err = (got.double() - ref).abs().max().item()
    if not err <= PANEL_ABS:
        fail(f"hist_panel N={n} T={t} r0={r0} o={o} w={w}: max abs err "
             f"{err:.3e} > {PANEL_ABS:.1e}")
    if not torch.equal(k, k_copy):
        fail("hist_panel wrote into K")
    return err


def check_panel_solve(dev) -> dict:
    """Phase 3, ``panel_solve`` at ``SOLVE_CASES`` (:func:`check_solve_case`)
    on the factor of a masked gram, computed in float64."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib

    rng = np.random.default_rng(6)
    worst = 0.0
    for n, t, o, w, col in SOLVE_CASES:
        times, mask, ls, var = flat_inputs(rng, n, t, dev)
        l64 = torch.linalg.cholesky(kernels_lib.gram(
            times.double(), ls.double()[:, None, None],
            variance=var.double()[:, None, None], mask=mask))
        worst = max(worst, check_solve_case(l64, o, w, col))
        del l64
    return {"panel_solve_shapes": worst,
            "panel_solve_cases": len(SOLVE_CASES)}


def check_prebuilt_kernels(dev) -> dict:
    """Phase 3, the imputation path's factorization and solve: returns the
    worst error of each."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol, trsm

    rng = np.random.default_rng(3)
    worst = {"hist_panel": 0.0, "cholesky": 0.0, "cholesky_vs_library": 0.0,
             "solve_triangular_rel": 0.0,
             "methods": {m: [0.0, 0.0, 0.0] for m in chol.METHODS}}
    cases = 0

    def bank(n, t):
        """A masked [n, t, t] gram bank on the card: float64 and float32."""
        times, mask, ls, var = flat_inputs(rng, n, t, dev)
        k64 = kernels_lib.gram(times.double(), ls.double()[:, None, None],
                               variance=var.double()[:, None, None],
                               mask=mask)
        return k64, k64.float()

    # hist_panel on a factor's own history
    mid = LONG_T // 2
    for n, t, r0, o, w in ((64, LONG_T, mid, mid, 128),
                           (16, 300, 256, 256, 44), (16, 300, 280, 256, 44)):
        k64, k = bank(n, t)
        worst["hist_panel"] = max(worst["hist_panel"], check_hist_case(
            torch.linalg.cholesky(k64), k, r0, o, w))
        cases += 1
        del k64, k

    # ops.cholesky of pre-built banks [B, 2, T, T], every route
    for t in PREBUILT_TS:
        for n in (16, 128):
            k64, k = bank(n, t)
            kb = k.reshape(n // 2, 2, t, t)
            k_copy = kb.clone()
            l = chol.cholesky(kb).reshape(n, t, t)
            name = f"cholesky T={t} N={n}"
            err, ratio = check_l(name, l, torch.linalg.cholesky(k64),
                                 torch.linalg.cholesky(k),
                                 vs_library=CHOL_VS_LIBRARY)
            if not torch.equal(kb, k_copy):
                fail(f"{name} wrote into K")
            worst["cholesky"] = max(worst["cholesky"], err)
            worst["cholesky_vs_library"] = max(worst["cholesky_vs_library"],
                                               ratio)
            cases += 1
            cases += check_methods(worst["methods"], kb, k64)
            del k64, k, kb, k_copy, l

    # solve_triangular, four forms, against float64 on the same factor
    for t in (SYN_T, BENCH_T, LONG_T):
        k64, k = bank(8, t)
        a = chol.cholesky(k)
        for left_side in (True, False):
            for transpose_a in (False, True):
                b = torch.randn((8, t, 5) if left_side else (8, 5, t),
                                device=dev)
                x = trsm.solve_triangular(a, b, left_side=left_side,
                                          transpose_a=transpose_a)
                op = a.double().mT if transpose_a else a.double()
                ref = torch.linalg.solve_triangular(
                    op, b.double(), upper=transpose_a, left=left_side)
                lib = torch.linalg.solve_triangular(
                    a.mT if transpose_a else a, b, upper=transpose_a,
                    left=left_side)

                def rel(y):
                    return (torch.linalg.norm(y.double() - ref)
                            / torch.linalg.norm(ref)).item()

                err, err_lib = rel(x), rel(lib)
                band = max(TRSM_REL, L_VS_LIBRARY * err_lib)
                if not (math.isfinite(err) and err <= band):
                    fail(f"solve_triangular T={t} left={left_side} "
                         f"transpose={transpose_a}: rel err {err:.3e} > "
                         f"{band:.3e} (library float32 {err_lib:.3e})")
                worst["solve_triangular_rel"] = max(
                    worst["solve_triangular_rel"], err)
                cases += 1
    worst["prebuilt_cases"] = cases
    return worst


def fused_band(k, ref, method) -> float:
    """The band of a right-looking method (``FUSED_VS_LIBRARY``,
    ``FUSED_VS_PLAIN``) on the float32 bank ``k [N, T, T]`` whose float64
    factor is ``ref``."""
    import torch

    from gpvae_tpu_torch.ops import chol

    err_lib = (torch.linalg.cholesky(k).double() - ref).abs().max().item()
    with plain_versions():
        plain = chol.cholesky(k, method=method)
    err_plain = (plain.double() - ref).abs().max().item()
    return max(L_MAX_ABS, FUSED_VS_LIBRARY * err_lib,
               FUSED_VS_PLAIN * err_plain)


def check_methods(worst, kb, k64) -> int:
    """``ops.chol.cholesky(kb, method=m)`` for every method on the
    pre-built bank ``kb [B, 2, T, T]`` against its float64 factor (the
    right-looking ones in :func:`fused_band`, the others in
    ``CHOL_VS_LIBRARY``; ``"pallas"`` only at T <= 64): the strict upper
    triangle exactly 0 and K unchanged.  ``worst[m]`` keeps the largest
    error of each method, its largest ratio to the band and to the
    library's float32 error on the same bank; returns the cases run."""
    import torch

    from gpvae_tpu_torch.ops import chol

    t = kb.shape[-1]
    k = kb.reshape(-1, t, t)
    ref = torch.linalg.cholesky(k64)
    k_copy = kb.clone()
    lib = torch.linalg.cholesky(k)
    err_lib = (lib.double() - ref).abs().max().item()
    cases = 0
    for method in chol.METHODS:
        if method == "pallas" and t > chol.PALLAS_MAX_T:
            continue
        name = f"cholesky(method={method!r}) T={t} N={k.shape[0]}"
        l = chol.cholesky(kb, method=method).reshape(k.shape)
        if method in FUSED_METHODS:
            band = fused_band(k, ref, method)
            err = (l.double() - ref).abs().max().item()
            if not (math.isfinite(err) and err <= band):
                fail(f"{name}: max abs err {err:.3e} > {band:.3e}")
            if bool((torch.triu(l, 1) != 0).any()):
                fail(f"{name}: strict upper triangle of L not zero")
        else:
            err, _ = check_l(name, l, ref, lib, vs_library=CHOL_VS_LIBRARY)
            band = max(L_MAX_ABS, CHOL_VS_LIBRARY * err_lib)
        if not torch.equal(kb, k_copy):
            fail(f"{name} wrote into K")
        worst[method] = [max(worst[method][0], err),
                         max(worst[method][1], err / band),
                         max(worst[method][2], err / err_lib)]
        cases += 1
    return cases


def check_trail_kernels(dev) -> dict:
    """Phase 3, B23's two kernels: one right-looking step at o=0 on a
    pre-built masked bank (nb in {64, 128}, R in {256, 1024}, N=128), each
    against its float64 plain version on the same inputs (``trail_update``
    from the kernel's X), on ``trail.lower_tiles`` only.  Returns the worst
    error of each over its terms (``TERMS_REL``)."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol_block, trail

    rng = np.random.default_rng(4)
    worst = {"trail_panel": 0.0, "trail_update": 0.0,
             "trail_panel_abs": 0.0, "trail_update_abs": 0.0}
    for nb in trail.WIDTHS:
        for r in (256, LONG_T):
            times, mask, ls, var = flat_inputs(rng, 128, r, dev)
            l = kernels_lib.gram(times, ls[:, None, None],
                                 variance=var[:, None, None], mask=mask)
            d = l[:, :nb, :nb]
            _, inv = chol_block.chol_block(d, inverse=True, out=d)
            p = l[:, nb:, :nb].double()
            got, ref = l.clone(), l.double()
            trail.trail_panel(got, inv, 0)
            trail.trail_panel_plain(ref, inv.double(), 0)
            diff = (got[:, nb:, :nb].double() - ref[:, nb:, :nb]).abs()
            terms = p.abs() @ inv.double().abs().mT
            panel = (diff / terms.clamp_min(1e-30)).max().item()
            panel_abs = diff.max().item()
            if not (panel <= TERMS_REL
                    and bool((got[:, :nb, nb:] == 0).all())):
                fail(f"trail_panel nb={nb} R={r}: err over terms "
                     f"{panel:.3e} > {TERMS_REL:.1e}, or upper tile not 0")
            x = got[:, nb:, :nb].double()
            ref = got.double()
            s22 = got[:, nb:, nb:].double()
            trail.trail_update(got, 0, nb)
            trail.trail_update_plain(ref, 0, nb)
            low = trail.lower_tiles(r - nb, dev)
            diff = (got[:, nb:, nb:].double() - ref[:, nb:, nb:])[:, low]
            terms = (s22.abs() + x.abs() @ x.abs().mT)[:, low]
            update = (diff.abs() / terms.clamp_min(1e-30)).max().item()
            if not update <= TERMS_REL:
                fail(f"trail_update nb={nb} R={r}: err over terms "
                     f"{update:.3e} > {TERMS_REL:.1e}")
            worst["trail_panel"] = max(worst["trail_panel"], panel)
            worst["trail_update"] = max(worst["trail_update"], update)
            worst["trail_panel_abs"] = max(worst["trail_panel_abs"],
                                           panel_abs)
            worst["trail_update_abs"] = max(worst["trail_update_abs"],
                                            diff.abs().max().item())
            del l, got, ref, p, x, s22, diff, terms
    return worst


def fitc_v0(times, inducing, ls, noise=1e-3, jitter=SPARSE_JITTER):
    """FITC's whitened ``V0 = L_mm^{-1} K_mt D^{-1/2}`` and ``K_mm +
    jitter I`` on the grids given, by the library in the inputs' dtype."""
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib

    m = inducing.shape[-1]
    eye = torch.eye(m, dtype=times.dtype, device=times.device)
    k_mm = kernels_lib.cross_gram(inducing, inducing, ls, noise=noise) + (
        jitter * eye)
    k_tm = kernels_lib.cross_gram(times, inducing, ls, noise=noise)
    v = torch.linalg.solve_triangular(torch.linalg.cholesky(k_mm), k_tm.mT,
                                      upper=False)
    d = torch.clamp((1.0 - noise) - (v * v).sum(-2), min=0.0) + noise
    return v / torch.sqrt(d)[..., None, :], k_mm


# the column offsets (multiples of 128) of phase 3's hist_panel and
# panel_solve cases on the T=4096 pre-built factor
T4096_BLOCKS = (1920, 3840)


def check_healing_fitc_kernels(dev) -> dict:
    """Phase 3, the kernels at the shapes of ``healing_mnist`` and
    ``sparse_t4096``: ``gram_chol`` with the Cauchy kernel on a grid shared
    by the batch (one row of times 0 .. T-1, no mask, N = 2Z = 128, T in
    ``CAUCHY_TS``) and ``tri_inv`` of each factor; ``ops.chol.cholesky``
    (one ``chol_block`` launch) and ``tri_inv`` at FITC's two factors, the
    inducing grams ``K_mm + 1e-4 I`` (N = B Z = 64 matrices of m=64) and
    ``B = I + V0 V0^T`` on the unit grid; and ``ops.chol.cholesky`` of
    evaluate's T=4096 pre-built bank (2 sequences x 8 latents on the CLI's
    toy times, half the observed steps kept, ls 256, the jitter 1e-5 of
    ``posterior_conditional``): 32 blocks of 128, with ``hist_panel`` and
    ``panel_solve`` each held to its plain version on that bank's float64
    factor at the column blocks ``T4096_BLOCKS``.  Returns the worst error
    of each."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import blocked, chol, chol_block, gram_chol
    from gpvae_tpu_torch.ops import tri_inv

    rng = np.random.default_rng(10)
    worst = {"cauchy_gram_chol": 0.0, "cauchy_gram_chol_vs_library": 0.0,
             "healing_fitc_tri_inv_rel": 0.0, "healing_fitc_tri_inv_abs": 0.0,
             "fitc_cholesky": 0.0, "fitc_cholesky_vs_library": 0.0}
    cases = 0

    def inverse(name, l):
        lf = l.reshape(-1, l.shape[-1], l.shape[-1])
        rel, err = check_inverse(name, tri_inv.tri_inv_cuda(lf.contiguous()),
                                 lf)
        for key, v in (("healing_fitc_tri_inv_rel", rel),
                       ("healing_fitc_tri_inv_abs", err)):
            worst[key] = max(worst[key], v)

    for t in CAUCHY_TS:
        times = torch.arange(t, dtype=torch.float32, device=dev)[None]
        ls = torch.tensor(rng.uniform(0.5, 4.0, 2 * HEAL_Z),
                          dtype=torch.float32, device=dev)
        name = f"T={t} N={2 * HEAL_Z} cauchy shared grid"
        l = gram_chol.gram_chol_fused(times, ls, kernel="cauchy")
        err, ratio = check_l(
            f"gram_chol {name}", l,
            gram_chol.gram_chol_plain(times.double(), ls.double(),
                                      kernel="cauchy"),
            gram_chol.gram_chol_plain(times, ls, kernel="cauchy"))
        worst["cauchy_gram_chol"] = max(worst["cauchy_gram_chol"], err)
        worst["cauchy_gram_chol_vs_library"] = max(
            worst["cauchy_gram_chol_vs_library"], ratio)
        inverse(f"tri_inv {name}", l)
        cases += 2

    # FITC's factors at the path's widths, on the preset's inducing grid
    f64 = dict(dtype=torch.float64, device=dev)
    s = torch.linspace(0.0, 4096.0, SPARSE_M, **f64)[None].expand(
        SPARSE_B, -1)
    ls = torch.tensor(rng.uniform(128.0, 384.0, SPARSE_Z), **f64)
    grid = torch.arange(SPARSE_T, **f64)[None].expand(SPARSE_B, -1)
    v0, k_mm = fitc_v0(grid, s, ls)
    b_mat = torch.eye(SPARSE_M, **f64) + v0 @ v0.mT
    del v0
    for name, k64 in (("K_mm", k_mm), ("B", b_mat)):
        k = k64.float()
        before = chol_block.LAUNCHES
        l = chol.cholesky(k)
        if chol_block.LAUNCHES - before != 1:
            fail(f"cholesky of FITC's {name} launched chol_block "
                 f"{chol_block.LAUNCHES - before} times, not once")
        label = f"FITC {name} N={SPARSE_B * SPARSE_Z} m={SPARSE_M}"
        err, ratio = check_l(f"cholesky {label}", l,
                             torch.linalg.cholesky(k64),
                             torch.linalg.cholesky(k),
                             vs_library=CHOL_VS_LIBRARY)
        worst["fitc_cholesky"] = max(worst["fitc_cholesky"], err)
        worst["fitc_cholesky_vs_library"] = max(
            worst["fitc_cholesky_vs_library"], ratio)
        inverse(f"tri_inv {label}", l)
        cases += 2

    # evaluate's T=4096 bank, as posterior_conditional builds it
    batch = toy_batch(3, SPARSE_EVAL_B, SPARSE_T)
    times = torch.tensor(batch["times"], **f64)
    kept = torch.tensor(batch["mask"] & (rng.random(batch["mask"].shape)
                                         >= 0.5), device=dev)
    ls = torch.full((SPARSE_Z,), 256.0, **f64)
    k64 = kernels_lib.gram_bank(times, ls, mask=kept) + 1e-5 * torch.eye(
        SPARSE_T, **f64)
    k = k64.float()
    reset_counts()
    l = chol.cholesky(k)
    torch.cuda.synchronize()
    got = read_counts()
    blocks = SPARSE_T // blocked.NB
    want = {"hist_panel": blocks, "chol_block": blocks,
            "panel_solve": blocks - 1}
    if {k_: v for k_, v in got.items() if v} != want:
        fail(f"cholesky of the [{SPARSE_EVAL_B}, {SPARSE_Z}, {SPARSE_T}, "
             f"{SPARSE_T}] bank launched {got}, not {want}")
    ref = torch.linalg.cholesky(k64)
    lib = torch.linalg.cholesky(k)
    err, ratio = check_l(
        f"cholesky T={SPARSE_T} N={SPARSE_EVAL_B * SPARSE_Z} pre-built", l,
        ref, lib, vs_library=CHOL_VS_LIBRARY)
    # the same blocked route on the plain versions (cuBLAS products, the
    # library's blocks and solves), for the record
    with plain_versions():
        plain = chol.cholesky(k)
    plain_ratio = ((plain.double() - ref).abs().max()
                   / (lib.double() - ref).abs().max()).item()
    del l, lib, plain
    # hist_panel and panel_solve on that bank's own float64 factor at the
    # factorization's middle and last column blocks: history 1920 and 3840
    # columns deep, 2048 and 128 rows from the block down
    hist = solve = 0.0
    flat = (-1, SPARSE_T, SPARSE_T)
    for o in T4096_BLOCKS:
        hist = max(hist, check_hist_case(ref.reshape(flat), k.reshape(flat),
                                         o, o, blocked.NB))
        solve = max(solve, check_solve_case(ref.reshape(flat), o,
                                            blocked.NB))
    worst.update(prebuilt_t4096=err, prebuilt_t4096_vs_library=ratio,
                 prebuilt_t4096_plain_vs_library=plain_ratio,
                 prebuilt_t4096_launches=got, hist_panel_t4096=hist,
                 panel_solve_t4096=solve,
                 healing_fitc_cases=cases + 1 + 2 * len(T4096_BLOCKS))
    del k64, k, ref
    return worst


def chol_bwd_inputs(dev, t, n):
    """The Cholesky backward's inputs at a training shape: a float32 factor
    of the port's blocked factorization (masked times on 0 .. 60 as the
    T=1024 bank's, or the unit grid at T=8192 as ``t1024_toeplitz``'s),
    a lower N(0, 1) cotangent, a logdet cotangent per matrix, and ``X =
    L^-1`` by ``tri_inv`` (its own draws, so that the other banks stay
    those of earlier runs)."""
    import numpy as np
    import torch

    from gpvae_tpu_torch.ops import blocked, tri_inv

    rng = np.random.default_rng(t + n)
    times, mask, ls, var = flat_inputs(rng, n, t, dev, masked=t < 8192)
    if t >= 8192:
        times = torch.arange(t, dtype=torch.float32, device=dev).expand(
            n, t).contiguous()
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    gen = torch.Generator(dev).manual_seed(t)
    l_bar = torch.randn(n, t, t, generator=gen, device=dev).tril_()
    g = torch.randn(n, generator=gen, device=dev)
    return l, l_bar, g, tri_inv.tri_inv(l)


def check_chol_bwd_kernel(dev) -> dict:
    """Phase 3, the Cholesky backward's kernel at the two training shapes
    (``CHOL_BWD_SHAPES``) through ``ops.chol.cholesky_bwd_from_l``: its
    three launches, ``K_bar`` symmetric to the bit, its error from float64
    on the same float32 inputs (max error over max |reference|) within
    ``CHOL_BWD_VS_PLAIN`` x the plain version's, and its mean error away
    from zero within ``CHOL_BWD_BIAS``.  Returns the worst of each."""
    import torch

    from gpvae_tpu_torch.ops import chol, chol_bwd

    worst = {"chol_bwd": 0.0, "chol_bwd_vs_plain": 0.0,
             "chol_bwd_bias": 0.0, "chol_bwd_plain_bias": 0.0}
    d = torch.float64
    for t, n in CHOL_BWD_SHAPES:
        l, l_bar, g, x = chol_bwd_inputs(dev, t, n)
        before = chol_bwd.LAUNCHES
        got = chol.cholesky_bwd_from_l(l, l_bar, logdet_bar=g)
        if chol_bwd.LAUNCHES - before != 3:
            fail(f"chol_bwd T={t} N={n}: {chol_bwd.LAUNCHES - before} "
                 f"launches, not 3")
        if not (bool(torch.isfinite(got).all())
                and torch.equal(got, got.mT)):
            fail(f"chol_bwd T={t} N={n}: K_bar not finite or not symmetric")
        lib = chol_bwd.chol_bwd_plain(l, l_bar, x, g)
        ref = chol_bwd.chol_bwd_plain(l.to(d), l_bar.to(d), x.to(d), g.to(d))
        del l, l_bar, x
        scale, mag = ref.abs().max(), ref.abs().mean()
        sign = torch.sign(ref)

        def errs(k):
            e = k.to(d) - ref
            return ((e.abs().max() / scale).item(),
                    ((e * sign).mean() / mag).item())

        (err, bias), (err_lib, bias_lib) = errs(got), errs(lib)
        del got, lib, ref, sign
        if not (err <= CHOL_BWD_VS_PLAIN * err_lib
                and abs(bias) <= CHOL_BWD_BIAS):
            fail(f"chol_bwd T={t} N={n} vs float64: {err:.3e} (plain "
                 f"{err_lib:.3e}, band {CHOL_BWD_VS_PLAIN}x), bias "
                 f"{bias:.3e} (plain {bias_lib:.3e}, band {CHOL_BWD_BIAS})")
        worst["chol_bwd"] = max(worst["chol_bwd"], err)
        worst["chol_bwd_vs_plain"] = max(worst["chol_bwd_vs_plain"],
                                         err / err_lib)
        worst["chol_bwd_bias"] = max(worst["chol_bwd_bias"], abs(bias))
        worst["chol_bwd_plain_bias"] = max(worst["chol_bwd_plain_bias"],
                                           abs(bias_lib))
        torch.cuda.empty_cache()
    return worst


# -- phase 4 ------------------------------------------------------------------

def cli_row(t, ls, dtype, dev, step=None):
    """First rows ``[Z, T]`` of the prior grams on the CLI's grid 0 .. 60
    (``linspace``, step ``60 / (T-1)``; or ``step``), noise 1e-3, as the
    model builds them (``kernels.toeplitz_row``)."""
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib

    step = 60.0 / (t - 1) if step is None else step
    return kernels_lib.toeplitz_row(
        t, step, torch.tensor(ls, dtype=dtype, device=dev), dtype=dtype)


def check_durbin_case(label, row64, plain_ms=None) -> dict:
    """``toeplitz.durbin_gs_factors`` of float64 rows on the card: through
    the Durbin kernel (exactly one call, :func:`durbin_kernels` kernels)
    against its plain version on the same inputs (``plain_versions``),
    both in float64.  logdet over max(|logdet|, 1) (a T=2 row on a coarse
    grid has logdet ~ 0), e relative, a and b over max |a|; fails past
    ``DURBIN_REL``.  With ``plain_ms`` (a dict), the plain call's
    CUDA-event time goes into it under ``label``."""
    import torch

    from gpvae_tpu_torch import toeplitz
    from gpvae_tpu_torch.ops import durbin

    before = durbin.LAUNCHES, durbin.KERNEL_LAUNCHES
    ld, a, b, e = toeplitz.durbin_gs_factors(row64)
    torch.cuda.synchronize()
    got = durbin.LAUNCHES - before[0], durbin.KERNEL_LAUNCHES - before[1]
    want = 1, durbin_kernels(row64.shape[1])
    if got != want:
        fail(f"durbin {label}: {got} calls and kernels, not {want}")
    with plain_versions():
        if plain_ms is None:
            ld0, a0, b0, e0 = toeplitz.durbin_gs_factors(row64)
        else:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            ld0, a0, b0, e0 = toeplitz.durbin_gs_factors(row64)
            stop.record()
            stop.synchronize()
            plain_ms[label] = start.elapsed_time(stop)
    scale = a0.abs().max()
    err = {"logdet_rel": ((ld - ld0).abs() / ld0.abs().clamp(min=1.0)
                          ).max().item(),
           "e_rel": ((e - e0).abs() / e0.abs()).max().item(),
           "a_rel_max": ((a - a0).abs().max() / scale).item(),
           "b_rel_max": ((b - b0).abs().max() / scale).item()}
    for k, v in err.items():
        if not (math.isfinite(v) and v <= DURBIN_REL):
            fail(f"durbin {label} vs its float64 plain version: {k} "
                 f"{v:.3e} > {DURBIN_REL:.1e}")
    return err


def check_durbin_dense(label, row64) -> float:
    """``toeplitz.durbin_logdet`` of float64 rows ``[Z, T]`` on the card
    (the Durbin kernel) against the logdet of the library's float64
    Cholesky of the dense matrices on the card, over max(|logdet|, 1);
    fails past ``DURBIN_REL``."""
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch import toeplitz

    ld = toeplitz.durbin_logdet(row64)
    l = torch.linalg.cholesky(kernels_lib.toeplitz_to_dense(row64))
    ref = 2.0 * torch.diagonal(l, dim1=-2, dim2=-1).log().sum(-1)
    err = ((ld - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    if not (math.isfinite(err) and err <= DURBIN_REL):
        fail(f"durbin {label}: logdet vs the dense float64 Cholesky's "
             f"{err:.3e} > {DURBIN_REL:.1e}")
    return err


def clamped_rows(t, dev, target=1.5):
    """One row ``rho [1, T-1]`` (float64) whose last reflection
    coefficient comes out as ``target`` before its clamp (|target| > 1:
    clamped): the CLI's grid at lengthscale 9, its last lag moved
    (``s[T-1]`` is linear in it, with slope 1)."""
    import torch

    from gpvae_tpu_torch.ops import durbin

    row = cli_row(t, (9.0,), torch.float64, "cpu")
    rho = (row[:, 1:] / row[:, :1]).clone()
    _, _, _, (steps, _) = durbin.durbin_plain(rho, save=True)
    num, den = steps[0, 1, -1], steps[0, 2, -1]
    rho[0, -1] = -target * den - (num - rho[0, -1])
    return rho.to(dev)


def check_durbin_bwd_case(label, rho, alone=False, plain_ms=None) -> dict:
    """The reverse kernel (one call, :func:`durbin_kernels` kernels) on the
    forward kernel's kept steps of ``rho [N, T-1]`` (float64, on the card)
    against ``durbin_bwd_plain`` on the same steps and against autograd of
    ``durbin_plain`` on the card, with random cotangents on all three
    outputs (with ``alone`` also on each output alone, the others
    ``None``); max error over max |reference| within ``DURBIN_BWD_REL``.
    The forward that keeps its steps gives the same outputs as the one
    that does not.  With ``plain_ms`` (a dict), the CUDA-event time of
    ``durbin_bwd_plain`` on all three cotangents goes into it under
    ``label``."""
    import torch

    from gpvae_tpu_torch.ops import durbin

    n, t1 = rho.shape
    gen = torch.Generator(device=rho.device).manual_seed(t1)
    opts = dict(dtype=torch.float64, device=rho.device, generator=gen)
    full = (torch.randn(n, **opts), torch.randn(n, t1, **opts),
            torch.randn(n, **opts))
    sets = {"all": full}
    if alone:
        for j, name in enumerate(("sum_log_e", "y", "e")):
            sets[name] = tuple(c if i == j else None
                               for i, c in enumerate(full))
    *kept, (steps, last) = durbin.durbin_cuda(rho, save=True)
    if not all(torch.equal(a, b) for a, b in zip(kept,
                                                 durbin.durbin_cuda(rho))):
        fail(f"durbin_bwd {label}: the forward that keeps its steps "
             f"differs from the one that does not")
    r = rho.clone().requires_grad_(True)
    outs = durbin.durbin_plain(r)
    err = {}
    for name, cot in sets.items():
        before = durbin.BWD_LAUNCHES, durbin.BWD_KERNEL_LAUNCHES
        got = durbin.durbin_bwd_cuda(steps, last, *cot)
        torch.cuda.synchronize()
        calls = (durbin.BWD_LAUNCHES - before[0],
                 durbin.BWD_KERNEL_LAUNCHES - before[1])
        want = 1, durbin_kernels(t1 + 1, bwd=True)
        if calls != want:
            fail(f"durbin_bwd {label}: {calls} calls and kernels, not "
                 f"{want}")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = durbin.durbin_bwd_plain(steps, last, *cot)
        stop.record()
        stop.synchronize()
        if plain_ms is not None and name == "all":
            plain_ms[label] = start.elapsed_time(stop)
        auto, = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cot) if c is not None),
            r, retain_graph=True)
        for ref_name, ref in (("plain", plain), ("autograd", auto)):
            v = ((got - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-300)).item()
            err[f"{name}_vs_{ref_name}"] = v
            if not (math.isfinite(v) and v <= DURBIN_BWD_REL):
                fail(f"durbin_bwd {label} ({name}) vs {ref_name}: {v:.3e} "
                     f"> {DURBIN_BWD_REL:.1e}")
    return err


def gs_identity_err(row, k64, x) -> float:
    """max |K (K^-1 X) - X| / max |X| with ``K^-1 X = (A (A^T X) - B (B^T
    X)) / e`` through the FFT route in ``row``'s dtype (the Gohberg-Semencul
    factors of ``toeplitz.durbin_gs_factors``), ``K`` dense in float64;
    ``x [Z, T, C]``."""
    from gpvae_tpu_torch import toeplitz

    _, a, b, e = toeplitz.durbin_gs_factors(row)
    xr = x.to(row)
    inv_x = (toeplitz.tri_toeplitz_matvec(
        a, toeplitz.tri_toeplitz_matvec_t(a, xr))
        - toeplitz.tri_toeplitz_matvec(
            b, toeplitz.tri_toeplitz_matvec_t(b, xr))) / e[:, None, None]
    back = k64.to(inv_x.device) @ inv_x.double()
    x64 = x.double().to(back.device)
    return ((back - x64).abs().max() / x64.abs().max()).item()


def check_toeplitz_kernels(dev) -> dict:
    """Phase 3, the Durbin kernel (``csrc/durbin.cu``) against its float64
    plain version on the card (:func:`check_durbin_case`): at T in
    ``DURBIN_TS`` on Z=1 and Z=3 rows of the CLI's grid, the
    ``t1024_toeplitz`` prior's own rows (Z=2, lengthscales 9 and 3), and
    two near-singular T=4096 rows (lengthscale 64 on the unit grid, 9 on
    the grid 0 .. 60: 614 steps; above T=4096: :func:`check_durbin_long`);
    and the Gohberg-Semencul identity ``K
    (K^-1 X) = X`` through the FFT route in float32 on the preset's rows
    and the T=4096 ones, against 4x the same route on the CPU in float32
    (``GS_IDENTITY_REL`` at least); the reverse kernel on every one of
    those rows and on a row whose last coefficient clamps
    (:func:`check_durbin_bwd_case`; each output's cotangent alone too on
    the preset's rows and the clamped one).  Returns the worst errors."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib

    f64 = torch.float64
    cases, bwd = {}, {}

    def both(label, row64, alone=False):
        cases[label] = check_durbin_case(label, row64)
        bwd[label] = check_durbin_bwd_case(
            label, (row64[:, 1:] / row64[:, :1]).contiguous(), alone)

    for t in DURBIN_TS:
        for ls in ((9.0,), (9.0, 3.0, 1.0)):
            both(f"T={t} Z={len(ls)}", cli_row(t, ls, f64, dev))
    preset = cli_row(TOEP_T, (9.0, 3.0), torch.float32, dev)
    both("t1024_toeplitz prior rows", preset.double(), alone=True)
    t4096 = {"T=4096 l=64 unit grid": cli_row(4096, (64.0,), torch.float32,
                                              dev, step=1.0),
             "T=4096 l=9 grid 0..60": cli_row(4096, (9.0,), torch.float32,
                                              dev, step=60.0 / 4096)}
    for label, row in t4096.items():
        both(label, row.double())
    for t in (17, TOEP_T):
        bwd[f"T={t} clamped"] = check_durbin_bwd_case(
            f"T={t} clamped", clamped_rows(t, dev), alone=True)
    gs = {}
    rng = np.random.default_rng(16)
    for label, row in {"t1024_toeplitz prior rows": preset, **t4096}.items():
        x = torch.tensor(rng.standard_normal((row.shape[0], row.shape[1], 4)),
                         dtype=torch.float32)
        k64 = kernels_lib.toeplitz_to_dense(row.double().cpu())
        err = gs_identity_err(row, k64, x.to(dev))
        err_cpu = gs_identity_err(row.cpu(), k64, x)
        band = max(GS_IDENTITY_REL, ELBO_VS_LIBRARY * err_cpu)
        if not (math.isfinite(err) and err <= band):
            fail(f"GS identity {label}: {err:.3e} > {band:.3e} (CPU float32 "
                 f"{err_cpu:.3e})")
        gs[label] = {"rel": err, "cpu_float32_rel": err_cpu, "band": band}
    return {"durbin": max(max(v.values()) for v in cases.values()),
            "durbin_cases": cases, "gs_identity_rel": max(
                v["rel"] for v in gs.values()), "gs_identity": gs,
            "durbin_band": DURBIN_REL,
            "durbin_bwd": max(max(v.values()) for v in bwd.values()),
            "durbin_bwd_cases": bwd, "durbin_bwd_band": DURBIN_BWD_REL}


def check_durbin_long(dev) -> dict:
    """Phase 6, the Durbin kernels' long route (above T=4096) against
    their float64 plain versions on the card: the forward
    (:func:`check_durbin_case`) at ``DURBIN_LONG_TS`` on the preset's rows
    (Z=2, lengthscales 9 and 3), the reverse
    (:func:`check_durbin_bwd_case`) at ``DURBIN_LONG_BWD_TS`` on them and
    on a clamped row at T=4097, both on a near-singular row at
    ``DURBIN_NEAR_T`` (lengthscale 64 on the unit grid), and the logdet
    against the dense float64 Cholesky's at ``DURBIN_DENSE_TS``
    (:func:`check_durbin_dense`).  Run after phase 5's profiled windows.
    Returns the worst errors, each case's, and the plain calls' times
    (``plain_ms``: ms of each case's one plain call, by CUDA events)."""
    import torch

    f64 = torch.float64
    cases, bwd, dense = {}, {}, {}
    plain_ms = {"forward": {}, "reverse": {}}
    for t in DURBIN_LONG_TS:
        if t == DURBIN_NEAR_T:
            continue
        label = f"T={t} t1024_toeplitz prior rows"
        row = cli_row(t, (9.0, 3.0), f64, dev)
        cases[label] = check_durbin_case(label, row, plain_ms["forward"])
        if t in DURBIN_LONG_BWD_TS:
            bwd[label] = check_durbin_bwd_case(
                label, (row[:, 1:] / row[:, :1]).contiguous(),
                plain_ms=plain_ms["reverse"])
        if t in DURBIN_DENSE_TS:
            dense[label] = check_durbin_dense(label, row)
    t = DURBIN_LONG_TS[0]
    bwd[f"T={t} clamped"] = check_durbin_bwd_case(f"T={t} clamped",
                                                  clamped_rows(t, dev))
    t = DURBIN_NEAR_T
    label = f"T={t} l=64 unit grid"
    near = cli_row(t, (64.0,), f64, dev, step=1.0)
    cases[label] = check_durbin_case(label, near, plain_ms["forward"])
    bwd[label] = check_durbin_bwd_case(
        label, (near[:, 1:] / near[:, :1]).contiguous(),
        plain_ms=plain_ms["reverse"])
    dense[label] = check_durbin_dense(label, near)
    return {"durbin_long": max(max(v.values()) for v in cases.values()),
            "durbin_long_cases": cases,
            "durbin_bwd_long": max(max(v.values()) for v in bwd.values()),
            "durbin_bwd_long_cases": bwd,
            "durbin_logdet_vs_dense_fp64": dense,
            "durbin_band": DURBIN_REL, "durbin_bwd_band": DURBIN_BWD_REL,
            "plain_ms": plain_ms}


def toy_batch(seed, b, t):
    import numpy as np

    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch

    return toy_to_masked_batch(generate_toy_data(np.random.default_rng(seed),
                                                 b, t=t))


@functools.lru_cache(maxsize=1)
def toy_unit_sequences(t) -> dict:
    """``TOEP_LONG_SEQS`` + 10 fully observed toy sequences from seed 0 on
    the unit grid 0 .. t-1, exact in float32: the Toeplitz prior's grid
    check (steps equal within 1e-4) holds at any T.  The CLI's grid 0 ..
    60 fails it in float32 at many T from 2221 up (at T=8192 its steps
    lie in [0.0073242, 0.0073280]), in the JAX package as in the port.
    Drawn once: at T=8192 a draw factors two dense [T, T] grams."""
    import numpy as np

    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch

    return toy_to_masked_batch(generate_toy_data(
        np.random.default_rng(0), TOEP_LONG_SEQS + 10, t=t,
        xmax=float(t - 1), hide_fraction=0.0))


def toy_unit_batch(part, t) -> dict:
    """Of :func:`toy_unit_sequences`: ``"train"``, the first
    ``TOEP_LONG_SEQS``; ``"probe"``, the next 8; ``"kl"``, the last 2."""
    n = TOEP_LONG_SEQS
    rows = {"train": slice(0, n), "probe": slice(n, n + 8),
            "kl": slice(n + 8, n + 10)}[part]
    return {k: v[rows] for k, v in toy_unit_sequences(t).items()}


def toy_full_batch(seed, b, t):
    """``b`` toy sequences from ``seed`` with no step hidden, as the CLI
    makes the ``toy_full`` family's: one uniform grid 0 .. 60."""
    import numpy as np

    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch

    return toy_to_masked_batch(generate_toy_data(
        np.random.default_rng(seed), b, t=t, hide_fraction=0.0))


def image_batch(seed, b, t=ZOO_T):
    """``b`` synthetic Moving-MNIST videos from ``seed`` as a batch, as
    ``MovingMNIST`` makes them: ``x [b, t, 64, 64, 1]`` binarized, times
    ``0 .. t-1``, a full mask."""
    from gpvae_tpu_torch.data import MovingMNIST, synthetic_moving_mnist

    vids = synthetic_moving_mnist(b, t=t, size=ZOO_SIDE, seed=seed)
    return MovingMNIST(data=vids, batch_size=1,
                       train_fraction=1.0).splits["train"]


@contextlib.contextmanager
def relu_gates(gates=None):
    """Inside the block each ``torch.relu`` (the nets' activations)
    records its input, in float64 on the CPU, into the list it yields; or,
    given the inputs another run recorded, passes its input where that
    run's was positive: the same network on that run's side of every
    kink."""
    import torch

    real = torch.relu
    recorded, calls = [], iter(gates or ())

    def relu(x):
        if gates is None:
            recorded.append(x.detach().double().cpu())
            return real(x)
        return x * (next(calls) > 0).to(device=x.device, dtype=x.dtype)

    torch.relu = relu
    try:
        yield recorded
    finally:
        torch.relu = real


def elbo_vs_cpu(model, dev, b, t, *, kl_band, log_ls_band,
                logdet_per_forward, batch_fn=toy_batch,
                kl_scale=None, match_gates=False) -> dict:
    """The trained model's ELBO and gradients on small batches (one per
    seed of ``ELBO_SEEDS``, from ``batch_fn(seed, b, t)``), on the card
    (kernels, float32) and on the CPU (plain versions, float64), with the
    same noise.  Each band is the stated one or 4x the error of the same
    model in float32 on the CPU on the same batch, whichever is larger.
    The KL is held per sequence over ``kl_scale + |KL|`` (default ``t``:
    one latent's terms are of size T).  A batch's ``feature_mask``, where
    it has one, reaches the NLL on both sides.  With ``match_gates`` each
    ReLU's input is held to ``PREACT_REL`` and the gradients against
    float64 on the same side of each ReLU's kink as the run judged.  The
    card's forward and backward launch ``diag_logdet`` exactly
    ``logdet_per_forward`` times."""
    cpu = copy.deepcopy(model).to("cpu")
    per_seed = {seed: elbo_vs_cpu_seed(model, cpu, dev, b, t, seed,
                                       kl_band=kl_band,
                                       log_ls_band=log_ls_band,
                                       logdet_per_forward=logdet_per_forward,
                                       batch_fn=batch_fn,
                                       kl_scale=t if kl_scale is None
                                       else kl_scale,
                                       match_gates=match_gates)
                for seed in ELBO_SEEDS}
    model.zero_grad(set_to_none=True)
    return {"seeds": per_seed,
            "worst_vs_cpu_float32": {
                k: max(r["vs_cpu_float32"][k] for r in per_seed.values())
                for k in per_seed[ELBO_SEEDS[0]]["errors"]}}


def elbo_vs_cpu_seed(model, cpu, dev, b, t, seed, *, kl_band,
                     log_ls_band, logdet_per_forward, batch_fn,
                     kl_scale, match_gates) -> dict:
    """:func:`elbo_vs_cpu` on the batch and noise of one ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    batch = batch_fn(seed, b, t)
    eps = rng.standard_normal(model.noise_shape(1, b, t))

    def run(m, device, dtype):
        m.zero_grad(set_to_none=True)
        x = torch.tensor(batch["x"], dtype=dtype, device=device)
        times = torch.tensor(batch["times"], dtype=dtype, device=device)
        mask = torch.tensor(batch["mask"], device=device)
        fmask = batch.get("feature_mask")
        out = m(x, times, mask, beta=1.0,
                feature_mask=None if fmask is None
                else torch.tensor(fmask, device=device),
                eps=torch.tensor(eps, dtype=dtype, device=device))
        out.loss.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in m.named_parameters()}
        return out, grads

    def errors(out, grads, ref, ref_grads):
        names = sorted(ref_grads)
        g = torch.cat([grads[n].reshape(-1) for n in names])
        g_ref = torch.cat([ref_grads[n].reshape(-1) for n in names])
        out_err = {
            "loss_rel": abs(out.loss.item() - ref.loss.item())
            / abs(ref.loss.item()),
            "kl_rel_terms": ((out.kl.double().cpu() - ref.kl).abs()
                             / (kl_scale + ref.kl.abs())).max().item(),
            "grad_rel": (torch.linalg.norm(g - g_ref)
                         / torch.linalg.norm(g_ref)).item(),
        }
        if "posterior_log_ls" in ref_grads:  # a GP or recognition posterior
            out_err["log_ls_grad_rel"] = (
                torch.linalg.norm(grads["posterior_log_ls"]
                                  - ref_grads["posterior_log_ls"])
                / torch.linalg.norm(ref_grads["posterior_log_ls"])).item()
        if "prior_log_ls" in ref_grads:  # a learned prior
            out_err["prior_log_ls_grad_rel"] = (
                torch.linalg.norm(grads["prior_log_ls"]
                                  - ref_grads["prior_log_ls"])
                / torch.linalg.norm(ref_grads["prior_log_ls"])).item()
        return out_err

    from gpvae_tpu_torch.ops import logdet

    # with match_gates, each run's ReLU inputs are recorded
    record = relu_gates if match_gates else (
        lambda: contextlib.nullcontext([]))
    before = logdet.LAUNCHES
    with record() as pre:
        out, grads = run(model, dev, torch.float32)
    if logdet.LAUNCHES - before != logdet_per_forward:
        fail(f"ELBO forward and backward at B={b} T={t} launched diag_logdet "
             f"{logdet.LAUNCHES - before} times, not {logdet_per_forward}")
    with record() as pre_lib:
        lib, lib_grads = run(cpu.float(), "cpu", torch.float32)
    with record() as pre_ref:
        ref, ref_grads = run(cpu.double(), "cpu", torch.float64)
    if tuple(out.logits.shape) != (1, b, t) + tuple(batch["x"].shape[2:]):
        fail(f"logits shape {tuple(out.logits.shape)}")
    extra = {}
    if match_gates:
        with relu_gates(pre):
            _, card_side = run(cpu.double(), "cpu", torch.float64)
        with relu_gates(pre_lib):
            _, lib_side = run(cpu.double(), "cpu", torch.float64)
        err = errors(out, grads, ref, card_side)
        err_lib = errors(lib, lib_grads, ref, lib_side)

        def preact(rec):
            return max(((a - r).abs().max() / r.abs().max()).item()
                       for a, r in zip(rec, pre_ref))

        err["preact_rel"], err_lib["preact_rel"] = preact(pre), preact(
            pre_lib)
        extra = {"gate_flips": sum(int(((a > 0) != (r > 0)).sum())
                                   for a, r in zip(pre, pre_ref)),
                 "grad_rel_across_kinks": errors(out, grads, ref,
                                                 ref_grads)["grad_rel"]}
    else:
        err = errors(out, grads, ref, ref_grads)
        err_lib = errors(lib, lib_grads, ref, ref_grads)
    stated = {"loss_rel": ELBO_LOSS_REL, "kl_rel_terms": kl_band,
              "grad_rel": GRAD_REL, "log_ls_grad_rel": log_ls_band,
              "prior_log_ls_grad_rel": log_ls_band,
              "preact_rel": PREACT_REL}
    bands = {k: max(stated[k], ELBO_VS_LIBRARY * err_lib[k]) for k in err}
    for k, v in err.items():
        if not (math.isfinite(v) and v <= bands[k]):
            fail(f"ELBO on the card vs CPU float64 at B={b} T={t} seed "
                 f"{seed}: {k} {v:.3e} > {bands[k]:.3e} (stated "
                 f"{stated[k]:.1e}, CPU float32 {err_lib[k]:.3e})")
    return {"errors": err, "bands": bands, "cpu_float32_errors": err_lib,
            "vs_cpu_float32": {k: err[k] / max(err_lib[k], 1e-30)
                               for k in err},
            "kl_ref": ref.kl.tolist(),
            "diag_logdet_launches": logdet.LAUNCHES - before, **extra}


def probe_loss(model, probe, eps, beta) -> float:
    """The training objective (``beta`` as the schedule has it) on a fixed
    batch (with its ``feature_mask`` where it has one) with fixed noise, no
    gradient."""
    import torch

    with torch.no_grad():
        return model(probe["x"], probe["times"], probe["mask"], beta=beta,
                     feature_mask=probe.get("feature_mask"),
                     eps=eps).loss.item()


def train_path(dev, preset_name, t, steps, num_seqs, ckpt_dir, data=None,
               overrides=None):
    """Train ``preset_name`` at sequence length ``t`` for ``steps`` steps
    through ``train.fit`` with every counter set to 0 just before and read
    just after, saving a checkpoint into ``ckpt_dir`` at the end, and check
    the loss.  ``data`` is ``(Batcher, probe batch)``, by default toy
    sequences (``num_seqs`` of them) and a toy probe; ``overrides``, model
    config fields set over the preset's.  Returns the model, the phase
    fields and a function that trains it further (for timing; it saves no
    checkpoint)."""
    import torch

    from gpvae_tpu_torch import configs, train as train_lib
    from gpvae_tpu_torch.data import Batcher
    from gpvae_tpu_torch.models import GPVAE

    preset = configs.get(preset_name)
    cfg = dataclasses.replace(preset.model, time_len=t, **(overrides or {}))
    b = preset.batch_size
    if data is None:
        data = Batcher(toy_batch(0, num_seqs, t), b, seed=0), toy_batch(1, 8,
                                                                         t)
    batcher, probe_np = data
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    probe = train_lib.device_arrays(probe_np, dev)
    eps = torch.randn(model.noise_shape(1, 8, t),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    beta = preset.train.beta(0)
    before = probe_loss(model, probe, eps, beta)
    gp_posterior = "posterior_log_ls" in dict(model.named_parameters())
    log_ls0 = model.posterior_log_ls.detach().clone() if gp_posterior else None
    main_cfg = train_lib.TrainConfig(
        learning_rate=preset.train.learning_rate, num_steps=steps,
        beta=preset.train.beta, log_every=max(1, steps // 10))
    reset_counts()
    with library_calls() as lib_calls:
        state, log = train_lib.fit(
            model, batcher,
            dataclasses.replace(main_cfg, checkpoint_dir=ckpt_dir),
            device=dev, verbose=False)
        torch.cuda.synchronize()
    launches = read_counts()
    if any(lib_calls.values()):
        fail(f"{preset_name} T={t} called the library's factorization or "
             f"solve: {lib_calls}")
    after = probe_loss(model, probe, eps, beta)
    losses = [r["loss"] for r in log.rows]
    if not all(math.isfinite(v) for v in losses + [after]):
        fail(f"{preset_name} T={t}: non-finite loss")
    if not after < before:
        fail(f"{preset_name} T={t}: probe loss did not fall: {before:.4f} "
             f"-> {after:.4f}")
    if gp_posterior and not (
            model.posterior_log_ls.detach() - log_ls0).abs().max() > 0:
        fail(f"{preset_name} T={t}: posterior_log_ls did not move")
    if state.step != steps:
        fail(f"{preset_name} T={t}: trained {state.step} steps")
    if train_lib.CheckpointManager(ckpt_dir).steps() != [steps]:
        fail(f"{preset_name} T={t}: no checkpoint of step {steps} in "
             f"{ckpt_dir}")
    out = {"preset": preset_name, "time_len": t, "batch": b, "steps": steps,
           "probe_loss_before": before, "probe_loss_after": after,
           "loss_logged": losses,
           "launches": launches, "library_calls": dict(lib_calls)}
    if gp_posterior:
        out["lengthscale_posterior"] = torch.exp(
            model.posterior_log_ls.detach()).tolist()

    def fit_more(n_steps, log_every):
        cfg_w = dataclasses.replace(main_cfg, num_steps=state.step + n_steps,
                                    log_every=log_every)
        return train_lib.fit(model, batcher, cfg_w, device=dev, state=state,
                             verbose=False)[1]

    return model, out, fit_more


def time_path(fit_more, window, windows=5) -> dict:
    """Steps/s over ``windows`` fits of ``window`` steps (host clock, each
    ended by the log point's read of the loss), and the device µs and
    kernels of one profiled window."""
    timed = fit_more(window * windows, window)
    sps = sorted(r["steps_per_sec"] for r in timed.rows)
    win = device_profile(lambda: fit_more(window, window),
                         label="a training window")
    return {"train_steps_per_s": sps[len(sps) // 2],
            "train_steps_per_s_windows": sps, "window_steps": window,
            "device_us_per_step": win["device_us"] / window,
            "kernels_per_step": win["kernels"] / window,
            "wall_us_per_step_under_profiler": win["wall_us"] / window,
            "device_busy_share": win["device_us"] / win["wall_us"],
            "top_kernels_us_per_step": [(n, us / window)
                                        for n, us in win["top"]]}


def check_launches(label, launches, needs, absent) -> None:
    """Fail unless each of ``needs`` launched and none of ``absent``."""
    for kernel in needs:
        if launches[kernel] < 1:
            fail(f"{label} launched the {kernel} kernel {launches[kernel]} "
                 f"times")
    for kernel in absent:
        if launches[kernel]:
            fail(f"{label} launched the {kernel} kernel")


def main_path(dev, name, t, steps, num_seqs, window, ckpt_dir, *, kl_band,
              log_ls_band, needs, absent=()) -> tuple[dict, dict]:
    """One main path: trained (``train_path``), its ``needs`` kernels
    launched and its ``absent`` ones not, ``diag_logdet`` exactly once a
    step where the factors take it (T=1024), its ELBO held against the
    CPU, then timed.  Returns the phase fields and the timing."""
    model, out, fit_more = train_path(dev, name, t, steps, num_seqs,
                                      ckpt_dir)
    check_launches(f"{name} T={t}", out["launches"], needs, absent)
    per_forward = int(t >= 256 and t % 128 == 0)
    if out["launches"]["diag_logdet"] != per_forward * steps:
        fail(f"{name} T={t}: {out['launches']['diag_logdet']} diag_logdet "
             f"launches in {steps} steps, not {per_forward} a step")
    out["elbo_vs_cpu_fp64"] = elbo_vs_cpu(model, dev, 2, t, kl_band=kl_band,
                                          log_ls_band=log_ls_band,
                                          logdet_per_forward=per_forward)
    phase("main_path", **out)
    return out, time_path(fit_more, window)


def eval_batch(preset_name, t, eval_b, n=None):
    """The sequences ``evaluate --seed 0`` scores: the first ``eval_b`` of
    the last 10% of its ``n`` sequences (by default the preset's
    ``EVAL_SEQS``; ``__main__.py``): toy
    sequences (fully observed for the ``toy_full`` family), synthetic
    healing sequences, or the test split of synthetic Moving-MNIST
    videos."""
    from gpvae_tpu_torch import configs
    from gpvae_tpu_torch.data import MovingMNIST, synthetic_moving_mnist

    n = EVAL_SEQS[preset_name] if n is None else n
    family = configs.get(preset_name).resolved_data_family
    if family == "mnist":
        test = MovingMNIST(data=synthetic_moving_mnist(
            n, t=t, size=ZOO_SIDE, seed=0)).splits["test"]
        return {k: v[:eval_b] for k, v in test.items()}
    batch = {"healing": healing_batch, "toy_full": toy_full_batch}.get(
        family, toy_batch)(0, n, t)
    n_train = int(0.9 * n)
    return {k: v[n_train:n_train + eval_b] for k, v in batch.items()}


def restored_model(preset_name, t, ckpt_dir, dev):
    """The model ``evaluate`` scores: the preset at ``t``, the newest
    checkpoint of ``ckpt_dir`` loaded (its model, as ``evaluate`` loads
    it), on ``dev`` (the card: the checkpoint holds the state of a CUDA
    noise generator)."""
    import torch

    from gpvae_tpu_torch import configs, train as train_lib
    from gpvae_tpu_torch.models import GPVAE

    cfg = dataclasses.replace(configs.get(preset_name).model, time_len=t)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    state = train_lib.create_train_state(model, train_lib.TrainConfig(), dev)
    if train_lib.CheckpointManager(ckpt_dir).restore_latest(
            state, optimizer=False) is None:
        fail(f"no checkpoint in {ckpt_dir}")
    return model


def evaluate_path(dev, preset_name, t, eval_b, ckpt_dir, *, needs,
                  absent=(), exact=None, library=(),
                  num_seqs=None) -> tuple[dict, dict]:
    """``python -m gpvae_tpu_torch evaluate`` through ``__main__.main`` on
    the checkpoint of ``ckpt_dir``, with every counter set to 0 just
    before and read just after (each of ``exact`` launched exactly that
    many times, where given) and no library factorization or solve in
    between but those named in ``library``; its metrics held against the
    same restored model on the CPU in float64 (``METRIC_REL``, or 4x the
    CPU's float32 error), its count of scored steps or pixels exactly; the
    card's peak memory over the call.  A healing preset is scored as the
    CLI scores it, by ``pixel_imputation_metrics``; every other preset by
    ``imputation_metrics``, with the same kept mask and baseline noise on
    both sides, and the restored model's posterior mean held to
    ``IMPUTE_MEAN_REL`` of its largest entry, or 4x the CPU's float32
    error.  ``num_seqs`` is the CLI's ``--num-seqs`` (the preset's
    ``EVAL_SEQS`` by default).
    Returns the phase fields and what phase 5 needs to time the path."""
    import torch

    from gpvae_tpu_torch import analysis, configs
    from gpvae_tpu_torch.__main__ import main as cli

    num_seqs = EVAL_SEQS[preset_name] if num_seqs is None else num_seqs
    argv = ["evaluate", "--preset", preset_name, "--time-len", str(t),
            "--num-seqs", str(num_seqs), "--eval-batch",
            str(eval_b), "--ckpt-dir", ckpt_dir, "--seed", "0"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with library_calls() as lib_calls, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        cli(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    label = f"evaluate {preset_name} T={t}"
    if any(v for k, v in lib_calls.items() if k not in library):
        fail(f"{label} called the library's factorization or solve: "
             f"{lib_calls}")
    check_launches(label, launches, needs, absent)
    for kernel, count in (exact or {}).items():
        if launches[kernel] != count:
            fail(f"{label} launched {kernel} {launches[kernel]} times, not "
                 f"{count}")
    printed = out.getvalue().splitlines()
    if len(printed) != 2 or not printed[0].startswith("restored step "):
        fail(f"{label} printed {printed!r}")
    got = json.loads(printed[1])

    # the same restored model and draws on the CPU: the CLI's kept mask and
    # baseline noise come from a CPU generator seeded with --seed 0
    batch = eval_batch(preset_name, t, eval_b, num_seqs)
    card = restored_model(preset_name, t, ckpt_dir, dev)
    cpu32 = copy.deepcopy(card).to("cpu")
    cpu64 = copy.deepcopy(cpu32).double()
    pixels = configs.get(preset_name).resolved_data_family == "healing"
    keys, counted = ((PIXEL_METRICS, "missing_pixels") if pixels
                     else (METRICS, "dropped_steps"))

    def metrics(model, dtype):
        if pixels:
            return analysis.pixel_imputation_metrics(model, batch)
        return analysis.imputation_metrics(
            model, torch.tensor(batch["x"], dtype=dtype),
            torch.tensor(batch["times"], dtype=dtype),
            torch.tensor(batch["mask"]), drop_fraction=0.5,
            generator=torch.Generator().manual_seed(0))

    want, lib = metrics(cpu64, torch.float64), metrics(cpu32, torch.float32)
    if got[counted] != want[counted] or not got[counted]:
        fail(f"{label}: {got[counted]} {counted}, the CPU {want[counted]}")
    errors, bands = {}, {}
    for k in keys:
        errors[k] = abs(got[k] - want[k]) / abs(want[k])
        bands[k] = max(METRIC_REL,
                       ELBO_VS_LIBRARY * abs(lib[k] - want[k]) / abs(want[k]))
    context = {"model": card, "cpu_model": cpu32, "batch": batch}
    if not pixels:
        # the posterior mean, on the card and on the CPU, the same kept mask
        kept = analysis.drop_timesteps(
            torch.tensor(batch["mask"]), 0.5,
            generator=torch.Generator().manual_seed(0))

        def post_mean(model, device, dtype):
            return analysis.impute(
                model, torch.tensor(batch["x"], dtype=dtype, device=device),
                torch.tensor(batch["times"], dtype=dtype, device=device),
                torch.tensor(batch["mask"], device=device),
                kept.to(device))[2].mean.double().cpu()

        ref = post_mean(cpu64, "cpu", torch.float64)
        scale = ref.abs().max().item()

        def mean_err(mean):
            return (mean - ref).abs().max().item() / scale

        errors["posterior_mean_rel"] = mean_err(post_mean(card, dev,
                                                          torch.float32))
        bands["posterior_mean_rel"] = max(
            IMPUTE_MEAN_REL,
            ELBO_VS_LIBRARY * mean_err(post_mean(cpu32, "cpu",
                                                 torch.float32)))
        context["kept"] = kept
    for k, v in errors.items():
        if not (math.isfinite(v) and v <= bands[k]):
            fail(f"{label} vs CPU float64: {k} {v:.3e} > {bands[k]:.3e}")
    fields = {"preset": preset_name, "time_len": t, "eval_batch": eval_b,
              "metrics": got, "metrics_cpu_fp64": want, "errors": errors,
              "bands": bands, "launches": launches,
              "library_calls": dict(lib_calls), "cli_seconds": seconds,
              "peak_memory_bytes": peak}
    phase("evaluate_path", **fields)
    return fields, context


def check_posterior_sample(dev, model, batch, kept, cpu_model) -> dict:
    """One ``analysis.impute(sample=True)`` at T=1024 on the card, through
    ``gp.posterior_sample`` (the Cholesky of ``S* + 1e-5 I``): its draw
    finite and ``posterior_sample`` within ``SAMPLE_REL`` of its largest
    entry, or 4x the CPU's float32 error, of the same step in float64 on
    the card's own posterior (mean and ``S*``), with the same noise.  The
    draw end to end against the same model on the CPU in float64, and the
    card's ``S*`` against the CPU's, are reported beside it."""
    import torch

    from gpvae_tpu_torch import analysis, gp

    b, t = batch["mask"].shape
    eps = torch.randn((1, b, model.config.latent_dim, t),
                      generator=torch.Generator().manual_seed(5))

    def impute(m, device, dtype):
        _, z, post = analysis.impute(
            m, torch.tensor(batch["x"], dtype=dtype, device=device),
            torch.tensor(batch["times"], dtype=dtype, device=device),
            torch.tensor(batch["mask"], device=device), kept.to(device),
            sample=True, eps=eps.to(device, dtype))
        return z.double().cpu(), post

    reset_counts()
    with library_calls() as lib_calls:
        z, post = impute(model, dev, torch.float32)
        torch.cuda.synchronize()
    launches = read_counts()
    if any(lib_calls.values()):
        fail(f"posterior_sample called the library: {lib_calls}")
    check_launches("posterior_sample", launches,
                   ("hist_panel", "chol_block", "panel_solve", "tri_inv"), ())
    if not bool(torch.isfinite(z).all()):
        fail(f"posterior_sample T={t}: {int((~torch.isfinite(z)).sum())} "
             f"entries not finite")

    # posterior_sample alone, on the card's posterior
    mean, cov = post.mean.cpu(), post.cov.cpu()
    draw = gp.posterior_sample(post, eps=eps.to(dev)).double().cpu()
    ref = gp.posterior_sample(gp.GPPosterior(mean.double(), cov.double()),
                              eps=eps.double())
    lib = gp.posterior_sample(gp.GPPosterior(mean, cov), eps=eps)
    scale = ref.abs().max().item()
    err = (draw - ref).abs().max().item() / scale
    err_lib = (lib.double() - ref).abs().max().item() / scale
    band = max(SAMPLE_REL, ELBO_VS_LIBRARY * err_lib)
    if not err <= band:
        fail(f"posterior_sample T={t} vs float64 on the card's posterior: "
             f"{err:.3e} > {band:.3e} (CPU float32 {err_lib:.3e})")

    # end to end, against the same model on the CPU
    z64, post64 = impute(copy.deepcopy(cpu_model).double(), "cpu",
                         torch.float64)
    z32, post32 = impute(cpu_model, "cpu", torch.float32)
    zscale = z64.abs().max().item()
    jitter = 1e-5 * torch.eye(t, dtype=torch.float64)
    low = torch.linalg.eigvalsh(cov[:4].double() + jitter).min().item()
    low64 = torch.linalg.eigvalsh(post64.cov[:4] + jitter).min().item()
    return {"time_len": t, "batch": b, "rel_err": err, "band": band,
            "cpu_float32_rel_err": err_lib, "launches": launches,
            "end_to_end_rel_err": (z - z64).abs().max().item() / zscale,
            "end_to_end_cpu_float32_rel_err":
                (z32 - z64).abs().max().item() / zscale,
            "cov_abs_err": (cov.double() - post64.cov).abs().max().item(),
            "cov_abs_err_cpu_float32":
                (post32.cov.double() - post64.cov).abs().max().item(),
            "min_eig_cov_plus_jitter_first4": low,
            "min_eig_cov_plus_jitter_first4_fp64": low64}


def main_paths(dev, ck: str) -> tuple[dict, dict, dict]:
    """Phase 4: the three training paths and the evaluate path on each of
    their checkpoints (under ``ck``), and one posterior draw at T=1024.
    Returns every path's phase fields (launches included), the training
    paths' timings, and the T=1024 evaluate path's model and batch."""
    paths, timing = {}, {}
    gp_only = ("gram_chol", "gram_panel", "diag_logdet")
    for name, preset, t, steps, seqs, window, bands, needs, absent, eb in (
            ("syn_data", "syn_data", SYN_T, MAIN_STEPS, 2000, 200,
             (KL_REL_TERMS, LOG_LS_GRAD_REL), ("gram_chol", "tri_inv"),
             ("chol_block", "gram_panel", "panel_solve", "diag_logdet",
              "hist_panel", "chol_bwd"), SYN_B),
            ("bench_t100", "bench_t100", BENCH_T, BENCH_STEPS, 2000, 100,
             (KL_REL_TERMS, LOG_LS_GRAD_REL), ("chol_block", "tri_inv"),
             ("hist_panel", "chol_bwd"), BENCH_B),
            ("bench_t100_t1024", "bench_t100", LONG_T, LONG_STEPS, 256, 5,
             (KL_REL_TERMS_T1024, LOG_LS_GRAD_REL_T1024),
             ("chol_block", "gram_panel", "panel_solve", "diag_logdet",
              "tri_inv", "chol_bwd"), ("hist_panel",), BENCH_B)):
        ckpt_dir = os.path.join(ck, name)
        paths[name], timing[name] = main_path(
            dev, preset, t, steps, seqs, window, ckpt_dir,
            kl_band=bands[0], log_ls_band=bands[1], needs=needs,
            absent=absent)
        # evaluate: hist_panel and panel_solve only past one 128 block
        blocked_t = t > 128
        ev_needs = ("chol_block", "tri_inv") + (
            ("hist_panel", "panel_solve") if blocked_t else ())
        ev_absent = gp_only + ("chol_bwd",) + (
            () if blocked_t else ("hist_panel", "panel_solve"))
        paths[f"evaluate_{name}"], context = evaluate_path(
            dev, preset, t, eb, ckpt_dir, needs=ev_needs, absent=ev_absent)
    # context: the last path's, T=1024
    sample = check_posterior_sample(dev, context["model"], context["batch"],
                                    context["kept"], context["cpu_model"])
    phase("posterior_sample", **sample)
    return paths, timing, context


def zoo_paths(dev, ck: str) -> tuple[dict, dict]:
    """Phase 4, the reference model zoo at its widths on synthetic
    Moving-MNIST videos (``ZOO_PATHS``): each preset trained through
    ``train.fit`` (``train_path``), its launches exactly ``ZOO_LAUNCHES``
    a step and no other kernel, its ELBO and gradients held against the
    CPU in float64 on four batches of B=2 (the KL per sequence over
    ``Z T + |KL|``, the size of its terms), then timed; the full paths'
    checkpoints scored by ``evaluate`` (``evaluate_path``), and
    ``vanilla_vae``'s evaluate raising the JAX package's error.  Returns
    the paths' phase fields and their timings."""
    from gpvae_tpu_torch.__main__ import main as cli
    from gpvae_tpu_torch.data import MovingMNIST, synthetic_moving_mnist

    paths, timing = {}, {}
    probe = image_batch(1, 8)
    others = ("gram_panel", "panel_solve", "diag_logdet", "hist_panel",
              "trail_panel", "trail_update")
    for name, steps, evaluate in ZOO_PATHS:
        ds = MovingMNIST(data=synthetic_moving_mnist(
            ZOO_SEQS, t=ZOO_T, size=ZOO_SIDE, seed=0))
        ckpt_dir = os.path.join(ck, name)
        model, out, fit_more = train_path(
            dev, name, ZOO_T, steps, None, ckpt_dir,
            data=(ds.batchers["train"], probe))
        exact_launches(name, out["launches"], ZOO_LAUNCHES[name], steps)
        out["elbo_vs_cpu_fp64"] = elbo_vs_cpu(
            model, dev, 2, ZOO_T, kl_band=KL_REL_TERMS,
            log_ls_band=LOG_LS_GRAD_REL, logdet_per_forward=0,
            batch_fn=image_batch, kl_scale=ZOO_Z * ZOO_T, match_gates=True)
        phase("zoo_path", **out)
        paths[name] = out
        timing[name] = time_path(fit_more, ZOO_WINDOW)
        if evaluate:
            paths[f"evaluate_{name}"], _ = evaluate_path(
                dev, name, ZOO_T, ZOO_EVAL_B, ckpt_dir,
                needs=("chol_block", "tri_inv"),
                absent=("gram_chol",) + others)
    argv = ["evaluate", "--preset", "vanilla_vae", "--num-seqs",
            str(ZOO_SEQS), "--eval-batch", str(ZOO_EVAL_B), "--ckpt-dir",
            os.path.join(ck, "vanilla_vae"), "--seed", "0"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli(argv)
    except ValueError as e:
        if str(e) != VANILLA_EVAL_ERROR:
            fail(f"evaluate vanilla_vae raised {e!r}, not "
                 f"{VANILLA_EVAL_ERROR!r}")
    else:
        fail("evaluate vanilla_vae did not raise the JAX package's "
             "ValueError")
    phase("evaluate_vanilla_vae", raised=VANILLA_EVAL_ERROR)
    return paths, timing


def toeplitz_launches(t) -> dict:
    """A ``t1024_toeplitz`` training step's launches at sequence length
    ``t`` (a multiple of 128): ``TOEP_LAUNCHES`` with the posterior bank's
    T / 128 column blocks and the Durbin call's kernels at ``t``."""
    blocks = t // 128
    return {**TOEP_LAUNCHES, "gram_panel": blocks, "chol_block": blocks,
            "panel_solve": blocks - 1, "durbin_kernels": durbin_kernels(t)}


def exact_launches(label, launches, per_step, steps) -> None:
    """Fail unless each kernel launched ``per_step`` times a step (0 where
    not named) in ``steps`` steps."""
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        fail(f"{label}: launches {launches} in {steps} steps, not {want}")


def healing_batch(seed, b, t=HEAL_T):
    """``b`` synthetic healing sequences from ``seed``
    (``make_healing_batch``): zero-filled frames with their
    ``feature_mask`` and ``x_clean``, times 0 .. t-1, a full mask."""
    from gpvae_tpu_torch.data import make_healing_batch

    return make_healing_batch(b, t=t, seed=seed)


def sparse_batch(seed, b, t=SPARSE_T):
    """``b`` toy sequences from ``seed`` on the unit grid 0 .. t-1."""
    import numpy as np

    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch

    return toy_to_masked_batch(generate_toy_data(
        np.random.default_rng(seed), b, t=t, xmax=SPARSE_XMAX))


@contextlib.contextmanager
def fitc_jitter(jitter=SPARSE_JITTER):
    """Inside the block FITC takes ``jitter`` wherever none is given, in
    every dtype: the float64 side of a comparison gets the float32 run's
    (``sparse._resolve_jitter``)."""
    from gpvae_tpu_torch import sparse

    real = sparse._resolve_jitter
    sparse._resolve_jitter = lambda j, dtype: real(
        jitter if j is None else j, dtype)
    try:
        yield
    finally:
        sparse._resolve_jitter = real


def healing_path(dev, ck: str) -> tuple[dict, dict, dict]:
    """Phase 4g: ``healing_mnist`` at its widths (B=64, T=10, Z=64, 28 x
    28 frames, the Cauchy kernel on a shared grid) trained ``HEAL_STEPS``
    steps through ``train.fit`` on the CLI's training split of
    ``HEAL_SEQS`` synthetic healing sequences, each batch with its
    ``feature_mask``: its launches exactly ``HEAL_LAUNCHES`` a step and no
    other kernel, its ELBO and gradients against the CPU in float64 on
    four batches of B=2 (the KL over ``Z T + |KL|``, the gradients on the
    card's side of each ReLU kink, as the zoo's), then timed and scored by
    ``evaluate`` (:func:`evaluate_path`, no kernel: the missing-pixel
    metrics decode the encoder's means).  Returns the phase fields,
    the timing and the evaluate call's context."""
    from gpvae_tpu_torch.data import Batcher

    name = "healing_mnist"
    n_train = int(0.9 * HEAL_SEQS)
    keys = ("x", "times", "mask", "feature_mask")
    data = healing_batch(0, HEAL_SEQS)
    probe = healing_batch(1, 8)
    ckpt_dir = os.path.join(ck, name)
    model, out, fit_more = train_path(
        dev, name, HEAL_T, HEAL_STEPS, None, ckpt_dir,
        data=(Batcher({k: data[k][:n_train] for k in keys}, HEAL_B, seed=0),
              {k: probe[k] for k in keys}))
    exact_launches(name, out["launches"], HEAL_LAUNCHES, HEAL_STEPS)
    out["elbo_vs_cpu_fp64"] = elbo_vs_cpu(
        model, dev, 2, HEAL_T, kl_band=KL_REL_TERMS,
        log_ls_band=LOG_LS_GRAD_REL, logdet_per_forward=0,
        batch_fn=healing_batch, kl_scale=HEAL_Z * HEAL_T, match_gates=True)
    phase("healing_path", **out)
    timing = time_path(fit_more, ZOO_WINDOW)
    ev, ctx = evaluate_path(dev, name, HEAL_T, HEAL_EVAL_B, ckpt_dir,
                            needs=(), exact={k: 0 for k in read_counts()})
    return {name: out, f"evaluate_{name}": ev}, timing, ctx


@contextlib.contextmanager
def inverse_route():
    """Inside the block FITC's triangular solves take the explicit-inverse
    route on any device (``via_inverse=True``; on the CPU the inverse is
    ``tri_inv``'s plain version, the library's), as they do on the card."""
    from gpvae_tpu_torch import sparse

    real = sparse.solve_triangular
    sparse.solve_triangular = functools.partial(real, via_inverse=True)
    try:
        yield
    finally:
        sparse.solve_triangular = real


def fitc_vs_cpu(model, dev) -> dict:
    """``sparse.fitc_diag_kl`` at the path's widths (B=2 unit-grid
    sequences, T=4096, Z=8, m=64) on the trained encoder's means and
    log-variances, its lengthscales requiring a gradient, on the batch of
    each seed of ``FITC_SEEDS``: on the card in float32 against the CPU in
    float64, both at the float32 jitter.  The KL within ``SPARSE_KL_REL``
    of |KL|, dKL/dmu and dKL/dlog v within ``GRAD_REL`` and dKL/dlog ls
    within ``SPARSE_LOG_LS_GRAD_REL`` (BASELINE.md's sparse_t4096 row), or
    4x the float32 error of the same computation on the CPU: the solves'
    explicit inverses (:func:`inverse_route`, the card's route and the JAX
    package's on its TPU).  The CPU's own float32 route (substitution) is
    read for the record.  Each card run, forward and backward, launches
    ``chol_block`` twice and ``tri_inv`` five times (the forward's three,
    the Cholesky backward's of L_mm and L_B), nothing else."""
    import torch

    from gpvae_tpu_torch import sparse

    log_ls = model.prior_log_ls.detach().double().cpu()
    stated = {"kl_rel": SPARSE_KL_REL, "grad_mu_rel": GRAD_REL,
              "grad_log_var_rel": GRAD_REL,
              "grad_log_ls_rel": SPARSE_LOG_LS_GRAD_REL}
    per_seed = {}
    for seed in FITC_SEEDS:
        batch = sparse_batch(seed, 2)
        with torch.no_grad():
            mean, log_var = model.encode(torch.tensor(batch["x"],
                                                      device=dev))
        mean, log_var = mean.double().cpu(), log_var.double().cpu()

        def run(device, dtype):
            args = [a.to(device, dtype, copy=True).requires_grad_(True)
                    for a in (mean, log_var, log_ls)]
            kl = sparse.fitc_diag_kl(
                args[0], args[1],
                torch.tensor(batch["times"], dtype=dtype, device=device),
                model.inducing_times(dtype=dtype, device=device),
                torch.exp(args[2]),
                mask=torch.tensor(batch["mask"], device=device),
                jitter=SPARSE_JITTER)
            kl.sum().backward()
            return kl.detach().double().cpu(), [a.grad.double().cpu()
                                                for a in args]

        reset_counts()
        card = run(dev, torch.float32)
        torch.cuda.synchronize()
        launches = read_counts()
        exact_launches(f"fitc_diag_kl forward and backward, seed {seed}",
                       launches, {"chol_block": 2, "tri_inv": 5}, 1)
        ref = run("cpu", torch.float64)
        with inverse_route():
            same = run("cpu", torch.float32)
        own = run("cpu", torch.float32)

        def errors(r):
            kl, grads = r
            rel = [(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref)
                    ).item() for g, g_ref in zip(grads, ref[1])]
            return {"kl_rel": ((kl - ref[0]).abs() / ref[0].abs()).max()
                    .item(), "grad_mu_rel": rel[0],
                    "grad_log_var_rel": rel[1], "grad_log_ls_rel": rel[2]}

        err, err_same, err_own = errors(card), errors(same), errors(own)
        bands = {k: max(stated[k], ELBO_VS_LIBRARY * err_same[k])
                 for k in err}
        for k, v in err.items():
            if not (math.isfinite(v) and v <= bands[k]):
                fail(f"fitc_diag_kl on the card vs CPU float64, seed {seed}: "
                     f"{k} {v:.3e} > {bands[k]:.3e} (CPU float32 on the "
                     f"card's route {err_same[k]:.3e}, on its own "
                     f"{err_own[k]:.3e})")
        per_seed[seed] = {
            "errors": err, "bands": bands,
            "cpu_float32_same_route_errors": err_same,
            "cpu_float32_own_route_errors": err_own, "launches": launches,
            "kl_ref": ref[0].tolist()}
    return per_seed


def sparse_path(dev, ck: str) -> tuple[dict, dict, dict]:
    """Phase 4h: ``sparse_t4096`` at its widths (B=8, T=4096, Z=8, m=64)
    trained ``SPARSE_STEPS`` steps through ``train.fit`` on unit-grid toy
    sequences: its launches exactly ``SPARSE_LAUNCHES`` a step and no
    other kernel; its ELBO and gradients against the CPU in float64 on
    four unit-grid batches of B=2, and ``fitc_diag_kl`` with its
    lengthscale gradient (:func:`fitc_vs_cpu`), both at the float32
    jitter; then timed and evaluated from its checkpoint at
    ``--eval-batch 2`` (the CLI's toy data): the T=4096 pre-built
    factorization exactly 32 ``hist_panel``, 32 ``chol_block`` and 31
    ``panel_solve`` launches, no other kernel, and the library's
    triangular solve above ``trsm.INV_ROUTE_MAX_T`` (in float64, a matrix
    at a time), where the JAX package leaves it to XLA.  Returns the
    phase fields, the timing and the evaluate call's context."""
    from gpvae_tpu_torch.data import Batcher
    from gpvae_tpu_torch.ops import blocked, trsm

    name = "sparse_t4096"
    ckpt_dir = os.path.join(ck, name)
    model, out, fit_more = train_path(
        dev, name, SPARSE_T, SPARSE_STEPS, None, ckpt_dir,
        data=(Batcher(sparse_batch(0, SPARSE_SEQS), SPARSE_B, seed=0),
              sparse_batch(1, 8)))
    exact_launches(name, out["launches"], SPARSE_LAUNCHES, SPARSE_STEPS)
    with fitc_jitter():
        out["elbo_vs_cpu_fp64"] = elbo_vs_cpu(
            model, dev, 2, SPARSE_T, kl_band=SPARSE_KL_REL,
            log_ls_band=SPARSE_LOG_LS_GRAD_REL, logdet_per_forward=0,
            batch_fn=sparse_batch, kl_scale=0.0)
        out["fitc_kl_vs_cpu_fp64"] = fitc_vs_cpu(model, dev)
    phase("sparse_path", **out)
    timing = time_path(fit_more, ZOO_WINDOW)
    blocks = SPARSE_T // blocked.NB
    inverse_route = SPARSE_T <= trsm.INV_ROUTE_MAX_T
    ev, ctx = evaluate_path(
        dev, name, SPARSE_T, SPARSE_EVAL_B, ckpt_dir, needs=(),
        exact={k: 0 for k in read_counts()} | {
            "hist_panel": blocks, "chol_block": blocks,
            "panel_solve": blocks - 1, "tri_inv": int(inverse_route)},
        library=() if inverse_route else ("solve_triangular",))
    return {name: out, f"evaluate_{name}": ev}, timing, ctx


def prior_kl(model, mean, aux, times, route):
    """The prior KL ``[B, Z]`` of a Toeplitz model's batch, given the
    posterior's means, factor and logdet, by ``route``: ``"toeplitz"``
    (its first rows, the Durbin recursion, the FFT trace) or ``"dense"``
    (``chol_gram_bank`` of the shared grid, ``gp_kl`` on one ``tri_inv``
    of L_p), each building its prior from the lengthscales."""
    import torch

    from gpvae_tpu_torch import gp
    from gpvae_tpu_torch import kernels as kernels_lib

    c = model.config
    ls = torch.exp(model.prior_log_ls).to(times.dtype)
    if route == "toeplitz":
        row = kernels_lib.toeplitz_row(c.time_len, times[0, 1] - times[0, 0],
                                       ls, kernel=c.kernel, noise=c.noise,
                                       dtype=times.dtype)
        return gp.gp_kl_toeplitz_prior(mean, aux["l_q"], row,
                                       logdet_q=aux["ld_q"])
    l_p = gp.chol_gram_bank(times[:1], ls, kernel=c.kernel, noise=c.noise)
    return gp.gp_kl(mean, aux["l_q"], l_p, logdet_q=aux["ld_q"])


def toeplitz_kl_inputs(model, device, dtype, seed=15, b=TOEP_B,
                       batch_fn=None) -> tuple:
    """The trained model on ``device`` in ``dtype``, and the encoder's
    means, ``chol_banks`` (with logdets) and times of a batch of ``b``
    fully observed toy sequences from ``seed`` at the model's length
    (``batch_fn``'s, by default :func:`toy_full_batch`'s)."""
    import torch

    m = copy.deepcopy(model).to(device=device, dtype=dtype)
    batch = (batch_fn or toy_full_batch)(seed, b, model.config.time_len)
    x = torch.tensor(batch["x"], dtype=dtype, device=device)
    times = torch.tensor(batch["times"], dtype=dtype, device=device)
    with torch.no_grad():
        mean = m.encode(x)
        aux = m.chol_banks(times, None, logdets=True)
    return m, mean, aux, times


def toeplitz_vs_dense(model, dev, b=TOEP_B, batch_fn=None,
                      fp64=True) -> tuple[dict, dict]:
    """The Toeplitz prior KL against the dense prior's on one batch of
    ``b`` (``batch_fn``'s, :func:`toeplitz_kl_inputs`; :func:`prior_kl`):
    on the card in float32, max over [B, Z] of
    |difference| / |dense| within ``TOEP_KL_VS_DENSE`` or 4x the same gap
    on the CPU in float32; with ``fp64`` (the CPU's float64 side, ~20 s
    of host time at T=8192) each route against the CPU's dense KL in
    float64, and beside them the card's Toeplitz route on its float32
    means and factor cast to float64 (its row and FFTs in float64).
    Returns the fields and what phase 5 needs to time both routes."""
    import torch

    def kls(m, mean, aux, times):
        with torch.no_grad():
            return [prior_kl(m, mean, aux, times, route).double().cpu()
                    for route in ("toeplitz", "dense")]

    def gap(toep, dense):
        return ((toep - dense).abs() / dense.abs()).max().item()

    inputs = toeplitz_kl_inputs(model, dev, torch.float32, b=b,
                                batch_fn=batch_fn)
    card = kls(*inputs)
    cpu32 = kls(*toeplitz_kl_inputs(model, "cpu", torch.float32, b=b,
                                    batch_fn=batch_fn))
    err, err_cpu = gap(*card), gap(*cpu32)
    band = max(TOEP_KL_VS_DENSE, ELBO_VS_LIBRARY * err_cpu)
    if not (math.isfinite(err) and err <= band):
        fail(f"the Toeplitz prior KL vs the dense one on the card: {err:.3e} "
             f"> {band:.3e} (CPU float32 {err_cpu:.3e})")
    fields = {"toeplitz_vs_dense_rel": err, "band": band,
              "cpu_float32_toeplitz_vs_dense_rel": err_cpu}
    if fp64:
        cpu64 = kls(*toeplitz_kl_inputs(model, "cpu", torch.float64, b=b,
                                        batch_fn=batch_fn))
        # the card's Toeplitz route on its own float32 means and factor,
        # cast to float64 (the factorization kernels take float32 only):
        # the row and cuFFT in float64
        m, mean, aux, times = inputs
        with torch.no_grad():
            card64 = prior_kl(m, mean.double(),
                              {k: v.double() for k, v in aux.items()},
                              times.double(), "toeplitz").cpu()
        ref = cpu64[1]
        fields.update({
            "cpu_float64_toeplitz_vs_dense_rel": gap(*cpu64),
            "card_toeplitz_vs_fp64_dense_rel": gap(card[0], ref),
            "card_dense_vs_fp64_dense_rel": gap(card[1], ref),
            "card_toeplitz_fft_float64_vs_fp64_dense_rel": gap(card64, ref),
            "kl_fp64": ref.tolist()})
    return fields, {"inputs": inputs}


def toeplitz_path(dev, ck: str) -> tuple[dict, dict, dict]:
    """Phase 4i: ``t1024_toeplitz`` at its widths (B=8, T=1024, Z=2, one
    uniform grid shared by the batch, the fixed Toeplitz prior)
    trained ``TOEP_STEPS`` steps through ``train.fit`` on fully observed
    toy sequences: its launches exactly ``TOEP_LAUNCHES`` a step and no
    other kernel (the Durbin kernel once, no prior factorization); its
    ELBO and gradients against the CPU in float64 on four batches of B=2
    under the T=1024 bands (``diag_logdet`` once a forward); the Toeplitz
    prior KL against the dense one (:func:`toeplitz_vs_dense`); then timed
    and evaluated from its checkpoint (the T=1024 GP-posterior
    imputation: ``hist_panel`` 8, ``chol_block`` 8, ``panel_solve`` 7,
    ``tri_inv`` 1, nothing else).  Returns the phase fields, the timing
    and the context phase 5 times the prior KLs in."""
    from gpvae_tpu_torch.data import Batcher

    name = "t1024_toeplitz"
    ckpt_dir = os.path.join(ck, name)
    model, out, fit_more = train_path(
        dev, name, TOEP_T, TOEP_STEPS, None, ckpt_dir,
        data=(Batcher(toy_full_batch(0, TOEP_SEQS, TOEP_T), TOEP_B, seed=0),
              toy_full_batch(1, 8, TOEP_T)))
    exact_launches(name, out["launches"], TOEP_LAUNCHES, TOEP_STEPS)
    out["elbo_vs_cpu_fp64"] = elbo_vs_cpu(
        model, dev, 2, TOEP_T, kl_band=KL_REL_TERMS_T1024,
        log_ls_band=LOG_LS_GRAD_REL_T1024, logdet_per_forward=1,
        batch_fn=toy_full_batch)
    out["prior_kl_vs_dense"], ctx = toeplitz_vs_dense(model, dev)
    phase("toeplitz_path", **out)
    timing = time_path(fit_more, TOEP_WINDOW)
    blocks = TOEP_T // 128
    ev, ctx["evaluate"] = evaluate_path(
        dev, name, TOEP_T, TOEP_EVAL_B, ckpt_dir, needs=(),
        exact={k: 0 for k in read_counts()} | {
            "hist_panel": blocks, "chol_block": blocks,
            "panel_solve": blocks - 1, "tri_inv": 1})
    return {name: out, f"evaluate_{name}": ev}, timing, ctx


def learnable_toeplitz_path(dev, ck: str) -> tuple[dict, dict]:
    """Phase 4j: ``t1024_toeplitz``'s model with ``learn_prior_lengthscales``
    at its widths (B=8, T=1024, Z=2, one uniform grid) trained
    ``TOEP_STEPS`` steps through ``train.fit`` on fully observed toy
    sequences: its launches exactly ``TOEP_LEARN_LAUNCHES`` a step (4i's
    and the Durbin kernel's reverse once) and no other kernel, no library
    factorization or solve; the loss falls on the probe batch;
    ``prior_log_ls`` moves and stays finite; its ELBO and every gradient,
    ``prior_log_ls``'s included, against the CPU in float64 on four
    batches of B=2 under the T=1024 bands (``durbin`` and ``durbin_bwd``
    once each an ELBO forward and backward); then timed, and its
    checkpoint evaluated as 4i's (``evaluate`` restores the learned prior
    into the preset's fixed one).  Returns the phase fields and the
    timing."""
    import torch

    from gpvae_tpu_torch.data import Batcher
    from gpvae_tpu_torch.ops import durbin

    name = "t1024_toeplitz"
    label = f"{name} (learned prior)"
    ckpt_dir = os.path.join(ck, f"{name}_learned_prior")
    model, out, fit_more = train_path(
        dev, name, TOEP_T, TOEP_STEPS, None, ckpt_dir,
        data=(Batcher(toy_full_batch(0, TOEP_SEQS, TOEP_T), TOEP_B, seed=0),
              toy_full_batch(1, 8, TOEP_T)),
        overrides={"learn_prior_lengthscales": True})
    exact_launches(label, out["launches"], TOEP_LEARN_LAUNCHES, TOEP_STEPS)
    log_ls = model.prior_log_ls.detach().cpu()
    start = torch.log(torch.tensor([9.0, 3.0]))
    if not (torch.isfinite(log_ls).all()
            and (log_ls - start).abs().max() > 0):
        fail(f"{label}: prior_log_ls {log_ls.tolist()} did not move or is "
             f"not finite")
    out["lengthscale_prior"] = torch.exp(log_ls).tolist()
    before = (durbin.LAUNCHES, durbin.BWD_LAUNCHES)
    out["elbo_vs_cpu_fp64"] = elbo_vs_cpu(
        model, dev, 2, TOEP_T, kl_band=KL_REL_TERMS_T1024,
        log_ls_band=LOG_LS_GRAD_REL_T1024, logdet_per_forward=1,
        batch_fn=toy_full_batch)
    n = len(ELBO_SEEDS)
    if (durbin.LAUNCHES - before[0], durbin.BWD_LAUNCHES - before[1]) != (
            n, n):
        fail(f"{label}: the ELBO held against the CPU launched durbin "
             f"{durbin.LAUNCHES - before[0]} and durbin_bwd "
             f"{durbin.BWD_LAUNCHES - before[1]} times, not {n} each")
    phase("learnable_toeplitz_path", **out)
    timing = time_path(fit_more, TOEP_WINDOW)
    blocks = TOEP_T // 128
    ev, _ = evaluate_path(
        dev, name, TOEP_T, TOEP_EVAL_B, ckpt_dir, needs=(),
        exact={k: 0 for k in read_counts()} | {
            "hist_panel": blocks, "chol_block": blocks,
            "panel_solve": blocks - 1, "tri_inv": 1})
    return {f"{name}_learned_prior": out,
            f"evaluate_{name}_learned_prior": ev}, timing


def toeplitz_long_path(dev, ck: str) -> tuple[dict, dict]:
    """Phase 4m: ``t1024_toeplitz``'s model at T=8192 (the CLI's
    ``--time-len 8192``; B=8, Z=2, the posterior bank [1, 2, 8192, 8192]
    in 64 column blocks), on the Durbin kernels' long route, trained on
    fully observed toy sequences on the unit grid (:func:`toy_unit_batch`:
    the CLI's grid 0 .. 60 fails the prior's grid check at this T):
    ``TOEP_LONG_STEPS`` steps with the fixed prior and as many with
    ``learn_prior_lengthscales``, each exactly ``toeplitz_launches(8192)``
    a step (and one ``durbin_bwd`` with the learned prior), no other
    kernel; the learned ``prior_log_ls`` moves and stays finite; the
    fixed-prior model's prior KL against the dense prior's on a batch of
    2 (:func:`toeplitz_vs_dense`: a float64 ELBO on the CPU at T=8192
    would take minutes); each run timed; then ``evaluate`` of the fixed
    prior's checkpoint on one sequence (``--eval-batch 1``): 64
    ``hist_panel``, 64 ``chol_block``, 63 ``panel_solve`` and the
    library's triangular solve (above ``trsm.INV_ROUTE_MAX_T``), metrics
    and posterior mean against the CPU in float64; evaluate draws the
    CLI's own sequences (grid 0 .. 60: the GP-posterior imputation checks
    no grid).  Returns the phase fields and the timing."""
    import torch

    from gpvae_tpu_torch.data import Batcher
    from gpvae_tpu_torch.ops import blocked, trsm

    name, t = "t1024_toeplitz", TOEP_LONG_T
    paths, timing = {}, {}
    for learned in (False, True):
        key = f"{name}_T{t}" + ("_learned_prior" if learned else "")
        ckpt_dir = os.path.join(ck, key)
        model, out, fit_more = train_path(
            dev, name, t, TOEP_LONG_STEPS, None, ckpt_dir,
            data=(Batcher(toy_unit_batch("train", t), TOEP_B, seed=0),
                  toy_unit_batch("probe", t)),
            overrides={"learn_prior_lengthscales": True} if learned
            else None)
        exact_launches(key, out["launches"], toeplitz_launches(t) | (
            {"durbin_bwd": 1, "durbin_bwd_kernels": durbin_kernels(t, True)}
            if learned else {}), TOEP_LONG_STEPS)
        if learned:
            log_ls = model.prior_log_ls.detach().cpu()
            start = torch.log(torch.tensor([9.0, 3.0]))
            if not (torch.isfinite(log_ls).all()
                    and (log_ls - start).abs().max() > 0):
                fail(f"{key}: prior_log_ls {log_ls.tolist()} did not move "
                     f"or is not finite")
            out["lengthscale_prior"] = torch.exp(log_ls).tolist()
        else:
            out["prior_kl_vs_dense"], _ = toeplitz_vs_dense(
                model, dev, b=2, fp64=False,
                batch_fn=lambda seed, b, t: toy_unit_batch("kl", t))
            fixed_dir = ckpt_dir
        phase("toeplitz_long_path", **out)
        paths[key] = out
        timing[key] = time_path(fit_more, TOEP_LONG_WINDOW, windows=3)
    blocks = t // blocked.NB
    inverse_route = t <= trsm.INV_ROUTE_MAX_T
    paths[f"evaluate_{name}_T{t}"], _ = evaluate_path(
        dev, name, t, 1, fixed_dir, needs=(),
        exact={k: 0 for k in read_counts()} | {
            "hist_panel": blocks, "chol_block": blocks,
            "panel_solve": blocks - 1, "tri_inv": int(inverse_route)},
        library=() if inverse_route else ("solve_triangular",),
        num_seqs=TOEP_LONG_EVAL_SEQS)
    return paths, timing


def drain(batcher):
    """A plain generator over a Batcher: hides its type, so ``fit`` takes
    the stacked iterator path (``k`` batches a call, one copy)."""
    while True:
        yield next(batcher)


def params_flat(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def kstep_fit(dev, preset_name, t, arrays, steps, k, path, log_every,
              run=None):
    """``train.fit`` of ``preset_name`` at sequence length ``t`` from the
    seed-0 weights on a seed-0 Batcher of ``arrays`` (``path`` "batcher",
    or "iterator" through :func:`drain`) to step ``steps``, ``k`` steps a
    call, with the counters set to 0 just before and read just after; no
    library factorization or solve.  ``run``, an earlier record, is
    continued (its model, state and Batcher).  Returns the run's
    record."""
    import torch

    from gpvae_tpu_torch import configs, train as train_lib
    from gpvae_tpu_torch.data import Batcher
    from gpvae_tpu_torch.models import GPVAE

    preset = configs.get(preset_name)
    if run is None:
        model = GPVAE(dataclasses.replace(preset.model, time_len=t),
                      generator=torch.Generator().manual_seed(0))
        state, batcher = None, Batcher(arrays, preset.batch_size, seed=0)
    else:
        model, state, batcher = run["model"], run["state"], run["batcher"]
    config = train_lib.TrainConfig(
        learning_rate=preset.train.learning_rate, num_steps=steps,
        beta=preset.train.beta, log_every=log_every, steps_per_call=k)
    reset_counts()
    with library_calls() as lib_calls:
        state, log = train_lib.fit(
            model, batcher if path == "batcher" else drain(batcher), config,
            device=dev, state=state, verbose=False)
        torch.cuda.synchronize()
    launches = read_counts()
    if any(lib_calls.values()):
        fail(f"{preset_name} k={k} ({path}) called the library's "
             f"factorization or solve: {lib_calls}")
    return {"model": model, "state": state, "batcher": batcher,
            "params": params_flat(model), "launches": launches,
            "rows": [(r["step"], r["loss"]) for r in log.rows],
            "steps_per_sec": [r["steps_per_sec"] for r in log.rows]}


def multistep_paths(dev) -> dict:
    """Phase 4k: ``steps_per_call`` on the card.  For each of
    ``KSTEP_PATHS`` (``syn_data`` at its widths, B=20, T=45, Z=2;
    ``t1024_toeplitz`` at its, B=8, T=1024, the blocked factorization and
    ``durbin``): ``train.fit`` with ``k`` steps a call over the Batcher's
    device-resident data and over a plain iterator of its batches, each
    held against a ``k = 1`` run from the same seed and data: the same
    kernels in the same order with the same generator, so every logged
    loss and every parameter bit for bit; each run's launches exactly its
    path's a step.  Returns each path's phase fields (launches summed over
    its three runs)."""
    out = {}
    for name, steps, k in KSTEP_PATHS:
        if name == "syn_data":
            t, per_step = SYN_T, SYN_LAUNCHES
            arrays = toy_batch(0, 2000, SYN_T)
        else:
            t, per_step = TOEP_T, TOEP_LAUNCHES
            arrays = toy_full_batch(0, TOEP_SEQS, TOEP_T)
        ref = kstep_fit(dev, name, t, arrays, steps, 1, "batcher", k)
        exact_launches(f"{name} k=1", ref["launches"], per_step, steps)
        if ref["state"].step != steps or not all(
                math.isfinite(v) for _, v in ref["rows"]):
            fail(f"{name} k=1: step {ref['state'].step}, losses "
                 f"{ref['rows']}")
        launches = dict(ref["launches"])
        fields = {"preset": name, "time_len": t, "steps": steps,
                  "steps_per_call": k, "loss_logged_k1": ref["rows"]}
        for path in ("batcher", "iterator"):
            got = kstep_fit(dev, name, t, arrays, steps, k, path, k)
            label = f"{name} k={k} ({path})"
            exact_launches(label, got["launches"], per_step, steps)
            diff = (got["params"] - ref["params"]).abs().max().item()
            if got["state"].step != steps or got["rows"] != ref["rows"] \
                    or diff != 0.0:
                fail(f"{label}: step {got['state'].step}, losses "
                     f"{got['rows']} against k=1's {ref['rows']}, "
                     f"parameters {diff} from k=1's")
            fields[path] = {"launches": got["launches"],
                            "param_max_abs_vs_k1": diff,
                            "losses_equal_k1": True}
            for kernel, n in got["launches"].items():
                launches[kernel] += n
        fields["launches"] = launches
        phase("kstep_path", **fields)
        out[f"kstep_{name}"] = fields
    return out


def dp_path(dev, ck: str) -> dict:
    """Phase 4l: data parallelism on the card.  ``dp_scale``
    (``t1024_toeplitz``'s model, BASELINE config 5) through
    ``parallel.fit_data_parallel`` on a world of one rank (NCCL, a file
    store in ``ck``), the global batch cut from 4096 to ``DP_B`` on
    ``DP_SEQS`` fully observed toy sequences: first one
    ``make_parallel_train_step`` against ``train_step`` on the same global
    batch and noise (the all-reduce over one rank is the identity: loss
    and parameters bit for bit), then ``DP_STEPS`` steps at ``k = 1`` and
    as many at ``k = DP_K`` (equal bit for bit), each with exactly
    ``TOEP_LAUNCHES`` a step; the peak of ``utils.device_memory_stats``.
    A card cannot show scaling: this proves the program on NCCL.  Returns
    the phase fields."""
    import torch
    import torch.distributed as dist

    from gpvae_tpu_torch import configs, train as train_lib, utils
    from gpvae_tpu_torch.data import Batcher
    from gpvae_tpu_torch.models import GPVAE
    from gpvae_tpu_torch.parallel import fit_data_parallel
    from gpvae_tpu_torch.parallel import mesh as mesh_lib

    preset = configs.get("dp_scale")
    arrays = toy_full_batch(0, DP_SEQS, preset.model.time_len)
    mesh_lib.init_process_group(os.path.join(ck, "dp_store"), 0, 1, "cuda")
    try:
        mesh = mesh_lib.make_mesh(devices=[dev])
        torch.cuda.reset_peak_memory_stats(dev)
        states = []
        for _ in range(2):
            model = GPVAE(preset.model,
                          generator=torch.Generator().manual_seed(0))
            states.append(train_lib.create_train_state(
                model, train_lib.TrainConfig(
                    learning_rate=preset.train.learning_rate), dev))
        first = {k: v[:DP_B] for k, v in arrays.items()}
        beta = preset.train.beta(0)
        want = train_lib.train_step(states[0],
                                    train_lib.device_arrays(first, dev), beta)
        mesh_lib.replicate(states[1], mesh)
        _, got = mesh_lib.make_parallel_train_step(preset.train.beta, mesh)(
            states[1], mesh_lib.shard_batch(first, mesh))
        diff = (params_flat(states[1].model)
                - params_flat(states[0].model)).abs().max().item()
        if got["loss"].item() != want["loss"].item() or diff != 0.0:
            fail(f"dp_scale: the world-of-one step's loss {got['loss'].item()}"
                 f" against train_step's {want['loss'].item()}, parameters "
                 f"{diff} apart")
        del states, want, got
        runs, launches = {}, {k: 0 for k in read_counts()}
        for k in (1, DP_K):
            model = GPVAE(preset.model,
                          generator=torch.Generator().manual_seed(0))
            config = train_lib.TrainConfig(
                learning_rate=preset.train.learning_rate,
                num_steps=DP_STEPS, beta=preset.train.beta,
                log_every=DP_STEPS, steps_per_call=k)
            reset_counts()
            t0 = time.perf_counter()
            with library_calls() as lib_calls:
                state, log = fit_data_parallel(
                    model, drain(Batcher(arrays, DP_B, seed=0)), config,
                    mesh, verbose=False)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            label = f"dp_scale k={k}"
            if any(lib_calls.values()):
                fail(f"{label} called the library's factorization or "
                     f"solve: {lib_calls}")
            exact_launches(label, counts, TOEP_LAUNCHES, DP_STEPS)
            loss = log.rows[-1]["loss"]
            if state.step != DP_STEPS or not math.isfinite(loss):
                fail(f"{label}: step {state.step}, loss {loss}")
            runs[k] = {"params": params_flat(model), "loss": loss,
                       "steps_per_s": DP_STEPS / seconds}
            for kernel, n in counts.items():
                launches[kernel] += n
        diff_k = (runs[DP_K]["params"] - runs[1]["params"]).abs().max().item()
        if diff_k != 0.0 or runs[DP_K]["loss"] != runs[1]["loss"]:
            fail(f"dp_scale: k={DP_K} ended {diff_k} from k=1's parameters, "
                 f"loss {runs[DP_K]['loss']} against {runs[1]['loss']}")
        memory = utils.device_memory_stats(dev)
    finally:
        dist.destroy_process_group()
    fields = {
        "preset": "dp_scale", "world_size": 1, "backend": "nccl",
        "global_batch": DP_B, "time_len": preset.model.time_len,
        "reduced": {"batch_size": [preset.batch_size, DP_B],
                    "num_seqs": DP_SEQS,
                    "num_steps": [preset.train.num_steps, DP_STEPS],
                    "devices": 1},
        "steps": DP_STEPS, "steps_per_call": [1, DP_K],
        "first_step_vs_train_step": {"loss_equal": True,
                                     "param_max_abs": diff},
        "k_vs_k1_param_max_abs": diff_k,
        "loss_last": runs[1]["loss"],
        "steps_per_s": {f"k{k}": r["steps_per_s"] for k, r in runs.items()},
        "memory": memory, "launches": launches}
    phase("dp_path", **fields)
    return {"dp_scale": fields}


def time_kstep(dev) -> dict:
    """Phase 5: ``syn_data``'s steps/s at ``k = 1`` and at ``KSTEP_PATHS``'
    ``k``, in turns (1, k, k, 1): each run warms a fresh model for ``2 k``
    steps, then continues it ``KSTEP_TIME_STEPS`` steps in
    ``KSTEP_TIME_WINDOWS`` log windows (host clock, each window ended by
    its read of the loss); the median window of each run.  Records, not a
    claim: ``k`` steps a call are a Python loop of the same steps."""
    k = dict((name, k) for name, _, k in KSTEP_PATHS)["syn_data"]
    arrays = toy_batch(0, 2000, SYN_T)
    window = KSTEP_TIME_STEPS // KSTEP_TIME_WINDOWS
    runs = {1: [], k: []}
    for kk in (1, k, k, 1):
        warm = kstep_fit(dev, "syn_data", SYN_T, arrays, 2 * k, kk,
                         "batcher", k)
        timed = kstep_fit(dev, "syn_data", SYN_T, None,
                          2 * k + KSTEP_TIME_STEPS, kk, "batcher", window,
                          run=warm)
        sps = sorted(timed["steps_per_sec"])
        runs[kk].append(sps[len(sps) // 2])
    return {"window_steps": window,
            **{f"k{kk}_train_steps_per_s": v for kk, v in runs.items()}}


@contextlib.contextmanager
def inverse_calls():
    """Counts the calls of ``chol_block.chol_block`` with ``inverse=True``
    made inside the block."""
    from gpvae_tpu_torch.ops import chol_block

    counts = {"inverse": 0}
    real = chol_block.chol_block

    def call(*args, **kwargs):
        counts["inverse"] += bool(kwargs.get("inverse"))
        return real(*args, **kwargs)

    chol_block.chol_block = call
    try:
        yield counts
    finally:
        chol_block.chol_block = real


def fused_path(dev, t, n, method, *, needs, with_grad) -> dict:
    """``ops.chol.cholesky(k, method=method)`` of a pre-built masked bank
    ``k [n/2, 2, t, t]`` with every counter set to 0 just before and read
    just after, and no library factorization or solve in between: the
    launches exactly ``needs`` (name: count; ``"inverse"``, the
    ``chol_block`` launches with L^-1) and no other factorization kernel,
    the factor within :func:`fused_band` of float64.  With ``with_grad``
    the backward of ``sum(L * W)`` runs inside the counted window too
    (``tri_inv`` launches there), and its gradient is held against
    ``method="xla"`` in float64 (plain versions on the card) within
    ``FUSED_GRAD_REL`` or 5x the float32 library route's error."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol

    rng = np.random.default_rng(t)
    times, mask, ls, var = flat_inputs(rng, n, t, dev)
    k64 = kernels_lib.gram(times.double(), ls.double()[:, None, None],
                           variance=var.double()[:, None, None], mask=mask)
    k = k64.float().reshape(n // 2, 2, t, t).requires_grad_(with_grad)
    w = torch.tensor(rng.standard_normal((t, t)), dtype=torch.float32,
                     device=dev)
    label = f"cholesky(method={method!r}) T={t} N={n}"
    reset_counts()
    with library_calls() as lib_calls, inverse_calls() as inv_calls:
        t0 = time.perf_counter()
        l = chol.cholesky(k, method=method)
        if with_grad:
            torch.sum(l * w).backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_counts()
    if any(lib_calls.values()):
        fail(f"{label} called the library: {lib_calls}")
    got = dict(launches, inverse=inv_calls["inverse"])
    factor_kernels = ("gram_chol", "gram_panel", "panel_solve", "hist_panel",
                      "diag_logdet", "chol_block", "trail_panel",
                      "trail_update")
    for name in factor_kernels + ("inverse",):
        if got[name] != needs.get(name, 0):
            fail(f"{label} launched {name} {got[name]} times, not "
                 f"{needs.get(name, 0)}")
    if with_grad:  # the reverse mode's inverse of L
        check_launches(label, launches, ("tri_inv",), ())
    ref = torch.linalg.cholesky(k64)
    kf = k.detach().reshape(n, t, t)
    err = (l.detach().reshape(n, t, t).double() - ref).abs().max().item()
    band = fused_band(kf, ref, method)
    if not (math.isfinite(err) and err <= band):
        fail(f"{label}: max abs err {err:.3e} > {band:.3e}")
    if bool((torch.triu(l.detach(), 1) != 0).any()):
        fail(f"{label}: strict upper triangle of L not zero")
    out = {"method": method, "time_len": t, "matrices": n,
           "launches": launches, "inverse_launches": inv_calls["inverse"],
           "library_calls": dict(lib_calls), "seconds": seconds,
           "max_abs_err": err, "band": band}
    if not with_grad:
        return out

    def grad(kk, m):
        kk = kk.detach().requires_grad_(True)
        torch.sum(chol.cholesky(kk, method=m) * w.to(kk.dtype)).backward()
        return kk.grad.double()

    with plain_versions():
        g64 = grad(k64.reshape(k.shape), "xla")
    g_lib = grad(k, "xla")

    def rel(g):
        return (torch.linalg.norm(g - g64) / torch.linalg.norm(g64)).item()

    g_err, g_lib_err = rel(k.grad.double()), rel(g_lib)
    g_band = max(FUSED_GRAD_REL, FUSED_VS_LIBRARY * g_lib_err)
    if not (math.isfinite(g_err) and g_err <= g_band):
        fail(f"{label}: gradient rel err {g_err:.3e} > {g_band:.3e} "
             f"(method='xla' float32: {g_lib_err:.3e})")
    out.update(grad_rel_err=g_err, grad_band=g_band,
               grad_rel_err_xla_float32=g_lib_err)
    return out


def gram_bank_impls(dev) -> dict:
    """``gp.chol_gram_bank(impl="xla")`` (``kernels.gram_bank`` and the
    library) against ``impl="auto"`` (the gram-in-kernel factorization) at
    B=32, Z=2, T=1024, each with the counters reset around it, both against
    float64: ``auto`` within ``L_VS_LIBRARY`` x the ``xla`` route's
    error."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import gp, kernels as kernels_lib

    times, ls, mask, var = bank_inputs(np.random.default_rng(11), BENCH_B,
                                       LONG_T, SYN_Z, True, dev)
    out = {}
    for impl in ("xla", "auto"):
        reset_counts()
        with library_calls() as lib_calls:
            l = gp.chol_gram_bank(times, ls, mask=mask, variance=var,
                                  impl=impl)
            torch.cuda.synchronize()
        out[impl] = {"launches": read_counts(),
                     "library_calls": dict(lib_calls), "l": l}
    if sum(out["xla"]["launches"].values()) or out["xla"]["library_calls"][
            "cholesky_ex"] != 1:
        fail(f"chol_gram_bank(impl='xla') launched {out['xla']['launches']}"
             f", library {out['xla']['library_calls']}")
    if any(out["auto"]["library_calls"].values()):
        fail("chol_gram_bank(impl='auto') called the library")
    check_launches("chol_gram_bank(impl='auto')", out["auto"]["launches"],
                   ("chol_block", "gram_panel", "panel_solve"),
                   ("trail_panel", "trail_update", "hist_panel"))
    ref = torch.linalg.cholesky(kernels_lib.gram_bank(
        times.double(), ls.double(), mask=mask, variance=var.double()))
    err, ratio = check_l("chol_gram_bank(impl='auto') T=1024",
                         out["auto"]["l"], ref, out["xla"]["l"])
    return {"time_len": LONG_T, "batch": BENCH_B,
            "launches": {k: v["launches"] for k, v in out.items()},
            "auto_max_abs_err": err, "auto_vs_xla": ratio}


def method_paths(dev) -> dict:
    """Phase 4e: the right-looking route, each run its own path (counters
    reset around it); and the two ``chol_gram_bank`` implementations."""
    def needs(t, nb):  # one chol_block a block, L^-1 and a step but last
        b = -(-t // nb)
        return {"chol_block": b, "inverse": b - 1, "trail_panel": b - 1,
                "trail_update": b - 1}

    paths = {
        f"cholesky_blocked_fused_T{LONG_T}": fused_path(
            dev, LONG_T, 128, "blocked_fused", with_grad=True,
            needs=needs(LONG_T, 128)),
        "cholesky_blocked_fused_64_T256": fused_path(
            dev, 256, 128, "blocked_fused_64", with_grad=False,
            needs=needs(256, 64)),
    }
    for name, fields in paths.items():
        phase("method_path", name=name, **fields)
    impls = gram_bank_impls(dev)
    phase("chol_gram_bank_impls", **impls)
    return paths


# -- phase 5 ------------------------------------------------------------------

def time_kernel(name, kernel_fn, plain_fn, library_fn, nbytes, flops,
                shape, kernel=None, tensor_flops=None,
                peak_flops=PEAK_FP32_FLOPS) -> dict:
    """``ms``, ``plain_ms``, ``library_ms``: CUDA-event time per call of
    back-to-back calls, which is the host's time per call wherever that
    exceeds the card's.  ``*_device_ms``: the card's own time per call,
    summed over the kernels the profiler saw in ``PROFILED_CALLS`` calls;
    ``kernel_device_ms``, the mean of the hand-written kernel ``kernel``'s
    launches alone, beside how many of them the profiler saw and its launch
    counter counted (the kernel's window is profiled again, up to three
    times in all, while the two differ).  ``tensor_flops``: the TF32
    operations a tensor-core kernel issues for the same work, whose time at
    the tensor cores' peak is ``tensor_floor_ms``.  ``peak_flops``: the
    rate ``bound_ms`` holds ``flops`` to."""
    ms = cuda_ms(kernel_fn)
    plain_ms = cuda_ms(plain_fn)
    library_ms = cuda_ms(library_fn) if library_fn is not None else None
    for attempt in range(1, 4):
        # a trace that lost launches of the kernel is taken again
        dev = device_profile(kernel_fn, PROFILED_CALLS, kernel, label=name)
        if kernel is None or dev["kernel_seen"] == dev["kernel_counted"]:
            break
    plain = device_profile(plain_fn, PROFILED_CALLS,
                           label=f"{name} (plain)")
    library = (device_profile(library_fn, PROFILED_CALLS,
                              label=f"{name} (library)")
               if library_fn is not None else None)
    b_ms, b_by = bound_ms(nbytes, flops, peak_flops)
    out = {"name": name, "shape": shape, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "device_ms": dev["device_us"] / 1e3,
           "plain_device_ms": plain["device_us"] / 1e3,
           "library_device_ms": (library["device_us"] / 1e3
                                 if library is not None else None),
           "kernels_per_call": dev["kernels"],
           "plain_kernels_per_call": plain["kernels"],
           "host_ms_per_call_profiled": dev["wall_us"] / 1e3,
           "profiled_attempts": attempt,
           "tensor_floor_ms": (tensor_flops / PEAK_TF32_FLOPS * 1e3
                               if tensor_flops is not None else None)}
    if kernel is not None:
        out.update(kernel_device_ms=dev["kernel_us"] / 1e3,
                   kernel_launches_seen=dev["kernel_seen"],
                   kernel_launches_counted=dev["kernel_counted"])
    return out


def time_kernels(dev) -> dict:
    """Each kernel at its main-path shape: ``syn_data`` for ``gram_chol``
    and ``tri_inv`` (N=80, T=45), the T=1024 path for the rest (N=128
    matrices; for ``diag_logdet`` the stacked bank the ELBO reads).  Then whole
    functions: ``chol_block`` with L^-1, the factorization and
    ``tri_inv`` at T=100 and 1024, and ``tri_inv``'s base call at
    T=1024."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import (
        blocked, chol_block, gram_chol, logdet, tri_inv,
    )

    rng = np.random.default_rng(1)
    f = 4  # bytes of a float32
    res = {}
    # gram_chol at syn_data's shape
    times, ls, mask, var = bank_inputs(rng, SYN_B, SYN_T, 2 * SYN_Z, True,
                                       dev)
    n, t = SYN_B * 2 * SYN_Z, SYN_T
    k = kernels_lib.gram_bank(times, ls, mask=mask)
    res["gram_chol"] = time_kernel(
        "gram_chol",
        lambda: gram_chol.gram_chol_fused(times, ls, mask=mask),
        lambda: gram_chol.gram_chol_plain(times, ls, mask=mask),
        lambda: torch.linalg.cholesky(k),
        # times [B, T] float32, mask [B, T] bool, ls [Z]; L written whole
        f * SYN_B * t + SYN_B * t + f * 2 * SYN_Z + f * n * t * t,
        n * (t ** 3 / 3 + GRAM_OPS * t * t), f"N={n}, T={t}",
        kernel="gram_chol")
    # one kernel a call: its wrapper launched one a call, every kernel the
    # profiler saw in the window was that one, and it saw no more of them
    # than were counted (the profiler may drop a launch's record: it saw
    # 19 of 20 once on an H100)
    g = res["gram_chol"]
    seen_all = round(g["kernels_per_call"] * PROFILED_CALLS)
    seen = g["kernel_launches_seen"]
    if not (0 < seen == seen_all
            and seen <= g["kernel_launches_counted"] == PROFILED_CALLS):
        fail(f"gram_chol_fused: {g['kernel_launches_counted']} launches "
             f"counted in {PROFILED_CALLS} calls, the profiler saw "
             f"{seen_all} kernels, {g['kernel_launches_seen']} of them "
             f"gram_chol's: not one kernel a call")
    lb = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(
        -1, t, t).contiguous()
    eye = torch.eye(t, device=dev).expand_as(lb)
    res["tri_inv"] = time_kernel(
        "tri_inv", lambda: tri_inv.tri_inv_cuda(lb),
        lambda: tri_inv.tri_inv_plain(lb),
        lambda: torch.linalg.solve_triangular(lb, eye, upper=False),
        # the lower triangle of L read, X written whole
        f * n * (t * (t + 1) / 2 + t * t), n * t ** 3 / 3, f"N={n}, T={t}",
        kernel="tri_inv")
    whole = time_zoo_kernels(dev)

    # the T=1024 factorization's pieces, N=128, block width 128
    n, t, nb = BENCH_B * 2 * SYN_Z, LONG_T, blocked.NB
    times, mask, ls, var = flat_inputs(rng, n, t, dev)
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    k00 = kernels_lib.gram(times[:, :nb], ls[:, None, None],
                           variance=var[:, None, None], mask=mask[:, :nb])
    out = torch.empty_like(k00)
    res["chol_block"] = time_kernel(
        "chol_block", lambda: chol_block.chol_block(k00, out=out),
        lambda: chol_block.chol_block_plain(k00, out=out),
        lambda: torch.linalg.cholesky(k00),
        f * n * (nb * (nb + 1) / 2 + nb * nb), n * nb ** 3 / 3,
        f"N={n}, t={nb}, pre-built (each diagonal block of T={t})",
        kernel="chol_block")
    # its inverse mode, which no main path launches (no single PyTorch
    # call computes both L and L^-1)
    whole["chol_block_inverse"] = time_kernel(
        "chol_block (with L^-1)",
        lambda: chol_block.chol_block(k00, inverse=True, out=out),
        lambda: chol_block.chol_block_plain(k00, inverse=True, out=out),
        None, f * n * (nb * (nb + 1) / 2 + 2 * nb * nb),
        2 * n * nb ** 3 / 3, f"N={n}, t={nb}, pre-built, L and L^-1",
        kernel="chol_block")
    # its gram mode, block 0 of the T=1024 factorization (the library call
    # factors the pre-built gram)
    tb, mb = times[:, :nb], mask[:, :nb]
    whole["chol_block_gram"] = time_kernel(
        "chol_block (gram mode)",
        lambda: chol_block.gram_chol_block(tb, mb, ls, var, out=out),
        lambda: chol_block.gram_chol_block_plain(tb, mb, ls, var, out=out),
        lambda: torch.linalg.cholesky(k00),
        # the time and mask vectors and ls, var read, L written whole
        f * n * (2 * nb + 2 + nb * nb), n * (nb ** 3 / 3 + GRAM_OPS * nb * nb),
        f"N={n}, t={nb}, from the time vectors", kernel="chol_block")
    o, w = t // 2, nb
    scratch = l.clone()
    kp = blocked.gram_tile(times, mask, ls, var, slice(o, t), slice(o, o + w))
    rows, cols = scratch[:, o:, :o], scratch[:, o:o + w, :o]
    res["gram_panel"] = time_kernel(
        "gram_panel",
        lambda: blocked.gram_panel(scratch, times, mask, ls, var, o, o, w),
        lambda: blocked.gram_panel_plain(scratch, times, mask, ls, var, o, o,
                                         w),
        lambda: torch.baddbmm(kp, rows, cols.mT, alpha=-1.0),
        # L[:, o:, :o] read (its rows o..o+w are the history's second
        # operand), the panel written, the time vectors read
        f * n * ((t - o) * o + (t - o) * w + 2 * t),
        n * (2.0 * (t - o) * w * o + GRAM_OPS * (t - o) * w),
        f"N={n}, T={t}, block 4 (rows {o}-{t}, history {o})",
        kernel="gram_panel", tensor_flops=3 * n * 2.0 * (t - o) * w * o)
    ld = scratch[:, o:o + w, o:o + w]
    sub = scratch[:, o + w:, o:o + w]
    r = t - o - w
    res["panel_solve"] = time_kernel(
        "panel_solve", lambda: blocked.panel_solve(scratch, o, w),
        lambda: blocked.panel_solve_plain(scratch, o, w),
        lambda: torch.linalg.solve_triangular(ld.mT, sub, upper=True,
                                              left=False),
        f * n * (w * (w + 1) / 2 + 2 * r * w + r * w), n * float(r) * w * w,
        f"N={n}, T={t}, block 4 ({r} rows of {w})",
        kernel="panel_solve")
    bank = l.reshape(BENCH_B, 2 * SYN_Z, t, t)
    res["diag_logdet"] = time_kernel(
        "diag_logdet", lambda: logdet.diag_logdet_cuda(bank),
        lambda: logdet.diag_logdet_plain(bank),
        lambda: torch.diagonal(bank, dim1=-2, dim2=-1).log().sum(-1),
        # one sector per diagonal element (stride T + 1), a float a result
        SECTOR_BYTES * n * t + f * n, 2.0 * n * t,
        f"[{BENCH_B}, {2 * SYN_Z}, {t}, {t}] (the stacked training bank, "
        f"N={n})", kernel="diag_logdet")
    del scratch, rows, cols, ld, sub, kp

    # whole functions of the large-T path: the factorization at T=100 and
    # 1024, tri_inv at T=100 and 1024 (N=64: the KL's prior half)
    for tt in (BENCH_T, LONG_T):
        times, mask, ls, var = flat_inputs(rng, n, tt, dev)
        kk = kernels_lib.gram(times, ls[:, None, None],
                              variance=var[:, None, None], mask=mask)

        def drive(times=times, mask=mask, ls=ls, var=var):
            return blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)

        def drive_plain(drive=drive):
            with plain_versions():
                return drive()

        whole[f"factorization_T{tt}"] = time_kernel(
            "factorization", drive, drive_plain,
            lambda kk=kk: torch.linalg.cholesky(kk),
            f * n * (tt * tt + 2 * tt + 2), n * (tt ** 3 / 3
                                                 + GRAM_OPS * tt * tt),
            f"N={n}, T={tt}", kernel="chol_block")
        lf = drive()[: n // 2]
        eye = torch.eye(tt, device=dev).expand_as(lf)

        def inv_plain(lf=lf):
            with plain_versions():
                return tri_inv.tri_inv(lf)

        whole[f"tri_inv_T{tt}"] = time_kernel(
            "tri_inv", lambda lf=lf: tri_inv.tri_inv(lf), inv_plain,
            lambda lf=lf, eye=eye: torch.linalg.solve_triangular(
                lf, eye, upper=False),
            f * (n // 2) * (tt * (tt + 1) / 2 + tt * tt),
            (n // 2) * tt ** 3 / 3, f"N={n // 2}, T={tt}",
            kernel="tri_inv")
        del kk, lf, eye

    # tri_inv at the T=1024 flat route's base call: the diagonal blocks of
    # 64 of the KL's N=64 prior factors, 1,024 matrices
    # (its own draws, so that the banks below stay those of earlier runs)
    times, mask, ls, var = flat_inputs(np.random.default_rng(4), n // 2, t,
                                       dev)
    lf = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    base = torch.diagonal(lf.view(n // 2, t // 64, 64, t // 64, 64),
                          dim1=1, dim2=3).permute(0, 3, 1, 2).reshape(
                              -1, 64, 64).contiguous()
    eye = torch.eye(64, device=dev).expand_as(base)
    nb_ = base.shape[0]
    whole["tri_inv_base_T1024"] = time_kernel(
        "tri_inv (base call)", lambda: tri_inv.tri_inv_cuda(base),
        lambda: tri_inv.tri_inv_plain(base),
        lambda: torch.linalg.solve_triangular(base, eye, upper=False),
        f * nb_ * (64 * 65 / 2 + 64 * 64), nb_ * 64 ** 3 / 3,
        f"N={nb_}, T=64 (the T=1024 flat route's base call)",
        kernel="tri_inv")
    del lf, base, eye

    # the imputation path at its T=1024 shape: N = 32 sequences x 2
    # latents of a pre-built bank; hist_panel at the middle step
    n = BENCH_B * SYN_Z
    times, mask, ls, var = flat_inputs(rng, n, t, dev)
    k = kernels_lib.gram(times, ls[:, None, None],
                         variance=var[:, None, None], mask=mask)
    lk = blocked.cholesky_inplace(k)
    scratch = lk.clone()
    kp = k[:, o:, o:o + w]
    rows, cols = scratch[:, o:, :o], scratch[:, o:o + w, :o]
    res["hist_panel"] = time_kernel(
        "hist_panel", lambda: blocked.hist_panel(scratch, k, o, o, w),
        lambda: blocked.hist_panel_plain(scratch, k, o, o, w),
        lambda: torch.baddbmm(kp, rows, cols.mT, alpha=-1.0),
        # the K panel read, L[:, o:, :o] read once (its rows o..o+w are
        # the history's second operand), the panel written
        f * n * ((t - o) * w + (t - o) * o + (t - o) * w),
        2.0 * n * (t - o) * w * o,
        f"N={n}, T={t}, block 4 (rows {o}-{t}, history {o})",
        kernel="hist_panel", tensor_flops=3 * 2.0 * n * (t - o) * w * o)
    del scratch, rows, cols, kp, lk

    def factor_plain():
        with plain_versions():
            return blocked.cholesky_inplace(k)

    whole["prebuilt_factorization_T1024"] = time_kernel(
        "prebuilt factorization", lambda: blocked.cholesky_inplace(k),
        factor_plain, lambda: torch.linalg.cholesky(k),
        # K's lower triangle read, L written whole
        f * n * (t * (t + 1) / 2 + t * t), n * t ** 3 / 3.0,
        f"N={n}, T={t}, pre-built", kernel="hist_panel")
    res.update(time_trail_kernels(dev, rng))
    whole.update(time_methods(dev, rng))
    return res, whole


def time_zoo_kernels(dev) -> dict:
    """``gram_chol`` and ``tri_inv`` at the zoo's training shape, the
    stacked bank of ``full_gp_dynamic`` (B=5, 2Z=200, T=20: N=1000 masked
    factors), and ``chol_block`` at evaluate's (``ops.chol.cholesky`` of
    the pre-built [16, 100, 20, 20] bank, N=1600)."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol, gram_chol, tri_inv

    rng = np.random.default_rng(6)  # its own draws: later banks unchanged
    f, t, b, z = 4, ZOO_T, 5, 2 * ZOO_Z
    n = b * z
    times, ls, mask, _ = bank_inputs(rng, b, t, z, True, dev)
    k = kernels_lib.gram_bank(times, ls, mask=mask)
    out = {"gram_chol_T20": time_kernel(
        "gram_chol",
        lambda: gram_chol.gram_chol_fused(times, ls, mask=mask),
        lambda: gram_chol.gram_chol_plain(times, ls, mask=mask),
        lambda: torch.linalg.cholesky(k),
        f * b * t + b * t + f * z + f * n * t * t,
        n * (t ** 3 / 3 + GRAM_OPS * t * t), f"N={n}, T={t}",
        kernel="gram_chol")}
    lb = gram_chol.gram_chol_fused(times, ls, mask=mask).reshape(
        -1, t, t).contiguous()
    eye = torch.eye(t, device=dev).expand_as(lb)
    out["tri_inv_T20"] = time_kernel(
        "tri_inv", lambda: tri_inv.tri_inv_cuda(lb),
        lambda: tri_inv.tri_inv_plain(lb),
        lambda: torch.linalg.solve_triangular(lb, eye, upper=False),
        f * n * (t * (t + 1) / 2 + t * t), n * t ** 3 / 3, f"N={n}, T={t}",
        kernel="tri_inv")
    times, ls, mask, _ = bank_inputs(rng, 16, t, ZOO_Z, True, dev)
    kb = kernels_lib.gram_bank(times, ls, mask=mask) + 1e-5 * torch.eye(
        t, device=dev)
    ne = 16 * ZOO_Z

    def factor_plain():
        with plain_versions():
            return chol.cholesky(kb)

    out["chol_block_T20"] = time_kernel(
        "chol_block", lambda: chol.cholesky(kb), factor_plain,
        lambda: torch.linalg.cholesky(kb),
        f * ne * (t * (t + 1) / 2 + t * t), ne * t ** 3 / 3,
        f"N={ne}, T={t}, pre-built (evaluate's bank)", kernel="chol_block")
    return out


def time_trail_kernels(dev, rng) -> dict:
    """B23's kernels at the middle step (o=384) of ``cholesky(method=
    "blocked_fused")`` at T=1024, N=128, each repeated in place on the
    state the first three steps leave: ``trail_update`` on the X its step
    made, then ``trail_panel``.  Bounds count what the function needs: the
    lower triangle of the downdate, and X against the triangular
    ``Ld^-T``."""
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol_block, trail

    f, t, nb = 4, LONG_T, trail.WIDTHS[-1]
    n, o = BENCH_B * 2 * SYN_Z, t // 2 - nb
    r2 = t - o - nb
    times, mask, ls, var = flat_inputs(rng, n, t, dev)
    l = kernels_lib.gram(times, ls[:, None, None],
                         variance=var[:, None, None], mask=mask)
    for oo in range(0, o + nb, nb):
        d = l[:, oo:oo + nb, oo:oo + nb]
        _, inv = chol_block.chol_block(d, inverse=True, out=d)
        trail.trail_panel(l, inv, oo)
        if oo < o:
            trail.trail_update(l, oo, nb)
    x, s22 = l[:, o + nb:, o:o + nb], l[:, o + nb:, o + nb:]
    shape = f"N={n}, T={t}, step 4 (o={o}, {r2} rows below the block)"
    tiles = -(-r2 // trail.TILE)
    res = {"trail_update": time_kernel(
        "trail_update", lambda: trail.trail_update(l, o, nb),
        lambda: trail.trail_update_plain(l, o, nb),
        lambda: torch.baddbmm(s22, x, x.mT, alpha=-1.0),
        # X read, the lower triangle of the square read and written
        f * n * (r2 * nb + r2 * (r2 + 1)), n * float(nb) * r2 * (r2 + 1),
        shape, kernel="trail_update",
        # the 64 x 64 tiles on and below the diagonal, three products each
        tensor_flops=3 * n * 2.0 * nb * 64 * 64 * tiles * (tiles + 1) / 2)}
    res["trail_panel"] = time_kernel(
        "trail_panel", lambda: trail.trail_panel(l, inv, o),
        lambda: trail.trail_panel_plain(l, inv, o), lambda: x @ inv.mT,
        # the panel read, X and the zero tile L[o:o+nb, o+nb:] written,
        # Ld^-1's lower triangle read; x @ inv.mT writes no zero tile
        f * n * (3 * r2 * nb + nb * (nb + 1) / 2),
        n * float(r2) * nb * (nb + 1), shape, kernel="trail_panel")
    return res


def time_methods(dev, rng) -> dict:
    """``ops.chol.cholesky`` of a pre-built masked bank under ``auto``,
    ``blocked_fused`` and ``xla`` at each of ``METHOD_SHAPES`` (each
    method's plain versions beside it; the library's call is ``xla``)."""
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import chol

    f = 4
    out = {}
    for t, n in METHOD_SHAPES:
        times, mask, ls, var = flat_inputs(rng, n, t, dev)
        k = kernels_lib.gram(times, ls[:, None, None],
                             variance=var[:, None, None], mask=mask)
        for method in ("auto", "blocked_fused", "xla"):
            def call(method=method, k=k):
                return chol.cholesky(k, method=method)

            def call_plain(call=call):
                with plain_versions():
                    return call()

            out[f"cholesky_{method}_T{t}_N{n}"] = time_kernel(
                f"cholesky(method={method!r})", call, call_plain, None,
                # K's lower triangle read, L written whole
                f * n * (t * (t + 1) / 2 + t * t), n * t ** 3 / 3.0,
                f"N={n}, T={t}, pre-built",
                kernel=None if method == "xla" else "chol_block")
        del k
    return out


def time_healing_fitc_kernels(dev) -> dict:
    """The kernels at the shapes ``healing_mnist`` and ``sparse_t4096``
    give them: ``gram_chol`` with the Cauchy kernel at healing's step
    (one shared grid of T=10, N=128), ``chol_block`` and ``tri_inv`` at
    FITC's (N=64 inducing grams of m=64, pre-built, the float32 jitter),
    and the pre-built factorization at evaluate's T=4096 bank (N=16)."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import blocked, chol_block, gram_chol, tri_inv

    rng = np.random.default_rng(12)  # its own draws: later banks unchanged
    f, t, n = 4, HEAL_T, 2 * HEAL_Z
    times = torch.arange(t, dtype=torch.float32, device=dev)[None]
    ls = torch.tensor(rng.uniform(0.5, 4.0, n), dtype=torch.float32,
                      device=dev)
    k = kernels_lib.gram_bank(times, ls, kernel="cauchy")
    out = {f"gram_chol_cauchy_T{t}_N{n}": time_kernel(
        "gram_chol",
        lambda: gram_chol.gram_chol_fused(times, ls, kernel="cauchy"),
        lambda: gram_chol.gram_chol_plain(times, ls, kernel="cauchy"),
        lambda: torch.linalg.cholesky(k),
        # one row of times, ls [N]; L written whole
        f * t + f * n + f * n * t * t, n * (t ** 3 / 3 + GRAM_OPS * t * t),
        f"N={n}, T={t}, Cauchy, one shared grid", kernel="gram_chol")}

    m, n = SPARSE_M, SPARSE_B * SPARSE_Z
    s = torch.linspace(0.0, 4096.0, m, device=dev)[None].expand(SPARSE_B, -1)
    ls = torch.full((SPARSE_Z,), 256.0, device=dev)
    k_mm = (kernels_lib.cross_gram(s, s, ls) + SPARSE_JITTER * torch.eye(
        m, device=dev)).reshape(n, m, m).contiguous()
    buf = torch.empty_like(k_mm)
    out[f"chol_block_fitc_m{m}_N{n}"] = time_kernel(
        "chol_block", lambda: chol_block.chol_block(k_mm, out=buf),
        lambda: chol_block.chol_block_plain(k_mm, out=buf),
        lambda: torch.linalg.cholesky(k_mm),
        f * n * (m * (m + 1) / 2 + m * m), n * m ** 3 / 3,
        f"N={n}, m={m}, pre-built (FITC's K_mm)", kernel="chol_block")
    lf = chol_block.chol_block(k_mm)[0]
    eye = torch.eye(m, device=dev).expand_as(lf)
    out[f"tri_inv_fitc_m{m}_N{n}"] = time_kernel(
        "tri_inv", lambda: tri_inv.tri_inv_cuda(lf),
        lambda: tri_inv.tri_inv_plain(lf),
        lambda: torch.linalg.solve_triangular(lf, eye, upper=False),
        f * n * (m * (m + 1) / 2 + m * m), n * m ** 3 / 3,
        f"N={n}, m={m} (L_mm)", kernel="tri_inv")

    batch = toy_batch(3, SPARSE_EVAL_B, SPARSE_T)
    t, n = SPARSE_T, SPARSE_EVAL_B * SPARSE_Z
    kept = torch.tensor(batch["mask"] & (rng.random(batch["mask"].shape)
                                         >= 0.5), device=dev)
    kb = (kernels_lib.gram_bank(torch.tensor(batch["times"], device=dev),
                                torch.full((SPARSE_Z,), 256.0, device=dev),
                                mask=kept)
          + 1e-5 * torch.eye(t, device=dev)).reshape(n, t, t)

    def factor_plain():
        with plain_versions():
            return blocked.cholesky_inplace(kb)

    out[f"prebuilt_factorization_T{t}_N{n}"] = time_kernel(
        "prebuilt factorization", lambda: blocked.cholesky_inplace(kb),
        factor_plain, lambda: torch.linalg.cholesky(kb),
        # K's lower triangle read, L written whole
        f * n * (t * (t + 1) / 2 + t * t), n * t ** 3 / 3.0,
        f"N={n}, T={t}, pre-built (evaluate's bank)", kernel="hist_panel")
    return out


def time_durbin(dev) -> dict:
    """The Durbin kernel at the ``t1024_toeplitz`` prior's rows (Z=2,
    T=1024) and at T in {4096, 8192, 16384, 65536} (Z=2; above 4096 the
    long route, a window of 32 steps a launch): CUDA-event time and the
    card's own time per call, without and with its kept steps (a learned
    prior's); its plain version (T - 1 steps of about 14 PyTorch ops, one
    timed call, one profiled; above T=4096 its time is phase 6's, filled
    in by the caller); the library's ``torch.linalg.cholesky`` and
    logdet of the dense ``[Z, T, T]`` Toeplitz matrices (float32,
    pre-built; up to T=16384, where they fit, and above T=4096 one timed
    call after one warm-up, not profiled); the bound,
    bytes (rho read, y, the logdet and e written, float64) over the memory
    rate or classical Durbin's 2 T^2 flops a row (Golub and Van Loan, Alg.
    4.7.1) over the float64 peak; and the chain floor,
    ``durbin_chain_kernel``'s T - 1 barriers and broadcasts at the same
    block size (above T=4096 the long route's launches with each window's
    steps as dependent shuffles), measured.

    Its reverse (``bwd_T*``) on the same rows up to T=16384, random
    cotangents on all three outputs: the kernel; up to T=4096
    ``durbin_bwd_plain`` and autograd of ``durbin_plain`` (forward and
    backward), one timed call each (above it phase 6's), profiled at
    T=1024 only (at T=4096 a profiled window
    of their ~10^5 launches costs minutes of host time); the library's
    autograd of
    the dense ``cholesky`` and logdet (float32, forward and backward);
    the bound, the kept steps and last inputs read and the gradient and
    cotangents moved over the memory rate, or the least flops of the
    function over the float64 peak: the reverse of classical Durbin,
    whose step k does a length-k inner product and a length-k update (4 k
    flops, 2 T^2 a row); reverse mode turns each of its FMAs into two, so
    4 T^2 a row, the states taken as given (recovering them, by
    recomputation or by the inverse step this kernel runs, is not billed);
    and its chain floor, ``durbin_bwd_chain_kernel``'s T - 1 warp
    reductions, barriers and sums of the warps' parts (above T=4096 the
    long route's two launches a window, each step a warp reduction)."""
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import durbin

    def bound(nbytes, flops):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FP64_FLOPS * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def kernel_window(fn, calls, kernel, label):
        # a trace that lost launches of the kernel is taken again, up to
        # three times in all, as in time_kernel
        for attempt in range(1, 4):
            prof = device_profile(fn, calls, kernel, label=label)
            if kernel is None or prof["kernel_seen"] == prof["kernel_counted"]:
                break
        return {**prof, "attempts": attempt}

    out = {}
    for t in (TOEP_T, 4096, *DURBIN_LONG_TS[1:]):
        long = t > 4096  # the long route: many kernels a call
        fits = t <= DURBIN_DENSE_TS[-1]  # the library's dense [Z, T, T]
        calls = 5 if long else PROFILED_CALLS
        row = cli_row(t, (9.0, 3.0), torch.float32, dev)
        z = row.shape[0]
        rho = (row[:, 1:] / row[:, :1]).double().contiguous()
        k = kernels_lib.toeplitz_to_dense(row) if fits else None

        def library(k=k):
            l = torch.linalg.cholesky(k)
            return 2.0 * torch.diagonal(l, dim1=-2, dim2=-1).log().sum(-1)

        kern = kernel_window(lambda rho=rho: durbin.durbin_cuda(rho),
                             calls, None if long else "durbin",
                             f"durbin T={t}")
        chain = device_profile(
            lambda t=t, z=z: durbin.chain_floor_cuda(z, t, dev),
            calls, label=f"durbin chain T={t}")
        plain = (None if long else
                 device_profile(lambda rho=rho: durbin.durbin_plain(rho),
                                label=f"durbin plain T={t}"))
        # above T=4096 the library's call takes 0.1-3 s: one timed call
        lib = (None if long else
               device_profile(library, PROFILED_CALLS,
                              label=f"durbin library T={t}"))
        out[f"T{t}"] = {
            "name": "durbin", "shape": f"Z={z}, T={t} (lengthscales 9, 3)",
            "ms": cuda_ms(lambda rho=rho: durbin.durbin_cuda(rho)),
            "ms_keeping_steps": cuda_ms(
                lambda rho=rho: durbin.durbin_cuda(rho, save=True)),
            "device_ms": kern["device_us"] / 1e3,
            "kernels_per_call": kern["kernels"],
            "profiled_attempts": kern["attempts"],
            "kernel_device_ms": None if long else kern["kernel_us"] / 1e3,
            "kernel_launches_seen": None if long else kern["kernel_seen"],
            "kernel_launches_counted": (None if long
                                        else kern["kernel_counted"]),
            "chain_floor_ms": cuda_ms(
                lambda t=t, z=z: durbin.chain_floor_cuda(z, t, dev)),
            "chain_floor_device_ms": chain["device_us"] / 1e3,
            "plain_ms": (None if long else
                         once_ms(lambda rho=rho: durbin.durbin_plain(rho))),
            "plain_device_ms": None if long else plain["device_us"] / 1e3,
            "plain_kernels_per_call": None if long else plain["kernels"],
            "library_ms": (None if not fits else once_ms(library) if long
                           else cuda_ms(library)),
            "library_device_ms": None if long else lib["device_us"] / 1e3,
            "library": "torch.linalg.cholesky + logdet of the dense "
                       "[Z, T, T] Toeplitz (float32, pre-built)",
            **bound(8.0 * z * (2 * (t - 1) + 2), 2.0 * z * t * t)}

        if t == DURBIN_LONG_TS[-1]:  # the forward only
            continue
        # the reverse
        gen = torch.Generator(device=dev).manual_seed(t)
        opts = dict(dtype=torch.float64, device=dev, generator=gen)
        cot = (torch.randn(z, **opts), torch.randn(z, t - 1, **opts),
               torch.randn(z, **opts))
        *_, (steps, last) = durbin.durbin_cuda(rho, save=True)
        r = rho.clone().requires_grad_(True)
        k_grad = k.clone().requires_grad_(True)

        def bwd(steps=steps, last=last, cot=cot):
            return durbin.durbin_bwd_cuda(steps, last, *cot)

        def bwd_plain(steps=steps, last=last, cot=cot):
            return durbin.durbin_bwd_plain(steps, last, *cot)

        def autograd_plain(r=r, cot=cot):
            outs = durbin.durbin_plain(r)
            return torch.autograd.grad(
                sum((o * c).sum() for o, c in zip(outs, cot)), r)

        def library_bwd(k=k_grad):
            l = torch.linalg.cholesky(k)
            ld = 2.0 * torch.diagonal(l, dim1=-2, dim2=-1).log().sum()
            return torch.autograd.grad(ld, k)

        kern = kernel_window(bwd, calls, None if long else "durbin_bwd",
                             f"durbin_bwd T={t}")
        chain = device_profile(
            lambda t=t, z=z: durbin.bwd_chain_floor_cuda(z, t, dev),
            calls, label=f"durbin_bwd chain T={t}")
        profiled = t == TOEP_T
        plain = (device_profile(bwd_plain, label=f"durbin_bwd plain T={t}")
                 if profiled else None)
        auto = (device_profile(autograd_plain,
                               label=f"durbin autograd plain T={t}")
                if profiled else None)
        lib = (None if long else
               device_profile(library_bwd, PROFILED_CALLS,
                              label=f"durbin_bwd library T={t}"))
        out[f"bwd_T{t}"] = {
            "name": "durbin_bwd",
            "shape": f"Z={z}, T={t} (lengthscales 9, 3), all three "
                     f"cotangents",
            "ms": cuda_ms(bwd), "device_ms": kern["device_us"] / 1e3,
            "kernels_per_call": kern["kernels"],
            "profiled_attempts": kern["attempts"],
            "kernel_device_ms": None if long else kern["kernel_us"] / 1e3,
            "kernel_launches_seen": None if long else kern["kernel_seen"],
            "kernel_launches_counted": (None if long
                                        else kern["kernel_counted"]),
            "chain_floor_ms": cuda_ms(
                lambda t=t, z=z: durbin.bwd_chain_floor_cuda(z, t, dev)),
            "chain_floor_device_ms": chain["device_us"] / 1e3,
            "plain_ms": None if long else once_ms(bwd_plain),
            "plain_device_ms": plain["device_us"] / 1e3 if plain else None,
            "plain_kernels_per_call": plain["kernels"] if plain else None,
            "autograd_plain_ms": None if long else once_ms(autograd_plain),
            "autograd_plain_device_ms": (auto["device_us"] / 1e3 if auto
                                         else None),
            "library_ms": once_ms(library_bwd) if long
                          else cuda_ms(library_bwd),
            "library_device_ms": None if long else lib["device_us"] / 1e3,
            "library": "autograd of torch.linalg.cholesky + logdet of the "
                       "dense [Z, T, T] Toeplitz (float32, forward and "
                       "backward)",
            **bound(8.0 * z * (4 * (t - 1) + 2 * t + 2 * (t - 1) + 2),
                    4.0 * z * t * t)}
    return out


def time_toeplitz_kl(ctx) -> dict:
    """The prior KL of the ``t1024_toeplitz`` batch (B=8, T=1024, Z=2; the
    trained model's means and posterior factor), by the Toeplitz route
    and by the dense prior's factor (:func:`prior_kl`), forward only:
    CUDA-event ms and the card's time and kernels per call."""
    import torch

    m, mean, aux, times = ctx["inputs"]
    out = {}
    for route in ("toeplitz", "dense"):
        def call(route=route):
            with torch.no_grad():
                return prior_kl(m, mean, aux, times, route)

        prof = device_profile(call, PROFILED_CALLS,
                              label=f"the {route} prior KL")
        out[route] = {"ms": cuda_ms(call),
                      "device_ms": prof["device_us"] / 1e3,
                      "kernels_per_call": prof["kernels"],
                      "top_kernels_us_per_call": prof["top"]}
    return out


def time_toeplitz_kernels(dev) -> dict:
    """The posterior bank's kernels at ``t1024_toeplitz``'s shape, N=2
    matrices of T=1024 (one shared grid, Z=2): ``chol_block`` on block 0,
    ``gram_panel`` and ``panel_solve`` at block 4, ``diag_logdet`` of the
    ``[1, 2, T, T]`` bank, the flat ``tri_inv`` of the factors (the
    Cholesky backward's), and the whole factorization."""
    import numpy as np
    import torch

    from gpvae_tpu_torch import kernels as kernels_lib
    from gpvae_tpu_torch.ops import blocked, chol_block, logdet, tri_inv

    rng = np.random.default_rng(17)  # its own draws: later banks unchanged
    f, n, t, nb = 4, TOEP_Z, TOEP_T, blocked.NB
    times, mask, ls, var = flat_inputs(rng, n, t, dev, masked=False)
    times = torch.linspace(0.0, 60.0, t, device=dev)[None].expand(n, t)
    times = times.contiguous()
    out = {}
    l = blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)
    k00 = kernels_lib.gram(times[:, :nb], ls[:, None, None],
                           variance=var[:, None, None], mask=mask[:, :nb])
    buf = torch.empty_like(k00)
    out[f"chol_block_toeplitz_N{n}"] = time_kernel(
        "chol_block", lambda: chol_block.chol_block(k00, out=buf),
        lambda: chol_block.chol_block_plain(k00, out=buf),
        lambda: torch.linalg.cholesky(k00),
        f * n * (nb * (nb + 1) / 2 + nb * nb), n * nb ** 3 / 3,
        f"N={n}, t={nb}, pre-built (a diagonal block of T={t})",
        kernel="chol_block")
    o, w = t // 2, nb
    scratch = l.clone()
    kp = blocked.gram_tile(times, mask, ls, var, slice(o, t), slice(o, o + w))
    rows, cols = scratch[:, o:, :o], scratch[:, o:o + w, :o]
    out[f"gram_panel_toeplitz_N{n}"] = time_kernel(
        "gram_panel",
        lambda: blocked.gram_panel(scratch, times, mask, ls, var, o, o, w),
        lambda: blocked.gram_panel_plain(scratch, times, mask, ls, var, o, o,
                                         w),
        lambda: torch.baddbmm(kp, rows, cols.mT, alpha=-1.0),
        f * n * ((t - o) * o + (t - o) * w + 2 * t),
        n * (2.0 * (t - o) * w * o + GRAM_OPS * (t - o) * w),
        f"N={n}, T={t}, block 4 (rows {o}-{t}, history {o})",
        kernel="gram_panel", tensor_flops=3 * n * 2.0 * (t - o) * w * o)
    ld = scratch[:, o:o + w, o:o + w]
    sub = scratch[:, o + w:, o:o + w]
    r = t - o - w
    out[f"panel_solve_toeplitz_N{n}"] = time_kernel(
        "panel_solve", lambda: blocked.panel_solve(scratch, o, w),
        lambda: blocked.panel_solve_plain(scratch, o, w),
        lambda: torch.linalg.solve_triangular(ld.mT, sub, upper=True,
                                              left=False),
        f * n * (w * (w + 1) / 2 + 2 * r * w + r * w), n * float(r) * w * w,
        f"N={n}, T={t}, block 4 ({r} rows of {w})", kernel="panel_solve")
    bank = l.reshape(1, n, t, t)
    out[f"diag_logdet_toeplitz_N{n}"] = time_kernel(
        "diag_logdet", lambda: logdet.diag_logdet_cuda(bank),
        lambda: logdet.diag_logdet_plain(bank),
        lambda: torch.diagonal(bank, dim1=-2, dim2=-1).log().sum(-1),
        SECTOR_BYTES * n * t + f * n, 2.0 * n * t,
        f"[1, {n}, {t}, {t}] (the posterior bank)", kernel="diag_logdet")
    eye = torch.eye(t, device=dev).expand_as(l)

    def inv_plain():
        with plain_versions():
            return tri_inv.tri_inv(l)

    out[f"tri_inv_toeplitz_N{n}"] = time_kernel(
        "tri_inv", lambda: tri_inv.tri_inv(l), inv_plain,
        lambda: torch.linalg.solve_triangular(l, eye, upper=False),
        f * n * (t * (t + 1) / 2 + t * t), n * t ** 3 / 3,
        f"N={n}, T={t} (the flat route, one base call)", kernel="tri_inv")
    kk = kernels_lib.gram(times, ls[:, None, None],
                          variance=var[:, None, None], mask=mask)

    def factor_plain():
        with plain_versions():
            return blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var)

    out[f"factorization_toeplitz_N{n}"] = time_kernel(
        "factorization",
        lambda: blocked.cholesky_gram_inplace(times, ls, mask > 0.5, var),
        factor_plain, lambda: torch.linalg.cholesky(kk),
        f * n * (t * t + 2 * t + 2), n * (t ** 3 / 3 + GRAM_OPS * t * t),
        f"N={n}, T={t}, one shared grid", kernel="chol_block")
    return out


def time_chol_bwd(dev) -> dict:
    """The Cholesky backward's kernel (its three passes) at the two
    training shapes (``CHOL_BWD_SHAPES``), beside its plain version and
    the 2 x 2-blocked library products ``ops.chol`` takes without it, and
    its bound: 2 T^3 N operations (the depths the triangles leave) at the
    3xTF32 rate of the tensor cores, or its bytes."""
    import torch

    from gpvae_tpu_torch.ops import chol, chol_bwd

    out = {}
    for t, n in CHOL_BWD_SHAPES:
        l, l_bar, g, x = chol_bwd_inputs(dev, t, n)

        def library(l=l, l_bar=l_bar, x=x, g=g):
            w11, w21, w22 = chol._phi_w_blocks(l, l_bar)
            w11.diagonal(dim1=-2, dim2=-1).add_(g[:, None])
            w22.diagonal(dim1=-2, dim2=-1).add_(g[:, None])
            return chol._tri_sandwich_blocks(x, w11, w21, w22)

        out[f"T{t}"] = time_kernel(
            "chol_bwd",
            lambda l=l, l_bar=l_bar, x=x, g=g: chol_bwd.chol_bwd_cuda(
                l, l_bar, x, g),
            lambda l=l, l_bar=l_bar, x=x, g=g: chol_bwd.chol_bwd_plain(
                l, l_bar, x, g),
            library,
            # the lower halves of L, L_bar and X read once a pass that
            # takes them, W and M written and read back whole, K_bar
            # written whole
            4.0 * n * t * t * 7, 2.0 * t ** 3 * n,
            f"N={n}, T={t}", kernel="chol_bwd",
            tensor_flops=3 * 2.0 * t ** 3 * n,
            peak_flops=PEAK_TF32_FLOPS / 3)
        del l, l_bar, g, x
        torch.cuda.empty_cache()
    return out


def time_call(call, seqs, label) -> dict:
    """Sequences scored per second by the host clock, median of 5 calls of
    ``call`` (each ends in the host reading the metrics), and the card's
    time and busy share of one profiled call."""
    call()
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        secs.append(time.perf_counter() - t0)
    secs.sort()
    prof = device_profile(call, label=label)
    return {"sequences_per_call": seqs,
            "seqs_imputed_per_s": seqs / secs[2],
            "seconds_per_call": secs, "device_us_per_call":
            prof["device_us"], "kernels_per_call": prof["kernels"],
            "wall_us_per_call_under_profiler": prof["wall_us"],
            "device_busy_share": prof["device_us"] / prof["wall_us"],
            "top_kernels_us_per_call": prof["top"]}


def time_evaluate(ctx, label) -> dict:
    """An imputation evaluate path (``imputation_metrics`` of the restored
    model on its batch, the kept mask and baseline noise given), timed by
    :func:`time_call`."""
    import torch

    from gpvae_tpu_torch import analysis, train as train_lib

    model, kept = ctx["model"], ctx["kept"]
    dev = next(model.parameters()).device
    b = train_lib.device_arrays(ctx["batch"], dev)
    kept = kept.to(dev)
    noise = torch.randn((kept.shape[0], kept.shape[1],
                         model.config.latent_dim),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    return time_call(
        lambda: analysis.imputation_metrics(model, b["x"], b["times"],
                                            b["mask"], kept=kept,
                                            baseline_eps=noise),
        kept.shape[0], label)


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
    import torch

    from gpvae_tpu_torch import analysis
    from gpvae_tpu_torch.ops import (
        _build, blocked, chol_block, chol_bwd, durbin, gram_chol, logdet,
        trail, tri_inv,
    )

    t_start = time.perf_counter()
    # -- 1. device -------------------------------------------------------
    smi = nvidia_smi_line()
    # the package turns TF32 off for cuDNN's convs when it is imported;
    # PyTorch keeps it off for matmuls
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on")
    if torch.backends.cudnn.allow_tf32:
        fail("torch.backends.cudnn.allow_tf32 is on after importing "
             "gpvae_tpu_torch")
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, allow_tf32=False, cudnn_allow_tf32=False)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    for module in (gram_chol, tri_inv, chol_block, blocked, logdet, trail,
                   durbin, chol_bwd):
        module.build()
    phase("build", seconds=time.perf_counter() - t0,
          nvcc_seconds=dict(_build.BUILD_SECONDS),
          ptxas={kernel_name(k): v for res in _build.RESOURCES.values()
                 for k, v in res.items()})

    # -- 3. kernels vs plain ---------------------------------------------
    worst = check_kernels(dev)
    worst_zoo = check_zoo_kernels(dev)
    worst_large = check_large_t_kernels(dev)
    worst_pre = check_prebuilt_kernels(dev)
    worst_trail = check_trail_kernels(dev)
    worst_solve = check_panel_solve(dev)
    worst_hf = check_healing_fitc_kernels(dev)
    worst_toep = check_toeplitz_kernels(dev)
    worst_bwd = check_chol_bwd_kernel(dev)
    phase("kernels_vs_plain", **worst, **worst_zoo, **worst_large,
          **worst_pre, **worst_trail, **worst_solve, **worst_hf,
          **worst_toep, **worst_bwd, chol_bwd_vs_plain_band=CHOL_BWD_VS_PLAIN,
          chol_bwd_bias_band=CHOL_BWD_BIAS,
          l_band=L_MAX_ABS,
          l_vs_library=L_VS_LIBRARY, panel_band=PANEL_ABS,
          cholesky_band_vs_library=CHOL_VS_LIBRARY,
          fused_band_vs_library=FUSED_VS_LIBRARY,
          fused_band_vs_plain=FUSED_VS_PLAIN, trail_terms_rel=TERMS_REL,
          tri_inv_band_rel_fro=TRI_INV_REL_FRO)

    # -- 4. main paths ---------------------------------------------------
    # training (a-c), then evaluate on each checkpoint (d); checkpoints go
    # to a directory of the checkout that is removed at the end
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_ckpt_", dir=root) as ck:
        paths, timing, context = main_paths(dev, ck)
        zoo, zoo_timing = zoo_paths(dev, ck)
        heal, timing["healing_mnist"], heal_ctx = healing_path(dev, ck)
        sparse, timing["sparse_t4096"], sparse_ctx = sparse_path(dev, ck)
        toep, timing["t1024_toeplitz"], toep_ctx = toeplitz_path(dev, ck)
        learned, timing["t1024_toeplitz_learned_prior"] = (
            learnable_toeplitz_path(dev, ck))
        toep_long, toep_long_timing = toeplitz_long_path(dev, ck)
        kstep = multistep_paths(dev)
        dp = dp_path(dev, ck)
    paths.update(zoo)
    paths.update(heal)
    paths.update(sparse)
    paths.update(toep)
    paths.update(learned)
    paths.update(toep_long)
    timing.update(toep_long_timing)
    paths.update(kstep)
    paths.update(dp)
    timing.update(zoo_timing)
    paths.update(method_paths(dev))

    # -- 5. timing -------------------------------------------------------
    per_kernel, whole = time_kernels(dev)
    new_shapes = time_healing_fitc_kernels(dev)
    new_shapes.update(time_toeplitz_kernels(dev))
    bwd_times = time_chol_bwd(dev)
    per_kernel["chol_bwd"] = bwd_times[f"T{LONG_T}"]
    new_shapes["chol_bwd_T8192"] = bwd_times[f"T{TOEP_LONG_T}"]
    durbin_times = time_durbin(dev)
    per_kernel["durbin"] = durbin_times[f"T{TOEP_T}"]
    new_shapes["durbin_T4096"] = durbin_times["T4096"]
    per_kernel["durbin_bwd"] = durbin_times[f"bwd_T{TOEP_T}"]
    new_shapes["durbin_bwd_T4096"] = durbin_times["bwd_T4096"]
    for key in (f"{pre}T{t}" for t in DURBIN_LONG_TS[1:]
                for pre in ("", "bwd_")):
        if key in durbin_times:  # the long route; its reverse to 16384
            new_shapes[f"durbin_{key}"] = durbin_times[key]
    whole.update(new_shapes)
    timing["prior_kl_t1024_toeplitz"] = time_toeplitz_kl(toep_ctx)
    timing["evaluate_t1024_toeplitz"] = time_evaluate(
        toep_ctx["evaluate"], "the t1024_toeplitz evaluate call")
    timing["evaluate_bench_t100_t1024"] = time_evaluate(
        context, "the T=1024 evaluate call")
    timing["evaluate_sparse_t4096"] = time_evaluate(
        sparse_ctx, "the T=4096 evaluate call")
    timing["syn_data_steps_per_call"] = time_kstep(dev)
    heal_model = heal_ctx["model"]
    timing["evaluate_healing_mnist"] = time_call(
        lambda: analysis.pixel_imputation_metrics(heal_model,
                                                  heal_ctx["batch"]),
        HEAL_EVAL_B, "the healing evaluate call")

    # -- 6. the Durbin kernels' long route vs plain -----------------------
    # after every profiled window, so that the plain versions' millions of
    # eager launches cannot disturb a window the profiler reads
    long_route = check_durbin_long(dev)
    phase("durbin_long_vs_plain", **long_route)
    for t in DURBIN_LONG_TS[1:]:
        case = (f"T={t} l=64 unit grid" if t == DURBIN_NEAR_T
                else f"T={t} t1024_toeplitz prior rows")
        for pre, side in (("", "forward"), ("bwd_", "reverse")):
            if f"{pre}T{t}" in durbin_times:
                durbin_times[f"{pre}T{t}"].update(
                    plain_ms=long_route["plain_ms"][side][case],
                    plain="one unwarmed call, phase 6's reference on "
                          + case)
    phase("timing", paths=timing, kernels=per_kernel, whole_functions=whole,
          seconds_so_far=time.perf_counter() - t_start)

    errors = {"gram_chol": max(worst["gram_chol"], worst_zoo["zoo_gram_chol"],
                               worst_hf["cauchy_gram_chol"]),
              "tri_inv": max(worst["tri_inv_abs"],
                             worst_large["tri_inv_large_abs"],
                             worst_zoo["zoo_tri_inv_abs"],
                             worst_hf["healing_fitc_tri_inv_abs"]),
              "chol_block": max(worst_large["chol_block"],
                                worst_zoo["zoo_cholesky"],
                                worst_hf["fitc_cholesky"]),
              "gram_panel": worst_large["gram_panel"],
              "panel_solve": max(worst_large["panel_solve"],
                                 worst_solve["panel_solve_shapes"],
                                 worst_hf["panel_solve_t4096"]),
              "diag_logdet": worst_large["diag_logdet"],
              "hist_panel": max(worst_pre["hist_panel"],
                                worst_hf["hist_panel_t4096"]),
              "trail_panel": worst_trail["trail_panel_abs"],
              "trail_update": worst_trail["trail_update_abs"],
              "durbin": max(worst_toep["durbin"], long_route["durbin_long"]),
              "durbin_bwd": max(worst_toep["durbin_bwd"],
                                long_route["durbin_bwd_long"]),
              "chol_bwd": worst_bwd["chol_bwd"]}
    ops = "gpvae_tpu/ops/"
    sources = {"gram_chol": ("gram_chol.cu", ops + "pallas_chol.py:673"),
               "tri_inv": ("tri_inv.cu", ops + "pallas_tri.py:39"),
               "chol_block": ("chol_block.cu", ops + "pallas_chol.py:198"),
               "gram_panel": ("gram_panel.cu", ops + "pallas_big.py:556"),
               "panel_solve": ("panel_solve.cu", ops + "pallas_big.py:1005"),
               "diag_logdet": ("diag_logdet.cu", ops + "pallas_big.py:237"),
               "hist_panel": ("gram_panel.cu", ops + "pallas_big.py:105"),
               "trail_panel": ("gram_panel.cu", ops + "pallas_trail.py:53"),
               "trail_update": ("gram_panel.cu", ops + "pallas_trail.py:53"),
               "durbin": ("durbin.cu",
                          "gpvae_tpu/toeplitz.py:88 (lax.scan, no Pallas)"),
               "durbin_bwd": ("durbin.cu",
                              "gpvae_tpu/toeplitz.py:88 (autodiff of the "
                              "lax.scan, no Pallas)"),
               "chol_bwd": ("chol_bwd.cu",
                            ops + "chol.py:497-578 (XLA's products, no "
                            "Pallas)")}
    # each kernel's times at the shapes of healing_mnist, sparse_t4096 and
    # t1024_toeplitz (hist_panel's: the whole T=4096 pre-built
    # factorization it leads; gram_panel's: the N=2 training one)
    at_new = {}
    lead = {"prebuilt factorization": "hist_panel",
            "factorization": "gram_panel"}
    for r in new_shapes.values():
        kernel = lead.get(r["name"], r["name"])
        at_new.setdefault(kernel, []).append({
            k: r[k] for k in ("name", "shape", "ms", "device_ms",
                              "kernel_device_ms", "plain_ms",
                              "plain_device_ms", "library_ms",
                              "library_device_ms", "bound_ms", "bound_by",
                              "tensor_floor_ms", "chain_floor_ms")
            if r.get(k) is not None})
    lines = []
    for name, (src, tpu) in sources.items():
        r = per_kernel[name]
        lines.append({
            "name": name, "route": "cuda",
            "source": f"gpvae_tpu_torch/csrc/{src}",
            "replaces": tpu,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "max_abs_err": errors[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "kernel_device_ms": r["kernel_device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            **{k: r[k] for k in ("tensor_floor_ms", "chain_floor_ms")
               if r.get(k) is not None},
            "at_new_shapes": at_new.get(name, [])})
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
