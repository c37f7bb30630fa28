"""Counts of ``t1024_toeplitz``: one uniform grid shared by the batch, so
one posterior bank of Z matrices; the prior is Toeplitz, its KL from one
Durbin recursion (float64) and the Gohberg-Semencul inverse applied by
FFTs."""
from __future__ import annotations

from portbench.counts import common
from portbench.counts import formulas as f

F64 = 8


def _shape(cfg: dict, mix: dict) -> tuple[int, int, int]:
    return cfg["batch_size"], cfg["model"]["latent_dim"], mix["time_len"]


def step_terms(cfg: dict, mix: dict) -> list[tuple[str, float, str]]:
    """The operations one training step needs: the shared posterior bank
    factored and its factorization reversed, the Durbin recursion of each
    prior row, the KL's trace over the T columns of each factor and its
    quadratic term over the B Z means, each column one forward and two
    inverse real FFTs and as many in reverse, the sample, the nets."""
    b, z, t = _shape(cfg, mix)
    m = f.fft_len(t)
    return [("nets", common.nets_train(cfg, b * t), "fp32"),
            ("factor", z * f.cholesky(t), "fp32"),
            ("factor_reverse", z * f.cholesky_reverse(t), "fp32"),
            ("durbin", z * f.durbin(t), "fp64"),
            ("kl_fft", (6 * z * (t + b) + 2 * z) * f.rfft(m), "fp32"),
            ("sample", 3 * b * z * f.tri_matvec(t), "fp32")]


def call_terms(cfg: dict, mix: dict) -> list[tuple[str, float, str]]:
    return common.impute_terms(cfg, mix)


def durbin_group(z: int, t: int) -> dict:
    """The Durbin recursion of ``z`` rows of order ``t``, float64: one
    launch up to T = 4096, above it one a window of 32 steps and one to
    finish.  Bytes: the T - 1 correlations in, the T - 1 coefficients and
    two scalars a row out."""
    launches = 1 if t <= 4096 else -(-(t - 1) // 32) + 1
    return common.group(
        "durbin", r"\bdurbin_(window_|window_finish_)?kernel\b", launches,
        z * f.durbin(t), "fp64", z * (2 * (t - 1) + 2) * F64)


def kernel_groups(cfg: dict, mix: dict) -> list[dict]:
    """The hand-written kernels of one step or call: training factors the
    shared bank of Z matrices (the gram built in the kernels), takes their
    logdets, inverts them once in the factorization's reverse and runs the
    Durbin recursion; imputation factors its B Z pre-built grams, and
    inverts them where T <= 2048 (above, the library's float64 solve)."""
    if mix["kind"] == "train":
        _, z, t = _shape(cfg, mix)
        return [common.factor_group(z, t, prebuilt=False),
                common.logdet_group(z, t),
                common.tri_inv_group(t, [z]),
                durbin_group(z, t)]
    n, t = mix["seqs_per_call"] * cfg["model"]["latent_dim"], mix["time_len"]
    groups = [common.factor_group(n, t, prebuilt=True)]
    if t <= 2048:
        groups.append(common.tri_inv_group(t, [n]))
    return groups
