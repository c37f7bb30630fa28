"""Counts of ``bench_t100``: a GP posterior and a GP prior of per-sequence
masked grams, B x Z matrices each, stacked into one bank of 2 B Z."""
from __future__ import annotations

from portbench.counts import common
from portbench.counts import formulas as f


def _shape(cfg: dict, mix: dict) -> tuple[int, int, int]:
    return cfg["batch_size"], cfg["model"]["latent_dim"], mix["time_len"]


def step_terms(cfg: dict, mix: dict) -> list[tuple[str, float, str]]:
    """The operations one training step needs: both banks factored, the
    prior factor inverted and multiplied into the posterior's for the KL's
    trace (and back to L_q), the posterior's factorization reversed (its
    lengthscales are learned; the prior's are not), the quadratic term and
    the sample, the nets."""
    b, z, t = _shape(cfg, mix)
    n = b * z
    return [("nets", common.nets_train(cfg, b * t), "fp32"),
            ("factor", 2 * n * f.cholesky(t), "fp32"),
            ("kl_inverse", n * f.tri_inverse(t), "fp32"),
            ("kl_trace", 2 * n * f.tri_tri_product(t), "fp32"),
            ("factor_reverse", n * f.cholesky_reverse(t), "fp32"),
            ("kl_quad_and_sample", 3 * 2 * n * f.tri_matvec(t), "fp32")]


def call_terms(cfg: dict, mix: dict) -> list[tuple[str, float, str]]:
    return common.impute_terms(cfg, mix)


def kernel_groups(cfg: dict, mix: dict) -> list[dict]:
    """The hand-written kernels of one step or call, by what they compute:
    training factors the stacked bank of 2 B Z matrices (the gram built in
    the kernels), takes its logdets in one launch, and inverts triangles
    twice (the prior's factors for the KL, the whole bank in the
    factorization's reverse); imputation factors its B Z pre-built grams
    and inverts them once."""
    if mix["kind"] == "train":
        b, z, t = _shape(cfg, mix)
        return [common.factor_group(2 * b * z, t, prebuilt=False),
                common.logdet_group(2 * b * z, t),
                common.tri_inv_group(t, [b * z, 2 * b * z])]
    n, t = mix["seqs_per_call"] * cfg["model"]["latent_dim"], mix["time_len"]
    groups = [common.factor_group(n, t, prebuilt=True)]
    if t <= 2048:
        groups.append(common.tri_inv_group(t, [n]))
    return groups
