"""Terms both configurations share: the dense nets, the GP posterior of
an imputation call, and the kernel groups of a factorization."""
from __future__ import annotations

from portbench.counts import formulas as f
from portbench.peaks import HBM_BYTES, PEAK_FLOPS
from portbench.reference.gpvae import dense_layers

F32 = 4


def net_widths(cfg: dict) -> tuple[list[int], list[int]]:
    layers = dense_layers(cfg)
    return ([a for a, _ in layers["encoder"]] + [layers["encoder"][-1][1]],
            [a for a, _ in layers["decoder"]] + [layers["decoder"][-1][1]])


def nets_train(cfg: dict, rows: int) -> float:
    """Encoder and decoder forward and reverse on ``rows`` rows: the
    reverse of a product is two products of its size (the weights' and the
    inputs' cotangents), so three times the forward."""
    enc, dec = net_widths(cfg)
    return 3 * rows * (f.dense_net(enc) + f.dense_net(dec))


def nets_forward(cfg: dict, rows: int) -> float:
    enc, dec = net_widths(cfg)
    return rows * (f.dense_net(enc) + f.dense_net(dec))


def impute_terms(cfg: dict, mix: dict) -> list[tuple[str, float, str]]:
    """One imputation call of ``seqs_per_call`` sequences: the nets
    forward, each latent's gram factored (n^3/3), and the mean from two
    triangular solves and one product with one column."""
    b, t = mix["seqs_per_call"], mix["time_len"]
    n = b * cfg["model"]["latent_dim"]
    return [("nets", nets_forward(cfg, b * t), "fp32"),
            ("posterior_factor", n * f.cholesky(t), "fp32"),
            ("posterior_mean", n * (2 * f.tri_matvec(t) + f.matmul(t, 1, t)),
             "fp32")]


def group(name: str, kernels: str, launches: int, flops: float,
          precision: str, nbytes: float) -> dict:
    """A set of hand-written kernels and the least time their work takes
    on the card: ``launches`` a unit (step or call) matched by the regular
    expression ``kernels`` on the profiler's kernel names."""
    bound = max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES)
    return {"name": name, "kernels": kernels, "launches": launches,
            "flops": flops, "bytes": nbytes, "bound_s": bound}


def factor_group(n: int, t: int, *, prebuilt: bool) -> dict:
    """The blocked factorization of ``n`` matrices of side ``t`` (over 128):
    per 128-wide column block one panel (``gram_panel`` building the gram
    from the times, or ``hist_panel`` reading a pre-built one), one
    ``chol_block`` and, but for the last, one ``panel_solve``.  Bytes: the
    lower triangles written, and read too from a pre-built gram."""
    nb = f.blocks(t)
    tri = n * t * (t + 1) / 2 * F32
    panel = "hist_panel" if prebuilt else "gram_panel"
    return group("factor", rf"\b({panel}|chol_block|panel_solve)_kernel\b",
                 3 * nb - 1, n * f.cholesky(t), "fp32",
                 tri * (2 if prebuilt else 1))


def tri_inv_group(t: int, matrices: list[int]) -> dict:
    """``tri_inv_kernel``, the base of triangular inverses of side ``t`` (a
    multiple of 64), one launch for each entry of ``matrices``, the number
    of matrices that call inverts: every diagonal 64-block inverted, each
    block's triangle read and written once."""
    nblocks = sum(matrices) * (t // 64)
    return group("tri_inv", r"\btri_inv_kernel\b", len(matrices),
                 nblocks * f.tri_inverse(64), "fp32",
                 nblocks * 2 * (64 * 65 / 2) * F32)


def logdet_group(n: int, t: int) -> dict:
    """``diag_logdet_kernel``, once over the stacked bank: each diagonal
    element read, one logdet written a matrix."""
    return group("diag_logdet", r"\bdiag_logdet_kernel\b", 1, 2.0 * n * t,
                 "fp32", (n * t + n) * F32)
