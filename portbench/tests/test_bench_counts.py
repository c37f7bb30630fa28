"""The counting formulas against operations counted one by one in plain
loops, and each configuration's counts against hand counts at small
shapes.  A formula may count less than the loops do (their lower-order
terms), never more, so no share of a peak reads high."""
from __future__ import annotations

import math

import pytest

from portbench import harness
from portbench.counts import bench_t100, common, formulas as f, t1024_toeplitz
from portbench.peaks import FP32_FLOPS, HBM_BYTES


class Ops:
    n = 0

    def __call__(self, k: int = 1) -> None:
        self.n += k


def cholesky_ops(n: int) -> int:
    ops = Ops()
    for j in range(n):
        ops(2 * j + 1)                      # the diagonal: j FMAs and a sqrt
        for _ in range(j + 1, n):
            ops(2 * j + 1)                  # j FMAs and a division
    return ops.n


def tri_inverse_ops(n: int) -> int:
    ops = Ops()
    for j in range(n):
        ops(1)                              # x_jj = 1 / l_jj
        for i in range(j + 1, n):
            ops(2 * (i - j) + 1)            # sum of i - j products, divide
    return ops.n


def tri_tri_ops(n: int) -> int:
    return sum(2 * (i - j + 1) - 1 for i in range(n) for j in range(i + 1))


def durbin_ops(n: int) -> int:
    """Golub and Van Loan's Durbin recursion, counted a line at a time."""
    ops = Ops()
    for k in range(1, n):
        ops(2)                              # beta = (1 - alpha^2) beta
        ops(2 * k)                          # alpha = -(r_k + r^T y) / beta
        ops(2 * (k - 1) + 1)                # z = y + alpha rev(y)
    return ops.n


def fft_ops(n: int) -> int:
    """A recursive radix-2 complex FFT: each butterfly one complex product
    (6 flops) and two complex sums (4)."""
    if n == 1:
        return 0
    return 2 * fft_ops(n // 2) + (n // 2) * 10


@pytest.mark.parametrize("n", [1, 2, 3, 8, 17, 64])
def test_cubic_formulas_count_no_more_than_the_loops(n):
    for formula, exact in ((f.cholesky, cholesky_ops),
                           (f.tri_inverse, tri_inverse_ops),
                           (f.tri_tri_product, tri_tri_ops)):
        assert formula(n) <= exact(n)
    if n == 64:
        assert f.cholesky(n) / cholesky_ops(n) > 0.97
        assert f.tri_inverse(n) / tri_inverse_ops(n) > 0.95
        assert f.tri_tri_product(n) / tri_tri_ops(n) > 0.97


@pytest.mark.parametrize("n", [2, 16, 1024])
def test_durbin_and_fft_formulas(n):
    assert f.durbin(n) >= durbin_ops(n) - 2 * n
    assert abs(f.durbin(n) - durbin_ops(n)) <= 3 * n
    assert fft_ops(n) == 5 * n * math.log2(n)
    assert f.rfft(n) == fft_ops(n) / 2


def test_small_formulas():
    assert f.matmul(2, 3, 4) == 2 * 3 * 7
    assert f.dense_net([3, 2, 1]) == 2 * 3 * 2 + 2 * 2 * 1
    assert f.tri_matvec(5) == 25
    assert f.cholesky_reverse(3) == 27
    assert f.blocks(128) == 1 and f.blocks(129) == 2 and f.blocks(1024) == 8
    assert [f.fft_len(t) for t in (1, 2, 3, 1024, 8192)] == [1, 4, 8, 2048,
                                                              16384]


def small(cell: str, **mix):
    c = harness.load_cell(cell)
    c.config["batch_size"] = 2
    c.mix.update(mix)
    return c.config, c.mix


NET = 2 * (15 * 32 + 32 * 32 + 32 * 16 + 16 * 8 + 8 * 2)   # one way, a row


def test_bench_t100_counts_by_hand():
    cfg, mix = small("bench_t100.train.t1024", time_len=256)
    terms = dict((k, v) for k, v, _ in bench_t100.step_terms(cfg, mix))
    t, n = 256, 2 * 2                                   # B Z
    assert terms == {"nets": 3 * 2 * t * 2 * NET,
                     "factor": 2 * n * t ** 3 / 3,
                     "kl_inverse": n * t ** 3 / 3,
                     "kl_trace": 2 * n * t ** 3 / 3,
                     "factor_reverse": n * t ** 3,
                     "kl_quad_and_sample": 6 * n * t * t}
    g = {x["name"]: x for x in bench_t100.kernel_groups(cfg, mix)}
    assert g["factor"]["launches"] == 2 + 2 + 1
    assert g["factor"]["flops"] == 8 * t ** 3 / 3
    assert g["factor"]["bytes"] == 8 * t * (t + 1) / 2 * 4
    assert g["factor"]["bound_s"] == max(g["factor"]["flops"] / FP32_FLOPS,
                                         g["factor"]["bytes"] / HBM_BYTES)
    assert g["tri_inv"]["launches"] == 2
    assert g["tri_inv"]["flops"] == (4 + 8) * (t // 64) * 64 ** 3 / 3
    assert g["diag_logdet"]["bound_s"] == (8 * t + 8) * 4 / HBM_BYTES


def test_t1024_toeplitz_counts_by_hand():
    cfg, mix = small("t1024_toeplitz.train.t8192", time_len=4097)
    terms = dict((k, v) for k, v, _ in t1024_toeplitz.step_terms(cfg, mix))
    t, z, m = 4097, 2, 16384
    assert terms["factor"] == z * t ** 3 / 3
    assert terms["factor_reverse"] == z * t ** 3
    assert terms["durbin"] == z * 2 * t * t
    assert terms["kl_fft"] == (6 * z * (t + 2) + 2 * z) * 2.5 * m * 14
    g = {x["name"]: x for x in t1024_toeplitz.kernel_groups(cfg, mix)}
    assert g["durbin"]["launches"] == 128 + 1
    assert g["factor"]["launches"] == 3 * 33 - 1
    assert g["tri_inv"]["launches"] == 1


def test_impute_counts_by_hand():
    cfg, mix = small("bench_t100.impute.t1024", time_len=1024, seqs_per_call=3)
    terms = dict((k, v) for k, v, _ in bench_t100.call_terms(cfg, mix))
    n, t = 6, 1024
    assert terms == {"nets": 3 * t * 2 * NET, "posterior_factor": n * t ** 3 / 3,
                     "posterior_mean": n * (2 * t * t + t * (2 * t - 1))}
    g = {x["name"]: x for x in bench_t100.kernel_groups(cfg, mix)}
    assert g["factor"]["kernels"].count("hist_panel") == 1
    assert g["factor"]["bytes"] == 2 * n * t * (t + 1) / 2 * 4
    cfg, mix = small("t1024_toeplitz.impute.t8192", seqs_per_call=1)
    names = [x["name"] for x in t1024_toeplitz.kernel_groups(cfg, mix)]
    assert names == ["factor"]                   # no tri_inv above T = 2048


def test_group_bound_is_the_larger_time():
    g = common.group("x", "k", 1, FP32_FLOPS, "fp32", 2 * HBM_BYTES)
    assert g["bound_s"] == 2.0
