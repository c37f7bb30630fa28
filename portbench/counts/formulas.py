"""Counting formulas, each with where it comes from.  A flop is one
floating-point addition or multiplication."""
from __future__ import annotations

import math


def cholesky(n: int) -> float:
    """The Cholesky factorization of an n x n SPD matrix: n^3/3 flops
    (Golub and Van Loan, Matrix Computations, sec. 4.2)."""
    return n ** 3 / 3


def tri_inverse(n: int) -> float:
    """The inverse of an n x n triangular matrix: n^3/3 flops (Golub and
    Van Loan, sec. 3.1; Higham, Accuracy and Stability, sec. 14.2)."""
    return n ** 3 / 3


def tri_tri_product(n: int) -> float:
    """The product of two n x n lower-triangular matrices: n^3/3 flops
    (entry (i, j) of the lower result sums i - j + 1 products)."""
    return n ** 3 / 3


def cholesky_reverse(n: int) -> float:
    """The reverse mode of the Cholesky factorization, ``K_bar = L^-T
    Phi(L^T L_bar) L^-1``: three triangular-structured n x n products of
    n^3/3 flops each, n^3 (Murray, Differentiation of the Cholesky
    decomposition, arXiv:1602.07527, 2016)."""
    return n ** 3


def matmul(m: int, n: int, k: int) -> float:
    """An (m x k) by (k x n) product: m n k multiplications and m n (k - 1)
    additions."""
    return float(m) * n * (2 * k - 1)


def tri_matvec(n: int) -> float:
    """A triangular n x n matrix times a vector: n^2 flops."""
    return float(n) * n


def rfft(m: int) -> float:
    """A real FFT (or its inverse) of length m, a power of two: half of a
    complex radix-2 FFT's 5 m log2 m flops (Van Loan, Computational
    Frameworks for the FFT, 1992, sec. 1.4)."""
    return 2.5 * m * math.log2(m)


def durbin(t: int) -> float:
    """Durbin's recursion for a Toeplitz system of order t: 2 t^2 flops
    (Golub and Van Loan, Matrix Computations, sec. 4.7)."""
    return 2.0 * t * t


def dense_net(widths: list[int]) -> float:
    """One row through the dense layers of ``widths``: the product and the
    bias, 2 in x out flops a layer (the ReLUs left out)."""
    return sum(2.0 * a * b for a, b in zip(widths[:-1], widths[1:]))


def blocks(t: int, width: int = 128) -> int:
    """Column blocks of the port's blocked factorization at side t."""
    return -(-t // width)


def fft_len(t: int) -> int:
    """The power-of-two length >= 2t - 1 of a linear Toeplitz product."""
    return 1 << (2 * t - 2).bit_length()
