"""Linear-algebra ops of the covariance path, each with its CUDA kernel.

* :mod:`.gram_chol` -- ``gram_chol_fused``: gram bank + Cholesky in one
  kernel, T <= 64 (``csrc/gram_chol.cu``),
* :mod:`.chol_block` -- the factor (and inverse) of SPD blocks of side
  <= 128, pre-built or built from the time vectors (``csrc/chol_block.cu``),
* :mod:`.blocked` -- the blocked large-T factorizations
  (``csrc/gram_panel.cu``, ``csrc/panel_solve.cu`` and ``chol_block``):
  ``cholesky_gram_inplace`` with in-kernel gram tiles,
  ``cholesky_inplace`` of a pre-built bank, and the right-looking
  ``cholesky_blocked_fused`` over :mod:`.trail`,
* :mod:`.trail` -- one right-looking step: the panel times the diagonal
  block's inverse and the trailing downdate (``csrc/gram_panel.cu``),
* :mod:`.tri_inv` -- ``tri_inv``: batched lower-triangular inverse
  (``csrc/tri_inv.cu`` at the base, matmul merges above), differentiable,
* :mod:`.chol` -- ``cholesky``: the differentiable Cholesky of a
  pre-built matrix, with the JAX package's method menu, and
  ``cholesky_bwd_from_l``, its reverse mode on the inverse route (with a
  logdet's cotangent folded onto the diagonal of its middle factor),
* :mod:`.chol_bwd` -- that reverse mode's products on the card: three
  passes that skip the triangles' zero tiles (``csrc/chol_bwd.cu``),
* :mod:`.trsm` -- ``solve_triangular``: through ``tri_inv`` on CUDA,
* :mod:`.logdet` -- ``logdet_from_chol``: logdet from the factor's
  diagonal (``csrc/diag_logdet.cu`` for large factors); ``diag_logdet``,
  the same without autograd (the training step's one launch over its
  stacked bank); ``chol_logdet``, ``slogdet_psd``,
* :mod:`.durbin` -- the Durbin recursion of Toeplitz matrices in float64,
  one block a matrix (``csrc/durbin.cu``), under ``toeplitz.py``'s logdet
  and Gohberg-Semencul inverse.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (:mod:`.dispatch`).  The submodules keep their names
here: ``ops.tri_inv`` is the module, whose ``LAUNCHES`` counter a run
reads.
"""
from gpvae_tpu_torch.ops import (
    blocked, chol, chol_block, chol_bwd, dispatch, durbin, gram_chol, logdet,
    trail, tri_inv, trsm,
)

__all__ = ["blocked", "chol", "chol_block", "chol_bwd", "dispatch", "durbin",
           "gram_chol", "logdet", "trail", "tri_inv", "trsm"]
