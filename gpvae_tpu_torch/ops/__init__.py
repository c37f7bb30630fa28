"""Linear-algebra ops of the covariance path, each with its CUDA kernel.

* :mod:`.gram_chol` -- ``gram_chol_fused``: gram bank + Cholesky in one
  kernel (``csrc/gram_chol.cu``),
* :mod:`.tri_inv` -- ``tri_inv``: batched lower-triangular inverse
  (``csrc/tri_inv.cu``), differentiable,
* :mod:`.chol` -- ``cholesky_bwd_from_l``: Cholesky reverse mode on the
  inverse route,
* :mod:`.logdet` -- ``logdet_from_chol``: logdet from the factor's
  diagonal.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (:mod:`.dispatch`).  The submodules keep their names
here: ``ops.tri_inv`` is the module, whose ``LAUNCHES`` counter a run
reads.
"""
from gpvae_tpu_torch.ops import chol, dispatch, gram_chol, logdet, tri_inv

__all__ = ["chol", "dispatch", "gram_chol", "logdet", "tri_inv"]
