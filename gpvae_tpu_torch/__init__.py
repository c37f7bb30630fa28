"""gpvae_tpu_torch: the GP-VAE in PyTorch, with hand-written CUDA kernels
for an NVIDIA Hopper GPU (H100, ``sm_90a``).

The port of ``gpvae_tpu`` (JAX/Pallas on a TPU), module for module.  It
carries the model zoo (GP, standard priors x GP, diagonal and
recognition posteriors x dense and conv nets, on toy data and
Moving-MNIST videos), the large-T dense covariance path of
``bench_t100`` and GP-posterior imputation, on six sources in ``csrc/``
that the ops build with ``nvcc`` on first use:

* ``gram_chol.cu``   -- the masked gram bank and its Cholesky, T <= 64;
* ``tri_inv.cu``     -- the batched lower-triangular inverse, side <= 64;
* ``chol_block.cu``  -- Cholesky (and inverse) of SPD blocks <= 128;
* ``gram_panel.cu``  -- the blocked factorization's panel, with in-kernel
  gram tiles or from a pre-built bank, and the right-looking step;
* ``panel_solve.cu`` -- the solve of the column below each diagonal block;
* ``diag_logdet.cu`` -- ``2 sum log diag L`` of large factors.

All but ``gram_panel.cu`` and ``diag_logdet.cu`` share ``chol_tile.cuh``:
a panel-blocked Cholesky and inverse inside one thread block.

A CUDA tensor goes through a kernel; a CPU tensor through the plain
PyTorch version of the same function.  This package never imports JAX.

Every computation runs in full float32 (or the caller's float64).
PyTorch keeps TF32 off for matmuls but leaves it on for cuDNN's convs, so
importing the package turns it off there too: a conv net's ELBO is then
the float32 one its checks against float64 hold it to.
"""
import torch

torch.backends.cudnn.allow_tf32 = False

from gpvae_tpu_torch import elbo, gp, kernels, ops  # noqa: E402

__all__ = ["elbo", "gp", "kernels", "ops"]
