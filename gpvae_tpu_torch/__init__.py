"""gpvae_tpu_torch: the GP-VAE in PyTorch, with hand-written CUDA kernels
for an NVIDIA Hopper GPU (H100, ``sm_90a``).

The port of ``gpvae_tpu`` (JAX/Pallas on a TPU), module for module.  Its
first slice carries the ``syn_data`` training step: dense nets, a GP
posterior against a GP prior on irregular masked time grids, and two
kernels in ``csrc/`` that the ops build with ``nvcc`` on first use:

* ``gram_chol.cu`` -- the masked gram bank and its Cholesky in one pass;
* ``tri_inv.cu``   -- the batched lower-triangular inverse.

A CUDA tensor goes through a kernel; a CPU tensor through the plain
PyTorch version of the same function.  This package never imports JAX.
"""
from gpvae_tpu_torch import elbo, gp, kernels, ops

__all__ = ["elbo", "gp", "kernels", "ops"]
