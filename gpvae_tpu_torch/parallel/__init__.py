"""Data parallelism over ``torch.distributed`` (:mod:`.mesh`)."""
from gpvae_tpu_torch.parallel.mesh import (
    fit_data_parallel,
    make_mesh,
    make_parallel_multi_step,
    make_parallel_train_step,
    replicate,
    shard_batch,
    shard_batch_stack,
)

__all__ = [
    "fit_data_parallel",
    "make_mesh",
    "shard_batch",
    "shard_batch_stack",
    "replicate",
    "make_parallel_train_step",
    "make_parallel_multi_step",
]
