"""Data layer of the port: the numpy toy generator and the batcher."""
from gpvae_tpu_torch.data.batching import Batcher
from gpvae_tpu_torch.data.synthetic import (
    TOY_TIME_GRID,
    generate_toy_data,
    toy_to_masked_batch,
)

__all__ = ["Batcher", "TOY_TIME_GRID", "generate_toy_data",
           "toy_to_masked_batch"]
