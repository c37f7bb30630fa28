"""Data layer of the port: the numpy toy generator and its file loader,
the Moving-MNIST pipeline, the healing-MNIST missing-pixel sequences and
the batcher."""
from gpvae_tpu_torch.data.batching import Batcher
from gpvae_tpu_torch.data.healing import (
    make_healing_batch,
    random_pixel_mask,
    synthetic_healing_sequences,
)
from gpvae_tpu_torch.data.moving_mnist import (
    MovingMNIST,
    synthetic_moving_mnist,
)
from gpvae_tpu_torch.data.synthetic import (
    TOY_TIME_GRID,
    generate_toy_data,
    load_toy_file,
    toy_to_masked_batch,
)

__all__ = ["Batcher", "MovingMNIST", "TOY_TIME_GRID", "generate_toy_data",
           "load_toy_file", "make_healing_batch", "random_pixel_mask",
           "synthetic_healing_sequences", "synthetic_moving_mnist",
           "toy_to_masked_batch"]
