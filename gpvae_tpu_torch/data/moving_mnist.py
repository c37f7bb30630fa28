"""Moving-MNIST pipeline.

Counterpart of ``gpvae_tpu/data/moving_mnist.py``, after the reference
``DataHandler`` (src/Models/DataHandler.py:4-95): videos ``(T, N, H, W)``
scaled to [0, 1] (``/255`` for the ``uint8`` ``mnist_test_seq.npy``),
binarized at ``>= 0.498`` in float32 (the numpy rule of
``gpvae_tpu/data/native.py:110-114``; the JAX package's C++ runtime
computes the same), split 80/10/10 into ``train``/``valid``/``test``,
each sequence on the uniform grid ``0 .. T-1`` with a full mask.

Batches follow the package's static-shape convention: ``x [B, T, H, W,
1]`` float32, ``times [B, T]`` float32, ``mask [B, T]`` bool, through
:class:`gpvae_tpu_torch.data.Batcher`.  :func:`synthetic_moving_mnist`
makes bouncing-sprite videos of the same layout from a seed, since the
1 GB ``mnist_test_seq.npy`` is not distributed.
"""
from __future__ import annotations

import numpy as np

from gpvae_tpu_torch.data.batching import Batcher

BINARIZE_THRESHOLD = 0.498  # src/Models/DataHandler.py:68-70


def synthetic_moving_mnist(
    num_seqs: int,
    *,
    t: int = 20,
    size: int = 64,
    sprite: int = 12,
    seed: int = 0,
) -> np.ndarray:
    """Bouncing-square videos ``[T, N, size, size]`` in [0, 1] -- the same
    layout as the reference's ``mnist_test_seq.npy`` after /255
    (``gpvae_tpu/data/moving_mnist.py:25-54``, draw for draw)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((t, num_seqs, size, size), np.float32)
    pos = rng.uniform(0, size - sprite, (num_seqs, 2))
    vel = rng.uniform(-4, 4, (num_seqs, 2))
    patch = np.ones((sprite, sprite), np.float32)
    patch[1:-1, 1:-1] = rng.uniform(0.6, 1.0, (sprite - 2, sprite - 2))
    for step in range(t):
        for i in range(num_seqs):
            r, c = int(pos[i, 0]), int(pos[i, 1])
            out[step, i, r:r + sprite, c:c + sprite] = patch
        pos += vel
        for d in range(2):
            over = pos[:, d] > size - sprite
            under = pos[:, d] < 0
            vel[over | under, d] *= -1
            pos[over, d] = 2 * (size - sprite) - pos[over, d]
            pos[under, d] = -pos[under, d]
    return out


def binarize_frames(frames: np.ndarray,
                    threshold: float = BINARIZE_THRESHOLD) -> np.ndarray:
    """``1.0`` where a frame's value in [0, 1] (``uint8`` divided by 255)
    is at least ``threshold``, else ``0.0``; float32."""
    as_float = (frames.astype(np.float32) / np.float32(255.0)
                if frames.dtype == np.uint8 else frames.astype(np.float32))
    return (as_float >= np.float32(threshold)).astype(np.float32)


class MovingMNIST:
    """Train/valid/test splits and batchers over Moving-MNIST videos: the
    ``.npy`` at ``path`` (``(T, N, H, W)`` uint8) or ``data`` (the same
    layout, in [0, 1]).  ``splits[name]`` holds each split's arrays;
    ``batchers[name]`` a :class:`Batcher` over each split with at least
    ``batch_size`` sequences, shuffled for ``train`` only."""

    def __init__(
        self,
        path: str | None = None,
        *,
        data: np.ndarray | None = None,
        batch_size: int = 5,
        train_fraction: float = 0.8,
        binarize: bool = True,
        seed: int = 0,
    ):
        if data is None:
            if path is None:
                raise ValueError("need path or data")
            data = np.load(path)  # (T, N, 64, 64) uint8
            if binarize:
                data = binarize_frames(data)
                binarize = False
            else:
                data = data.astype(np.float32) / np.float32(255.0)
        data = np.asarray(data, np.float32)
        if binarize:
            data = binarize_frames(data)
        t, n = data.shape[:2]
        self.t = t
        x = np.moveaxis(data, 0, 1)[..., None]  # [N, T, H, W, 1]
        times = np.broadcast_to(np.arange(t, dtype=np.float32), (n, t)).copy()
        mask = np.ones((n, t), bool)
        n_train = int(train_fraction * n)
        n_valid = (n - n_train) // 2
        bounds = {"train": (0, n_train),
                  "valid": (n_train, n_train + n_valid),
                  "test": (n_train + n_valid, n)}
        self.splits, self.batchers = {}, {}
        for name, (lo, hi) in bounds.items():
            arrays = {"x": x[lo:hi], "times": times[lo:hi],
                      "mask": mask[lo:hi]}
            self.splits[name] = arrays
            if hi - lo >= batch_size:
                self.batchers[name] = Batcher(arrays, batch_size, seed=seed,
                                              shuffle=(name == "train"))

    def data_batch(self, name: str) -> dict:
        return next(self.batchers[name])

    def make_shuffled_dataset(self, seed: int = 0) -> None:
        """``mixed_train``: the training frames shuffled across time and
        sequence, the reference's control that destroys temporal
        structure (src/Models/DataHandler.py:53-57)."""
        src = self.splits["train"]
        x = src["x"]
        n, t = x.shape[:2]
        flat = x.reshape((n * t,) + x.shape[2:]).copy()
        np.random.default_rng(seed).shuffle(flat)
        arrays = {"x": flat.reshape(x.shape), "times": src["times"],
                  "mask": src["mask"]}
        self.splits["mixed_train"] = arrays
        self.batchers["mixed_train"] = Batcher(
            arrays, self.batchers["train"].batch_size, seed=seed)

    def make_cropped_dataset(self, y0: int = 18, x0: int = 18,
                             size: int = 28) -> None:
        """``cropped_train``: a ``size`` x ``size`` crop of the training
        frames at (``y0``, ``x0``) (src/Models/DataHandler.py:59-61)."""
        src = self.splits["train"]
        arrays = {"x": src["x"][:, :, y0:y0 + size, x0:x0 + size, :],
                  "times": src["times"], "mask": src["mask"]}
        self.splits["cropped_train"] = arrays
        self.batchers["cropped_train"] = Batcher(
            arrays, self.batchers["train"].batch_size)
