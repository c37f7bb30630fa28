"""Cyclic shuffling batcher over fixed-shape array dicts.

Counterpart of ``gpvae_tpu/data/batching.py`` with the same index stream
for the same seed: batches of ``batch_size`` rows in a shuffled order,
reshuffled whenever a batch would run past the end.  Batches are gathered
with numpy; the training loop reads :meth:`Batcher.next_indices` and
gathers on the device instead.
"""
from __future__ import annotations

import numpy as np


class Batcher:
    """Cycles over ``arrays`` (dict of same-leading-dim numpy arrays) in
    batches of ``batch_size``, reshuffling whenever a batch would run past
    the end (the reference's wrap semantics)."""

    def __init__(self, arrays: dict, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        sizes = {k: v.shape[0] for k, v in self.arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"inconsistent leading dims: {sizes}")
        self.n = next(iter(sizes.values()))
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.n)
        self._pos = 0
        if shuffle:
            self._rng.shuffle(self._order)

    def __iter__(self):
        return self

    def next_indices(self) -> np.ndarray:
        """The next batch's row indices.  A copy: a later reshuffle must
        not change indices already handed out."""
        if self._pos + self.batch_size > self.n:
            if self.shuffle:
                self._rng.shuffle(self._order)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx.copy()

    def __next__(self) -> dict:
        idx = self.next_indices()
        return {k: v[idx] for k, v in self.arrays.items()}

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size
