"""Healing-MNIST-style data: short image sequences with missing pixels.

Counterpart of ``gpvae_tpu/data/healing.py:20-100`` (BASELINE config 2,
missing-pixel imputation with the Cauchy kernel on short sequences), in
numpy and driven by ``np.random.default_rng(seed)`` as there, so the same
seed gives bit for bit the same arrays.  Since the MNIST digits file is
not distributed, :func:`synthetic_healing_sequences` makes rotating-sprite
sequences of the same contract (binary ``[N, T, 28, 28, 1]`` videos whose
frames are rigid rotations of a per-sequence pattern), and
:func:`random_pixel_mask` the iid missing-pixel masks; the model sees the
zero-filled corrupted frames and the per-pixel ``feature_mask``.
"""
from __future__ import annotations

import numpy as np


def synthetic_healing_sequences(
    num_seqs: int,
    *,
    t: int = 10,
    size: int = 28,
    seed: int = 0,
) -> np.ndarray:
    """Binary sequences ``[N, T, size, size, 1]``: a few gaussian blobs
    rotating about the frame's center at a per-sequence angular velocity
    (the healing-MNIST recipe of rotating a digit frame by frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    cy = cx = (size - 1) / 2.0
    out = np.zeros((num_seqs, t, size, size), np.float32)
    for i in range(num_seqs):
        n_blobs = rng.integers(2, 5)
        centers = rng.uniform(size * 0.25, size * 0.75, (n_blobs, 2))
        widths = rng.uniform(2.0, 4.0, n_blobs)
        omega = rng.uniform(-0.35, 0.35)  # radians a frame
        for step in range(t):
            ang = -omega * step
            ca, sa = np.cos(ang), np.sin(ang)
            # the sampling coordinates rotated about the center
            ry = cy + (yy - cy) * ca - (xx - cx) * sa
            rx = cx + (yy - cy) * sa + (xx - cx) * ca
            frame = np.zeros((size, size))
            for (by, bx), w in zip(centers, widths):
                frame += np.exp(
                    -((ry - by) ** 2 + (rx - bx) ** 2) / (2 * w * w)
                )
            out[i, step] = (frame > 0.5).astype(np.float32)
    return out[..., None]


def random_pixel_mask(
    shape: tuple,
    missing_fraction: float,
    *,
    seed: int = 0,
) -> np.ndarray:
    """The iid observed-pixel mask (True = observed) with the given
    missing fraction: the healing-MNIST corruption."""
    rng = np.random.default_rng(seed)
    return rng.random(shape) >= missing_fraction


def make_healing_batch(
    num_seqs: int,
    *,
    t: int = 10,
    size: int = 28,
    missing_fraction: float = 0.5,
    seed: int = 0,
) -> dict:
    """A healing batch: ``x_clean``, the zero-filled corrupted input ``x``,
    the per-pixel ``feature_mask``, uniform ``times 0 .. T-1`` and an
    all-true step ``mask``.  The encoder sees ``x``, the NLL counts only
    observed pixels (``feature_mask``), and imputation is scored on the
    missing ones against ``x_clean`` (``analysis.pixel_imputation_metrics``).
    """
    x_clean = synthetic_healing_sequences(
        num_seqs, t=t, size=size, seed=seed
    )
    feature_mask = random_pixel_mask(
        x_clean.shape, missing_fraction, seed=seed + 1
    )
    x_corrupt = (x_clean * feature_mask).astype(np.float32)
    times = np.broadcast_to(
        np.arange(t, dtype=np.float32), (num_seqs, t)
    ).copy()
    mask = np.ones((num_seqs, t), bool)
    return {
        "x": x_corrupt,
        "x_clean": x_clean,
        "feature_mask": feature_mask,
        "times": times,
        "mask": mask,
    }
