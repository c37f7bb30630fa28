"""Plot artifacts: film strips, comparison grids, latent trajectories.

Counterpart of ``gpvae_tpu/utils/plotting.py``: the reference's 20-frame
film strips, dropped-vs-imputed comparison grids and latent-vs-time
plots (src/Models/FullGP_and_GPdecoder_dynamic_time_analysis.py:113-122,
236-291; src/Models/syndata/GP_VAE_syn_data.py:375-392).  Pure functions
of numpy arrays that write a PNG with headless matplotlib (Agg), which
is imported only when a plot is drawn.
"""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def film_strip(frames: np.ndarray, path: str, *, title: str | None = None):
    """One row of frames ``[T, H, W]`` (or ``[T, H, W, 1]``) -> PNG."""
    plt = _plt()
    frames = np.asarray(frames)
    if frames.ndim == 4:
        frames = frames[..., 0]
    t = frames.shape[0]
    fig, axes = plt.subplots(1, t, figsize=(t * 1.2, 1.4))
    if t == 1:
        axes = [axes]
    for i, ax in enumerate(axes):
        ax.imshow(frames[i], cmap="gray", vmin=0, vmax=1)
        ax.set_xticks([])
        ax.set_yticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def comparison_grid(rows: dict, path: str, *,
                    kept_mask: np.ndarray | None = None):
    """Stacked film strips (e.g. input / dropped / imputed), one row per
    entry; ``kept_mask [T]`` marks dropped frames with a red border (the
    reference's dropped-vs-not comparison grids with tick labels)."""
    plt = _plt()
    names = list(rows)
    t = np.asarray(rows[names[0]]).shape[0]
    fig, axes = plt.subplots(
        len(names), t, figsize=(t * 1.2, 1.4 * len(names))
    )
    axes = np.atleast_2d(axes)
    for r, name in enumerate(names):
        frames = np.asarray(rows[name])
        if frames.ndim == 4:
            frames = frames[..., 0]
        for c in range(t):
            ax = axes[r, c]
            ax.imshow(frames[c], cmap="gray", vmin=0, vmax=1)
            ax.set_xticks([])
            ax.set_yticks([])
            if c == 0:
                ax.set_ylabel(name, fontsize=8)
            if kept_mask is not None and not kept_mask[c]:
                for spine in ax.spines.values():
                    spine.set_edgecolor("red")
                    spine.set_linewidth(2)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def trajectory_plot(times: np.ndarray, values: np.ndarray, path: str, *,
                    mask: np.ndarray | None = None,
                    labels: list | None = None):
    """Latent trajectories over time ``values [T, Z]`` with optional
    observed-mask markers (the reference's latent-vs-time scatter)."""
    plt = _plt()
    times = np.asarray(times)
    values = np.asarray(values)
    fig, ax = plt.subplots(figsize=(8, 4))
    for d in range(values.shape[-1]):
        label = labels[d] if labels else f"z{d}"
        ax.plot(times, values[:, d], "-", label=label, alpha=0.8)
        if mask is not None:
            ax.plot(
                times[mask], values[mask, d], "o", markersize=4,
                color=ax.lines[-1].get_color(),
            )
    ax.set_xlabel("time")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
