"""Numerical guards.

Counterpart of ``gpvae_tpu/utils/debug.py``:

* :func:`enable_nan_debugging` -- autograd's anomaly mode, so the
  backward op that first makes a NaN raises with the forward op's
  traceback;
* :func:`check_finite` / :func:`assert_finite` -- finiteness over every
  floating leaf of a dict, list or module state, as a device flag that
  is never read (check) or with a read of the device that raises
  (assert).
"""
from __future__ import annotations

import numpy as np
import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """``torch.autograd.set_detect_anomaly(enable)``: a backward op that
    returns NaN raises, naming the forward op that built it.  Unlike the
    JAX package's ``jax_debug_nans``, which stops at the first NaN of any
    jitted op, this catches a NaN in the backward only: a NaN made in the
    forward raises where its gradient first turns NaN."""
    torch.autograd.set_detect_anomaly(enable)


def leaves_with_path(tree, path: str = ""):
    """``(path, leaf)`` pairs of a dict, list, tuple or ``nn.Module`` (its
    ``state_dict``), in the JAX package's order (a dict's keys sorted)
    and each path written as ``jax.tree_util.keystr`` writes it
    (``['key'][0]``)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from leaves_with_path(value, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _floating(leaf) -> torch.Tensor | None:
    """``leaf`` as a tensor where it holds floating values, else None."""
    if isinstance(leaf, (np.ndarray, np.generic, float)):
        leaf = torch.as_tensor(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
        return leaf
    return None


def check_finite(tree, name: str = "tree") -> torch.Tensor:
    """A 0-d bool tensor: every floating leaf of ``tree`` finite.  It is
    computed on the leaves' device and never read there, so a training
    loop can keep it without a sync.  The JAX package's version also
    prints a warning from inside its compiled program when it is false;
    here the caller reads the flag where it reads the device anyway
    (``name`` is kept for the JAX package's signature)."""
    finite = None
    for _, leaf in leaves_with_path(tree):
        t = _floating(leaf)
        if t is None:
            continue
        ok = torch.isfinite(t).all()
        finite = ok if finite is None else finite & ok.to(finite.device)
    return torch.tensor(True) if finite is None else finite


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``tree`` that holds a NaN or an infinity (``name`` and the leaf's
    path).  Reads the device for each leaf: keep it out of hot loops."""
    for path, leaf in leaves_with_path(tree):
        t = _floating(leaf)
        if t is not None and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")
