"""Flax parameters of ``gpvae_tpu.models.GPVAE`` -> the port's state_dict.

The names map as

    <net>/Dense_i/{kernel,bias}       -> <net>.dense.i.{weight,bias}
    encoder_net/Conv_i/...            -> encoder_net.conv.i....
    decoder_net/ConvTranspose_i/...   -> decoder_net.deconv.i....
    <net>/{mean,log_var,logits}_head  -> <net>.{mean,log_var,logits}_head
    posterior_log_ls, prior_log_ls    -> unchanged (a GP or FITC prior's)

and each kernel is laid out as the torch layer holds it:

* a flax ``Dense`` kernel ``[in, out]`` is transposed to ``nn.Linear``'s
  ``[out, in]``;
* a flax ``Conv`` kernel ``[kh, kw, in, out]`` becomes ``nn.Conv2d``'s
  ``[out, in, kh, kw]`` (both correlate);
* a flax ``ConvTranspose`` kernel ``[kh, kw, in, out]`` becomes
  ``[in, out, kh, kw]`` flipped in both spatial dims: flax correlates the
  dilated input with the kernel as stored, ``conv_transpose2d`` with it
  flipped.

``logits_head`` is a ``ConvTranspose`` in the conv decoder and a ``Dense``
in the dense one: the kernel's rank tells them apart.  The maps are
linear, so the same function converts a gradient tree.  The parameters
come in as nested dicts of numpy arrays (``jax.device_get`` of the flax
tree); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_NETS = ("encoder_net", "decoder_net")
_HEADS = ("mean_head", "log_var_head", "logits_head")
_LOG_LS = ("posterior_log_ls", "prior_log_ls")
_INDEXED = {"Dense_": "dense", "Conv_": "conv", "ConvTranspose_": "deconv"}


def _layer_name(net: str, flax_name: str) -> str:
    if flax_name in _HEADS:
        return f"{net}.{flax_name}"
    prefix, _, index = flax_name.rpartition("_")
    if prefix + "_" in _INDEXED and index.isdigit():
        return f"{net}.{_INDEXED[prefix + '_']}.{int(index)}"
    raise KeyError(f"unknown flax layer {net}/{flax_name}")


def _weight(flax_name: str, kernel: np.ndarray) -> np.ndarray:
    """A flax kernel in the layout of the torch layer it maps to."""
    if kernel.ndim == 2:                               # Dense
        return kernel.T
    if flax_name.startswith("Conv_"):                  # Conv
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 4:                               # ConvTranspose
        return kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    raise KeyError(f"flax layer {flax_name} has a kernel of rank "
                   f"{kernel.ndim}")


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Convert a flax ``params`` tree (with or without the outer
    ``{"params": ...}`` level) into state_dict entries."""
    if set(params) == {"params"}:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key in _LOG_LS:
            out[key] = torch.from_numpy(np.array(value))
        elif key in _NETS:
            for layer, leaves in value.items():
                name = _layer_name(key, layer)
                out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                    _weight(layer, np.asarray(leaves["kernel"]))))
                out[f"{name}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
        else:
            raise KeyError(f"unknown flax parameter {key!r}")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load flax ``params`` into ``model`` in place.  Raises unless every
    parameter of the model is covered; buffers (a fixed prior's
    log-lengthscales, held as a constant by flax) keep their values."""
    state = flax_to_state_dict(params)
    ref = model.state_dict()
    for name, tensor in state.items():
        if name in ref:
            state[name] = tensor.to(ref[name].dtype)
    result = model.load_state_dict(state, strict=False)
    buffers = {name for name, _ in model.named_buffers()}
    missing = set(result.missing_keys) - buffers
    if missing or result.unexpected_keys:
        raise KeyError(
            f"flax params do not match the model: missing {sorted(missing)},"
            f" unexpected {sorted(result.unexpected_keys)}"
        )
