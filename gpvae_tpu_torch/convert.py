"""Flax parameters of ``gpvae_tpu.models.GPVAE`` -> the port's state_dict.

Flax ``Dense`` stores ``kernel [in, out]``; ``nn.Linear`` stores ``weight
[out, in]``, so each kernel is transposed.  The names map as

    encoder_net/Dense_i/{kernel,bias}  -> encoder_net.dense.i.{weight,bias}
    encoder_net/mean_head/...          -> encoder_net.mean_head....
    decoder_net/Dense_i/...            -> decoder_net.dense.i....
    decoder_net/logits_head/...        -> decoder_net.logits_head....
    posterior_log_ls, prior_log_ls     -> unchanged

The parameters come in as nested dicts of numpy arrays (``jax.device_get``
of the flax tree); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_NETS = ("encoder_net", "decoder_net")
_HEADS = ("mean_head", "logits_head")
_LOG_LS = ("posterior_log_ls", "prior_log_ls")


def _layer_name(net: str, flax_name: str) -> str:
    if flax_name.startswith("Dense_"):
        return f"{net}.dense.{int(flax_name.removeprefix('Dense_'))}"
    if flax_name in _HEADS:
        return f"{net}.{flax_name}"
    raise KeyError(f"unknown flax layer {net}/{flax_name}")


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
                out[f"{name}.weight"] = torch.from_numpy(
                    np.array(leaves["kernel"]).T.copy()
                )
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
