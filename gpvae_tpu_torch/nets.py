"""Encoder/decoder networks.

Counterpart of ``gpvae_tpu/nets.py``: the reference's ReLU MLPs 15 -> 32
-> 32 -> 16 -> 8 -> Z and back (:47-93), and its strided conv encoder
and transposed-conv decoder over ``[N, H, W, C]`` frames (:96-173), with
the optional log-variance head of the diagonal and recognition
posteriors.  Weights are truncated-normal(0.1) (cut at two standard
deviations, as flax's initializer is) and biases 0.1, drawn from the
module's ``generator``.  Decoders return Bernoulli logits.

The nets take and return NHWC frames, as the JAX package does, and run
their convs in NCHW inside.  The convs match flax's ``"SAME"`` padding:

* ``Conv`` at stride 2 pads (0, 1) on an even side and (1, 1) on an odd
  one, so the input is padded explicitly before a conv with no padding;
* ``ConvTranspose`` is a correlation of the stride-dilated input with the
  kernel as stored, where ``conv_transpose2d`` correlates with the kernel
  flipped: :mod:`gpvae_tpu_torch.convert` stores each flax kernel flipped
  (``[in, out, kh, kw]``), and the forward keeps the rows and columns of
  the full transposed conv that flax's padding keeps.

A float32 matmul or conv runs in full float32 while
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are False; importing the package sets
the second, which PyTorch leaves on (``gpvae_tpu_torch/__init__.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Reference dense hidden schedule (src/Models/syndata/GP_VAE_syn_data.py:15-39)
DENSE_HIDDEN = (32, 32, 16, 8)
# Reference conv channel schedule (src/Models/Full_GP_VAE_dynamic_time.py:27-58)
CONV_FEATURES = (16, 32, 64, 128, 256, 512)
KERNEL = 3
W_STD = 0.1
B_INIT = 0.1


def _init(layer: nn.Module, generator: torch.Generator | None) -> nn.Module:
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=W_STD, a=-2 * W_STD,
                              b=2 * W_STD, generator=generator)
        layer.bias.fill_(B_INIT)
    return layer


def _linear(n_in: int, n_out: int, generator: torch.Generator | None):
    return _init(nn.Linear(n_in, n_out), generator)


def _mlp(widths: Sequence[int], generator) -> nn.ModuleList:
    return nn.ModuleList(
        _linear(a, b, generator) for a, b in zip(widths[:-1], widths[1:])
    )


def _same_pads(n: int, stride: int) -> tuple[int, int]:
    """flax's ``"SAME"`` padding (low, high) of a side ``n`` for a conv of
    ``KERNEL`` at ``stride``: ``ceil(n / stride)`` outputs, the odd pixel
    of padding at the high end."""
    total = max((-(-n // stride) - 1) * stride + KERNEL - n, 0)
    return total // 2, total - total // 2


def _transpose_offset(stride: int) -> int:
    """Where flax's ``"SAME"`` transposed conv starts inside the full one
    (``jax.lax``'s ``_conv_transpose_padding``: it pads the dilated input
    ``ceil((KERNEL + stride - 2) / 2)`` low, or ``KERNEL - 1`` when stride
    > KERNEL - 1, where the full one pads ``KERNEL - 1``)."""
    pad_a = (KERNEL - 1 if stride > KERNEL - 1
             else -(-(KERNEL + stride - 2) // 2))
    return KERNEL - 1 - pad_a


class DenseEncoder(nn.Module):
    """15 -> 32 -> 32 -> 16 -> 8 -> Z ReLU MLP with a linear mean head,
    and a log-variance head with ``with_log_var``.  Modules ``dense.0..3``,
    ``mean_head`` and ``log_var_head`` are flax's ``Dense_0..3``,
    ``mean_head`` and ``log_var_head`` (see :mod:`gpvae_tpu_torch.convert`)."""

    def __init__(self, in_dim: int, latent_dim: int,
                 hidden: Sequence[int] = DENSE_HIDDEN, *,
                 with_log_var: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = _mlp((in_dim, *hidden), generator)
        self.mean_head = _linear(hidden[-1], latent_dim, generator)
        self.log_var_head = (_linear(hidden[-1], latent_dim, generator)
                             if with_log_var else None)

    def forward(self, x: torch.Tensor):
        """``[N, in_dim]`` -> mean ``[N, Z]``, or ``(mean, log_var)``."""
        h = x
        for layer in self.dense:
            h = torch.relu(layer(h))
        if self.log_var_head is None:
            return self.mean_head(h)
        return self.mean_head(h), self.log_var_head(h)


class DenseDecoder(nn.Module):
    """Z -> 8 -> 16 -> 32 -> 32 -> obs_dim, returning Bernoulli logits.
    Modules ``dense.0..3`` and ``logits_head``."""

    def __init__(self, latent_dim: int, obs_dim: int,
                 hidden: Sequence[int] = tuple(reversed(DENSE_HIDDEN)), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = _mlp((latent_dim, *hidden), generator)
        self.logits_head = _linear(hidden[-1], obs_dim, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.dense:
            h = torch.relu(layer(h))
        return self.logits_head(h)


class ConvEncoder(nn.Module):
    """``[N, H, W, C]`` frames -> six stride-2 3x3 ReLU convs (16 ... 512
    channels) -> flatten (in NHWC order) -> mean ``[N, Z]``, and a
    log-variance head with ``with_log_var`` (``nets.py:96-125``).
    Modules ``conv.0..5`` are flax's ``Conv_0..5``."""

    def __init__(self, image_shape: tuple[int, int, int], latent_dim: int,
                 features: Sequence[int] = CONV_FEATURES, *,
                 with_log_var: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w, c = image_shape
        self.conv = nn.ModuleList()
        for feat in features:
            self.conv.append(_init(nn.Conv2d(c, feat, KERNEL, stride=2),
                                   generator))
            h, w, c = -(-h // 2), -(-w // 2), feat
        flat = h * w * c
        self.mean_head = _linear(flat, latent_dim, generator)
        self.log_var_head = (_linear(flat, latent_dim, generator)
                             if with_log_var else None)

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2)
        for conv in self.conv:
            ph, pw = (_same_pads(n, 2) for n in h.shape[-2:])
            h = torch.relu(conv(F.pad(h, (*pw, *ph))))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        if self.log_var_head is None:
            return self.mean_head(h)
        return self.mean_head(h), self.log_var_head(h)


class ConvDecoder(nn.Module):
    """Z -> dense -> a seed x seed map -> stride-2 3x3 ReLU transposed
    convs -> ``[N, H, W, C]`` logits (``nets.py:128-173``).  The image's
    2-adic depth k (at most six) sets the number of doublings: at 64 x 64
    a 1 x 1 x 512 seed and six doublings, the last of them the logits head
    (the reference's architecture); at 28 x 28 a 7 x 7 x 64 seed, two
    doublings and a stride-1 logits head.  Modules ``dense.0`` (flax's
    ``Dense_0``), ``deconv.i`` (``ConvTranspose_i``) and ``logits_head``."""

    def __init__(self, image_shape: tuple[int, int, int], latent_dim: int,
                 features: Sequence[int] = tuple(reversed(CONV_FEATURES)), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        n_feat = len(features)
        k, seed = 0, image_shape[0]
        while seed % 2 == 0 and k < n_feat:
            seed //= 2
            k += 1
        self.seed = seed
        full = k == n_feat
        c0 = features[0] if full else features[n_feat - k - 1]
        self.dense = nn.ModuleList([_linear(latent_dim, seed * seed * c0,
                                            generator)])
        feats = features[n_feat - k:]
        if full:
            feats = feats[1:]
        self.deconv = nn.ModuleList()
        c = c0
        for feat in feats:
            self.deconv.append(_init(
                nn.ConvTranspose2d(c, feat, KERNEL, stride=2), generator))
            c = feat
        self.logits_stride = 2 if full else 1
        self.logits_head = _init(
            nn.ConvTranspose2d(c, image_shape[-1], KERNEL,
                               stride=self.logits_stride), generator)

    @staticmethod
    def _transposed(layer: nn.ConvTranspose2d, h: torch.Tensor,
                    stride: int) -> torch.Tensor:
        """flax's ``"SAME"`` transposed conv: ``stride`` times the input's
        side, cut out of the full one."""
        n_h, n_w = h.shape[-2:]
        off = _transpose_offset(stride)
        y = F.conv_transpose2d(h, layer.weight, layer.bias, stride=stride)
        return y[..., off:off + stride * n_h, off:off + stride * n_w]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense[0](z))
        # the seed is laid out NHWC, as flax reshapes it
        h = h.reshape(h.shape[0], self.seed, self.seed, -1).permute(0, 3, 1, 2)
        for layer in self.deconv:
            h = torch.relu(self._transposed(layer, h, 2))
        h = self._transposed(self.logits_head, h, self.logits_stride)
        return h.permute(0, 2, 3, 1)
