"""Map-crop CNN encoder.

Port of ``strive_tpu/model/cnn.py`` (reference ``models/traffic_model.py:62-87``):
(Conv2d VALID, GroupNorm(1 group, eps 1e-5), ReLU) x k, flatten, Linear.
The space-to-depth rewrite of the JAX package is a TPU layout trick and is
off there by default (``cnn.py:99``); it is not ported.

The crop arrives as an NCHW-shaped tensor in ``channels_last`` memory (the
crop kernel writes NHWC), so cuDNN reads it without a copy. The final
activation is flattened in NHWC order, as the Flax model does, so the
Linear's rows keep the Flax order.

With a compute ``dtype`` (bf16) every conv and GroupNorm runs in it as
Flax's do (``model/common.py``: :func:`dense`, :func:`norm`), and the final
Linear, which has no dtype in the Flax model, runs in float32 on the
upcast activations (``strive_tpu/model/cnn.py:120``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense, norm


def flat_size(map_px, kernels, strides, filters):
    """Width of the flattened last activation (VALID convs, reference
    ``utils/torch.py:62-63``)."""
    out = map_px
    for k, s in zip(kernels, strides):
        out = (out - k) // s + 1
    return out * out * filters[-1]


class MapEncoder(nn.Module):
    def __init__(self, in_channels: int, map_px: int, feat_size: int = 64,
                 kernels: Sequence[int] = (7, 5, 5, 3, 3, 3),
                 strides: Sequence[int] = (2, 2, 2, 2, 2, 2),
                 filters: Sequence[int] = (16, 32, 64, 64, 128, 128),
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        self.n = len(kernels)
        cin = in_channels
        for i, (k, f) in enumerate(zip(kernels, filters)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, f, k, stride=strides[i]))
            setattr(self, f"gn{i}", nn.GroupNorm(1, f, eps=1e-5))
            cin = f
        self.out = nn.Linear(flat_size(map_px, kernels, strides, filters),
                             feat_size)

    def forward(self, crop):
        """:param crop: (B, C, H, W) map crop (any memory format), float32
        or already in the compute dtype. :return: (B, feat_size) float32"""
        x = crop
        for i in range(self.n):
            x = dense(getattr(self, f"conv{i}"), x, self.dtype)
            x = F.relu(norm(getattr(self, f"gn{i}"), x, self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.out(x.float())
