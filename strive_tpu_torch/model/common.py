"""Shared neural blocks: reference-layout MLP and torch-semantics GRU.

Port of ``strive_tpu/model/common.py``. Module and parameter names follow
the Flax tree (``fc{i}``, ``ln{i}``, ``layer{l}.ih``/``hh``) so that
``utils/convert.py`` maps parameters by name.

MLP matches reference ``models/common.py:8-44``: Linear, then for every
subsequent layer (LayerNorm over the previous width -> nonlinearity ->
Linear).

A compute ``dtype`` (bf16) follows Flax's policy, not ``torch.autocast``'s:
the parameters stay float32 and each layer casts inside ``forward``, so
gradients land on the float32 leaves. ``nn.Dense(dtype=bf16)`` casts input,
kernel and bias, and adds the bias in bf16 after the product
(:func:`dense`); ``nn.LayerNorm(dtype=bf16)`` / ``nn.GroupNorm`` take their
statistics and normalize in float32 and cast the output (:func:`norm`,
``flax/linen/normalization.py`` ``_compute_stats`` / ``_normalize``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def dense(lin, x, dtype=None):
    """``lin`` (a Linear or Conv2d) applied as Flax's ``Dense`` / ``Conv``
    with compute ``dtype``: None is the float32 layer itself; otherwise
    input, weight and bias in ``dtype``, the product, then the bias add,
    as two ops."""
    if dtype is None:
        return lin(x)
    w, b = lin.weight.to(dtype), lin.bias.to(dtype)
    if isinstance(lin, nn.Conv2d):
        return F.conv2d(x.to(dtype), w, stride=lin.stride) + b[:, None, None]
    return F.linear(x.to(dtype), w) + b


def norm(layer, x, dtype=None):
    """A LayerNorm or GroupNorm applied as Flax's with compute ``dtype``:
    None is the float32 layer itself; otherwise statistics and the
    normalization in float32 on the upcast input, the output in ``dtype``."""
    if dtype is None:
        return layer(x)
    if isinstance(layer, nn.GroupNorm):
        y = F.group_norm(x.float(), layer.num_groups, layer.weight,
                         layer.bias, layer.eps)
    else:
        y = F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                         layer.bias, layer.eps)
    return y.to(dtype)


class MLP(nn.Module):
    """Reference-layout MLP.

    :param in_dim: input width (Flax infers it; torch needs it)
    :param layers: output widths, e.g. (128, 128, out)
    :param dtype: compute dtype (None: float32); the output is in it
    """

    def __init__(self, in_dim: int, layers: Sequence[int], dtype=None):
        super().__init__()
        self.n = len(layers)
        self.dtype = dtype
        self.fc0 = nn.Linear(in_dim, layers[0])
        for i in range(1, self.n):
            # epsilon matches torch nn.LayerNorm (1e-5), as in the Flax model
            setattr(self, f"ln{i}", nn.LayerNorm(layers[i - 1], eps=1e-5))
            setattr(self, f"fc{i}", nn.Linear(layers[i - 1], layers[i]))

    def forward(self, x):
        x = dense(self.fc0, x, self.dtype)
        for i in range(1, self.n):
            x = norm(getattr(self, f"ln{i}"), x, self.dtype)
            x = F.relu(x)
            x = dense(getattr(self, f"fc{i}"), x, self.dtype)
        return x


class GRUCell(nn.Module):
    """h' = (1-z)*n + z*h with n = tanh(W_in x + b_in + r*(W_hn h + b_hn));
    gate order (r, z, n) as in torch.nn.GRU."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.ih = nn.Linear(in_dim, 3 * hidden_size)
        self.hh = nn.Linear(hidden_size, 3 * hidden_size)

    def forward(self, x, h):
        xr, xz, xn = self.ih(x).chunk(3, dim=-1)
        hr, hz, hn = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class StackedGRU(nn.Module):
    """Stack of GRU cells applied to one timestep (state-in, state-out)."""

    def __init__(self, in_dim: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for l in range(num_layers):
            setattr(self, f"layer{l}",
                    GRUCell(in_dim if l == 0 else hidden_size, hidden_size))

    def forward(self, x, hs):
        """:param x: (..., D); :param hs: (num_layers, ..., H).
        :return: (output (..., H), new states (num_layers, ..., H))"""
        new_hs = []
        inp = x
        for l in range(self.num_layers):
            inp = getattr(self, f"layer{l}")(inp, hs[l])
            new_hs.append(inp)
        return inp, torch.stack(new_hs, dim=0)
