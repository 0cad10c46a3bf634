"""The model's weights, drawn from the run's seed on the run's device.

The distributions of Flax's defaults, which STRIVE's JAX rebuild
initializes with: every Linear and conv kernel LeCun-normal (a normal
truncated at two standard deviations, scaled to variance 1 / fan_in),
every bias 0, every LayerNorm and GroupNorm scale 1. All kernels come
from one draw of a ``torch.Generator`` on the device, cut in the order of
``reference.model.param_shapes``; the program and the reference are both
given these tensors.
"""

from __future__ import annotations

import math

import torch

from ..reference.model import param_shapes

TRUNC_STD = .87962566103423978  # std of a standard normal cut at +-2


def draw(model_cfg, seed, device):
    """:return: {name: float32 tensor on ``device``}"""
    shapes = param_shapes(model_cfg)
    kernels = [(n, s) for n, s in shapes.items()
               if n.endswith(".weight") and len(s) >= 2]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, generator=gen)
    out, at = {}, 0
    for n, s in shapes.items():
        if (n, s) in kernels:
            k = math.prod(s)
            fan_in = k // s[0]
            out[n] = (flat[at:at + k].view(s)
                      * (math.sqrt(1.0 / fan_in) / TRUNC_STD))
            at += k
        elif n.endswith(".bias"):
            out[n] = torch.zeros(s, dtype=torch.float32, device=device)
        else:  # LayerNorm and GroupNorm scales
            out[n] = torch.ones(s, dtype=torch.float32, device=device)
    return out
