"""Gaussian KL / log-likelihood primitives (reference ``losses/common.py``)."""

from __future__ import annotations

import math

import torch


def kl_normal(qm, qv, pm, pv):
    """Elementwise KL(q || p) between diagonal Gaussians, summed over last dim."""
    elem = 0.5 * (torch.log(pv) - torch.log(qv) + qv / pv
                  + (qm - pm) ** 2 / pv - 1.0)
    return torch.sum(elem, dim=-1)


def log_normal(x, m, v):
    """Diagonal-Gaussian log-density summed over the last dim."""
    log_prob = (-torch.log(torch.sqrt(v))
                - math.log(math.sqrt(2 * math.pi))
                - (x - m) ** 2 / (2 * v))
    return torch.sum(log_prob, dim=-1)


class BatchReduce:
    """The sums over the scene batch (axis 0) that the losses divide by,
    where one process holds the whole batch. ``parallel.mesh.ShardedBatch``
    is a rank's share of a batch split over ranks."""

    def total(self, x):
        """The sum of ``x`` (a count or a weight total)."""
        return torch.sum(x)

    def mean(self, x):
        return torch.mean(x)

    def weighted_mean(self, x, w):
        return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)

    def masked_mean(self, x, mask, fallback=0.0):
        """Mean of x over True entries of mask; ``fallback`` when empty."""
        cnt = torch.sum(mask)
        s = torch.sum(torch.where(mask, x, 0.0))
        return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), fallback)

    def values(self, x):
        """A loss value of this batch, or a history of them, whole."""
        return x


WHOLE_BATCH = BatchReduce()
