"""Mean/std normalization and the nuScenes statistics tables.

Port of ``strive_tpu/normalize.py`` (reference ``datasets/utils.py:44-193``).
The position mean MUST be 0 (reference comment ``datasets/utils.py:137``):
the model transforms normalized positions between frames, which is only
valid when normalization is a pure scaling.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class MeanStdNormalizer:
    """(data - mean) / std over the trailing dim, partial-dim aware.

    If the input's last dim is smaller than D, only the first ``last_dim``
    stats are used. Works on tensors (on any device) and numpy arrays.
    """

    def __init__(self, mean_vals, std_vals):
        self.mean_np = np.asarray(mean_vals, dtype=np.float32)
        self.std_np = np.asarray(std_vals, dtype=np.float32)

    @property
    def D(self):
        return self.mean_np.shape[0]

    def _stats(self, x):
        d = x.shape[-1]
        if isinstance(x, torch.Tensor):
            return (torch.as_tensor(self.mean_np[:d], device=x.device),
                    torch.as_tensor(self.std_np[:d], device=x.device))
        return self.mean_np[:d], self.std_np[:d]

    def normalize(self, x):
        mean, std = self._stats(x)
        return (x - mean) / std

    def unnormalize(self, x):
        mean, std = self._stats(x)
        return x * std + mean


# mean/std per quantity keyed by the category tuple used for training
# (reference datasets/utils.py:130-193)
_DEFAULT_STATS = {
    "l": (4.844294, 1.084860),
    "w": (2.021752, 0.299647),
    "s": (1.802009, 3.507907),
    "h": (0.0, 1.0),  # already a unit vector
    "hdot": (-0.000037, 0.055684),
    "lscale": (0.0, 15.0),  # mean must be 0 (frame-transform assumption)
    "a": (0.409074, 1.045530),
    "ddh": (0.000046, 0.075032),
}

NUSC_NORM_STATS = {
    ("car", "truck"): dict(_DEFAULT_STATS),
    ("bus", "car", "construction", "emergency", "truck"): dict(_DEFAULT_STATS),
    (
        "bus", "car", "construction", "cyclist", "emergency", "motorcycle",
        "pedestrian", "truck",
    ): dict(_DEFAULT_STATS),
    ("car", "cyclist", "motorcycle", "pedestrian", "truck"): dict(_DEFAULT_STATS),
    ("bus", "car", "motorcycle", "trailer", "truck"): {
        "l": (5.135896, 2.072248),
        "w": (2.042160, 0.409259),
        "s": (1.789616, 3.480962),
        "h": (0.0, 1.0),
        "hdot": (-0.000115, 0.058249),
        "lscale": (0.0, 15.0),
    },
    # no normalization
    (
        "bus", "car", "construction", "cyclist", "emergency", "motorcycle",
        "pedestrian", "trailer", "truck",
    ): {k: (0.0, 1.0) for k in _DEFAULT_STATS},
}


# raw annotation category -> the 5-way network label (reference
# nuscenes_dataset.py:159-171)
REDUCED_CAT = {
    "car": "car", "truck": "truck", "bus": "truck",
    "motorcycle": "motorcycle", "trailer": "truck", "cyclist": "cyclist",
    "pedestrian": "pedestrian", "emergency": "car", "construction": "truck",
}


def effective_categories(agent_types, reduce_cats=False) -> Tuple[str, ...]:
    """The sorted category set the MODEL sees (after optional reduction)."""
    if reduce_cats:
        return tuple(sorted({REDUCED_CAT[c] for c in agent_types}))
    return tuple(sorted(agent_types))


def state_normalizer_for(categories: Tuple[str, ...]) -> MeanStdNormalizer:
    """6-dim (x,y,hx,hy,s,hdot) state normalizer for a category set."""
    stats = NUSC_NORM_STATS[tuple(sorted(categories))]
    mean = [stats["lscale"][0], stats["lscale"][0], stats["h"][0], stats["h"][0],
            stats["s"][0], stats["hdot"][0]]
    std = [stats["lscale"][1], stats["lscale"][1], stats["h"][1], stats["h"][1],
           stats["s"][1], stats["hdot"][1]]
    return MeanStdNormalizer(mean, std)


def att_normalizer_for(categories: Tuple[str, ...]) -> MeanStdNormalizer:
    """(l, w) vehicle-attribute normalizer for a category set."""
    stats = NUSC_NORM_STATS[tuple(sorted(categories))]
    return MeanStdNormalizer([stats["l"][0], stats["w"][0]],
                             [stats["l"][1], stats["w"][1]])
