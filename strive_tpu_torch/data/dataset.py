"""Dataset of padded scene batches.

Port of ``strive_tpu/data/dataset.py``'s ``SceneDataset``: a list of
per-scene numpy dicts, each trimmed to ``na_max`` agents (the ego plus the
nearest others at the last past step), padded into a ``SceneBatch`` on the
dataset's device by ``get_batch``. ``ConcatSceneDataset``, the batch
iterators and the NA buckets serve training and are not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..scene import SceneBatch, pad_scene_arrays


def _trim_scene(sc, na_max):
    na = sc["past"].shape[0]
    if na <= na_max:
        return sc
    ego_pos = sc["past"][0, -1, :2]
    d = np.linalg.norm(sc["past"][:, -1, :2] - ego_pos, axis=-1)
    d[0] = -1.0  # ego always kept
    keep = np.argsort(d)[:na_max]
    keep.sort()
    out = {}
    for k, v in sc.items():
        out[k] = v[keep] if isinstance(v, np.ndarray) and v.ndim >= 1 and \
            v.shape[0] == na else v
    return out


class SceneDataset:
    """A list of per-scene dicts, trimmed to ``na_max`` agents.

    :param device: where ``get_batch`` puts its tensors
    """

    def __init__(self, scenes: List[dict], na_max: int, nc: int,
                 buckets=None, device="cuda"):
        if buckets:
            raise NotImplementedError(
                "NA buckets (na_buckets) are not ported yet (training, P9)")
        self.scenes = [_trim_scene(s, na_max) for s in scenes]
        self.na_max = na_max
        self.nc = nc
        self.device = device

    def __len__(self):
        return len(self.scenes)

    def get_batch(self, indices) -> SceneBatch:
        return pad_scene_arrays([self.scenes[i] for i in indices],
                                self.na_max, self.nc, device=self.device)
