"""Dataset of padded scene batches and the training batch iterators.

Port of ``strive_tpu/data/dataset.py``: a list of per-scene numpy dicts,
padded into a ``SceneBatch`` on the dataset's device by ``get_batch``.
Without NA buckets every scene is trimmed to ``na_max`` agents (the ego
plus the nearest others at the last past step); with buckets (e.g. ``(8,
16, 32)``) dense scenes keep their agents up to the largest bucket, and
``bucketed_batch_iterator`` batches scenes of one bucket padded to its
size. The iterators draw from ``np.random.default_rng(seed)`` exactly as
strive_tpu's do, so batch order and padding masks are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from ..scene import SceneBatch, pad_scene_arrays
from ..utils.spans import span


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
    """A list of per-scene dicts, trimmed to ``na_max`` agents (to the
    largest bucket with ``buckets``).

    :param device: where ``get_batch`` puts its tensors
    """

    def __init__(self, scenes: List[dict], na_max: int, nc: int,
                 buckets=None, device="cuda"):
        if buckets:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            na_max = buckets[-1]
        self.scenes = [_trim_scene(s, na_max) for s in scenes]
        self.na_max = na_max
        self.nc = nc
        self.buckets = buckets or None
        self.device = device

    def __len__(self):
        return len(self.scenes)

    def scene_dict(self, i):
        return self.scenes[i]

    def bucket_of(self, i) -> int:
        """Smallest bucket holding scene i (na_max without buckets)."""
        if not self.buckets:
            return self.na_max
        na = self.scenes[i]["past"].shape[0]
        return next((b for b in self.buckets if na <= b), self.buckets[-1])

    def get_batch(self, indices, na=None) -> SceneBatch:
        return pad_scene_arrays([self.scene_dict(i) for i in indices],
                                self.na_max if na is None else na, self.nc,
                                device=self.device)


class ConcatSceneDataset:
    """Datasets exposing ``scene_dict(i)`` (same PT/FT/NC), one after another."""

    def __init__(self, datasets):
        self.datasets = [d for d in datasets if len(d) > 0]
        self.na_max = self.datasets[0].na_max
        self.nc = self.datasets[0].nc
        self.device = self.datasets[0].device
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def scene_dict(self, i):
        d = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self.datasets[d].scene_dict(i - int(self._offsets[d]))

    def get_batch(self, indices) -> SceneBatch:
        return pad_scene_arrays([self.scene_dict(i) for i in indices],
                                self.na_max, self.nc, device=self.device)


def _masked_tail(batch, n_real):
    """``batch`` with the scenes from ``n_real`` on masked out entirely."""
    mask = batch.mask.clone()
    mask[n_real:] = False
    return dataclasses.replace(batch, mask=mask)


def batch_iterator(ds, batch_size: int, shuffle=True, seed: Optional[int] = 0,
                   drop_last=False) -> Iterator[SceneBatch]:
    """Fixed-shape batches; the tail is padded with masked-out copies of the
    epoch's first scene, so every batch has the same shape."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        with span("data.batch"):
            if len(idx) < batch_size:
                pad = [int(order[0])] * (batch_size - len(idx))
                batch = _masked_tail(ds.get_batch(list(idx) + pad),
                                     len(idx))
            else:
                batch = ds.get_batch(idx)
        yield batch


def bucketed_batch_iterator(ds, batch_size: int, shuffle=True,
                            seed: Optional[int] = 0,
                            drop_last=False) -> Iterator[SceneBatch]:
    """Batches of scenes of ONE NA bucket each, padded to that bucket's
    agent count; the batches of all buckets are shuffled together, so the
    epoch's order is not sorted by scene density. Without buckets, the
    plain :func:`batch_iterator`."""
    if not getattr(ds, "buckets", None):
        yield from batch_iterator(ds, batch_size, shuffle=shuffle, seed=seed,
                                  drop_last=drop_last)
        return
    by_bucket = {}
    for i in range(len(ds)):
        by_bucket.setdefault(ds.bucket_of(i), []).append(i)
    rng = np.random.default_rng(seed)
    planned = []  # (bucket, indices, pad source)
    for b in sorted(by_bucket):
        idx = np.asarray(by_bucket[b])
        if shuffle:
            rng.shuffle(idx)
        for start in range(0, len(idx), batch_size):
            sel = idx[start:start + batch_size]
            if len(sel) < batch_size and drop_last:
                continue
            planned.append((b, sel, int(idx[0])))
    if shuffle:
        rng.shuffle(planned)
    for b, sel, pad_src in planned:
        if len(sel) < batch_size:
            pad = [pad_src] * (batch_size - len(sel))
            yield _masked_tail(ds.get_batch(list(sel) + pad, na=b), len(sel))
        else:
            yield ds.get_batch(list(sel), na=b)
