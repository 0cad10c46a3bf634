"""Dense padded scene batches.

Port of ``strive_tpu/scene.py``. Every scene is fully connected, so a batch
is fixed-shape ``(B, NA)`` padded tensors with a validity mask. The ego is
always agent 0 of each scene. Unobserved frames are encoded with
``*_vis == 0`` masks instead of NaNs; padded agent slots carry a benign
identity pose so frame transforms stay finite.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SceneBatch:
    """A batch of padded scenes; state tensors are NORMALIZED.

    Shapes: B scenes, NA agents (padded), PT past steps, FT future steps,
    NC semantic classes.
    """

    past: torch.Tensor          # (B, NA, PT, 6) (x,y,hx,hy,s,hdot)
    past_vis: torch.Tensor      # (B, NA, PT) 1.0 if observed
    sem: torch.Tensor           # (B, NA, NC) one-hot class
    lw: torch.Tensor            # (B, NA, 2) (length, width)
    mask: torch.Tensor          # (B, NA) bool, True for real agents
    map_idx: torch.Tensor       # (B,) int64 map index
    future: Optional[torch.Tensor] = None      # (B, NA, FT, 6)
    future_vis: Optional[torch.Tensor] = None  # (B, NA, FT)
    past_gt: Optional[torch.Tensor] = None     # (B, NA, PT, 6)
    future_gt: Optional[torch.Tensor] = None   # (B, NA, FT, 6)

    @property
    def B(self):
        return self.past.shape[0]

    @property
    def NA(self):
        return self.past.shape[1]

    @property
    def PT(self):
        return self.past.shape[2]

    @property
    def FT(self):
        return 0 if self.future is None else self.future.shape[2]

    @property
    def NC(self):
        return self.sem.shape[-1]

    def num_agents(self):
        """(B,) number of real agents per scene."""
        return torch.sum(self.mask.to(torch.int64), dim=1)

    def take(self, ids):
        """The scenes ``ids`` (a list, array or tensor of indices, repeats
        allowed), on every field."""
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.past.device)
        return SceneBatch(**{k: None if v is None else v[ids]
                             for k, v in vars(self).items()})


IDENTITY_STATE = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=np.float32)


def pad_scene_arrays(per_scene, na_max, nc, device="cuda"):
    """Stack a list of per-scene dicts of numpy arrays into a padded batch.

    Each dict holds ``past (na, PT, 6)``, ``past_vis``, ``sem (na, NC)``,
    ``lw (na, 2)``, ``map_idx`` (int) and optionally future/future_vis/
    past_gt/future_gt. NaN frames are replaced by identity states with vis 0.
    """
    B = len(per_scene)
    PT = per_scene[0]["past"].shape[1]

    def _clean(traj, vis=None):
        nanmask = np.isnan(traj).any(axis=-1)
        traj = np.where(nanmask[..., None], IDENTITY_STATE[: traj.shape[-1]],
                        traj)
        if vis is None:
            vis = np.ones(nanmask.shape, np.float32)
        vis = np.where(nanmask, 0.0, vis)
        return traj.astype(np.float32), vis.astype(np.float32)

    def _traj_fill(T):
        return np.tile(IDENTITY_STATE, (B, na_max, T, 1)).astype(np.float32)

    out = {
        "past": _traj_fill(PT),
        "past_vis": np.zeros((B, na_max, PT), np.float32),
        "sem": np.zeros((B, na_max, nc), np.float32),
        "lw": np.zeros((B, na_max, 2), np.float32),
        "mask": np.zeros((B, na_max), bool),
        "map_idx": np.zeros((B,), np.int64),
    }
    has_future = "future" in per_scene[0]
    has_past_gt = "past_gt" in per_scene[0]
    has_future_gt = "future_gt" in per_scene[0]
    if has_future:
        FT = per_scene[0]["future"].shape[1]
        out["future"] = _traj_fill(FT)
        out["future_vis"] = np.zeros((B, na_max, FT), np.float32)
    if has_past_gt:
        out["past_gt"] = _traj_fill(PT)
    if has_future_gt:
        out["future_gt"] = _traj_fill(per_scene[0]["future_gt"].shape[1])

    for b, sc in enumerate(per_scene):
        na = sc["past"].shape[0]
        out["past"][b, :na], out["past_vis"][b, :na] = _clean(
            sc["past"], sc.get("past_vis"))
        out["sem"][b, :na] = sc["sem"]
        out["lw"][b, :na] = sc["lw"]
        out["mask"][b, :na] = True
        out["map_idx"][b] = sc["map_idx"]
        if has_future:
            out["future"][b, :na], out["future_vis"][b, :na] = _clean(
                sc["future"], sc.get("future_vis"))
        if has_past_gt:
            out["past_gt"][b, :na], _ = _clean(sc["past_gt"])
        if has_future_gt:
            out["future_gt"][b, :na], _ = _clean(sc["future_gt"])

    return SceneBatch(**{k: torch.from_numpy(v).to(device)
                         for k, v in out.items()})
