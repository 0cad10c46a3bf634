"""Scenes on the maps of ``maps.py``, drawn from the run's seed.

A frozen copy of ``strive_tpu_torch.data.synthetic_etl``'s scenes, cut to
one window of PT + FT frames at 2 Hz with a fixed number of agents, so
every seed gives the same amount of work: the ego (a car of nuScenes' ego
size, seen at every frame) drives along a random lane; on its own lane a
platoon of others follows at its speed ahead of it, 9 m apart; the rest
drive the lanes parallel to it that pass within 70 m of its start, at
random speeds, at least 8 m from it at the start. A non-ego agent is seen
from a frame up to the last past one to a frame past the middle, with a
chance of one unseen frame inside; an unseen frame is NaN here, and the
program's and the reference's padding make it an invisible identity
state. Singapore is flipped about x, as the ETL does. The states are
(x, y, hx, hy, speed, heading rate) normalized by the configuration's
statistics, and (length, width) likewise.
"""

from __future__ import annotations

import numpy as np
import torch

from .maps import lanes

LEAD_GAP_M = 9.0
GAP_M = 8.0
NEAR_M = 70.0
EGO_LW = (4.084, 1.73)  # nuScenes' ego vehicle (the ETL's ego size)


def _lanes(store, name):
    extent = min(store["extents_m"][name])
    ls = lanes(extent, store["spacing_m"])
    start = np.array([l[0] for l in ls])
    head = np.array([l[1] for l in ls])
    length = np.array([l[2] for l in ls], dtype=np.float64)
    return start, head, length


def scene(rng, store, map_idx, n_agents, PT, FT, norm, classes):
    """One scene: a dict of numpy arrays (normalized states) with
    ``map_idx``; NaN where an agent is unseen."""
    name = store["maps"][map_idx]
    start, head, length = _lanes(store, name)
    T = PT + FT
    t = np.arange(T) * 0.5
    x = np.full((n_agents, T, 4), np.nan)
    lw = np.zeros((n_agents, 2), np.float32)
    sem = np.zeros((n_agents, len(classes)), np.float32)
    speed = np.zeros(n_agents)
    slots = list(rng.permutation(np.arange(1, 8)))
    for a in range(n_agents):
        if a == 0:
            li = li0 = int(rng.integers(len(start)))
            v = v0 = (0.0 if rng.random() < 0.15
                      else float(rng.uniform(2.0, 12.0)))
            s0 = s_ego = float(rng.uniform(0.1, 0.6)) * length[li]
        else:
            li = int(rng.choice(near))
            if li == li0 and not slots:
                others = near[near != li0]
                li = int(rng.choice(others)) if len(others) else li0
            if li == li0 and slots:
                v = v0
                s0 = s_ego + LEAD_GAP_M * slots.pop()
            else:
                v = 0.0 if rng.random() < 0.15 else float(
                    rng.uniform(2.0, 12.0))
                for _ in range(8):
                    s0 = float(np.clip(
                        (ego0 - start[li]) @ head[li]
                        + rng.uniform(-NEAR_M / 2, NEAR_M / 2), 0.0,
                        max(length[li] - v * t[-1], 0.0)))
                    if np.linalg.norm(start[li] + s0 * head[li]
                                      - ego0) >= GAP_M:
                        break
        s = s0 + v * t
        (x0, y0), (hc, hs) = start[li], head[li]
        xa = np.stack([x0 + s * hc, y0 + s * hs, np.full(T, hc),
                       np.full(T, hs)], 1)
        xa[:, :2] += rng.normal(0.0, 0.05, (1, 2))
        speed[a] = v
        if a == 0:
            ego0 = xa[0, :2]
            rel = ego0 - start
            along = np.clip(np.sum(rel * head, 1), 0.0, length)
            dist = np.linalg.norm(rel - along[:, None] * head, axis=1)
            near = np.nonzero((dist < NEAR_M)
                              & (np.abs(head @ head[li0]) > 0.9))[0]
            lw[a] = EGO_LW
            sem[a, classes.index("car")] = 1.0
        else:
            first = int(rng.integers(0, PT))
            last = int(rng.integers(max(first + 2, T // 2 + 1), T + 1))
            seen = np.zeros(T, bool)
            seen[first:last] = True
            if last - first > 4 and rng.random() < 0.3:
                gap = int(rng.integers(first + 1, last - 1))
                if gap != PT - 1:
                    seen[gap] = False
            xa[~seen] = np.nan
            kind = "car" if rng.random() < 0.8 else "truck"
            lw[a] = ((rng.uniform(3.8, 5.2), rng.uniform(1.7, 2.1))
                     if kind == "car" else
                     (rng.uniform(6.0, 10.0), rng.uniform(2.3, 2.8)))
            sem[a, classes.index(kind)] = 1.0
        x[a] = xa
    if store["flip_singapore"] and name.startswith("singapore"):
        x[..., 1] = store["extents_m"][name][0] - x[..., 1]
        x[..., 3] = -x[..., 3]
    st = np.concatenate([x, np.broadcast_to(speed[:, None, None], (
        n_agents, T, 1)), np.zeros((n_agents, T, 1))], -1)
    st = np.where(np.isnan(x[..., :1]), np.nan, st)
    sm, ss = np.array(norm["state"]["mean"]), np.array(norm["state"]["std"])
    am, as_ = np.array(norm["att"]["mean"]), np.array(norm["att"]["std"])
    stn = ((st - sm) / ss).astype(np.float32)
    vis = (~np.isnan(x[..., 0])).astype(np.float32)
    return {"past": stn[:, :PT], "past_vis": vis[:, :PT],
            "future": stn[:, PT:], "future_vis": vis[:, PT:],
            "past_gt": stn[:, :PT].copy(), "future_gt": stn[:, PT:].copy(),
            "sem": sem, "lw": ((lw - am) / as_).astype(np.float32),
            "map_idx": int(map_idx)}


def batch(seed, index, store, batch_size, n_agents, PT, FT, norm, classes):
    """The scenes of batch ``index`` of a run: scene j on map j mod M,
    from a generator seeded by (seed, index)."""
    rng = np.random.default_rng([int(seed), int(index)])
    M = len(store["maps"])
    return [scene(rng, store, j % M, n_agents, PT, FT, norm, classes)
            for j in range(batch_size)]


def pad(scenes, device):
    """A padded batch as the reference reads it: a dict of tensors, unseen
    frames the identity state with visibility 0 (every agent is real)."""
    ident = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    out = {}
    for k in ("past", "future", "past_gt", "future_gt"):
        a = np.stack([s[k] for s in scenes])
        a = np.where(np.isnan(a).any(-1, keepdims=True), ident, a)
        out[k] = torch.from_numpy(a.astype(np.float32)).to(device)
    for k in ("past_vis", "future_vis", "sem", "lw"):
        out[k] = torch.from_numpy(np.stack([s[k] for s in scenes])).to(device)
    out["mask"] = torch.ones(out["lw"].shape[:2], dtype=torch.bool,
                             device=device)
    out["map_idx"] = torch.tensor([s["map_idx"] for s in scenes],
                                  dtype=torch.int64, device=device)
    return out
