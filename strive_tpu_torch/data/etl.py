"""Offline nuScenes ETL -> fixed-shape arrays + windowed dataset.

Port of the reference dataset semantics (``datasets/nuscenes_dataset.py``):

- per-scene 2Hz agent states (x, y, hx, hy, s, hdot) + accel (a, ddh) from
  finite differences (velocity/heading_change_rate,
  ``nuscenes_utils.py:145-199``), NaN at unobserved frames,
- Singapore trajectories flipped about x (right-hand driving, :379-382),
- agent frames dropped when <30% of the footprint is on drivable area or
  >=30% is on a carpark (:504-522),
- splits: train/val by scene with the precomputed random val index lists
  NUSC_VAL_SPLIT_200/400 (:292-341), test = nuScenes val,
- windows of (past_len, future_len) every ``seq_interval`` steps; agents
  kept only if observed at the last past frame; ego always node 0
  (:594-649); normalization + optional Gaussian noise with heading
  renormalization (:658-676).

The expensive extraction (needs nuscenes-devkit + raw data) runs ONCE via
``strive_tpu_torch.scripts.preprocess_nuscenes`` and lands in npz files;
training/eval load those and build padded windows on the fly.

Copy of ``strive_tpu/data/etl.py``: the same functions, draws and windows;
the drivable filter goes through the port's ``check_on_layer`` on the
raster's device, and ``load_etl_dataset`` puts the store and the batches
on the device it is given.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..normalize import MeanStdNormalizer
from .dataset import _trim_scene

# precomputed random val splits (reference datasets/utils.py:199-201)
NUSC_VAL_SPLIT_200 = [408,481,190,277,639,10,278,77,125,435,292,38,287,404,424,28,126,622,364,211,386,493,258,354,594,153,561,486,11,571,264,319,350,565,390,189,254,306,382,669,591,219,91,403,67,193,156,242,524,311,620,499,32,240,491,15,621,270,144,207,284,584,214,640,556,42,597,328,405,225,276,338,676,660,632,1,251,406,449,259,48,460,177,135,268,359,626,545,605,348,134,141,631,206,456,550,624,551,426,467,187,198,2,691,617,662,634,501,599,155,255,527,326,35,50,596,299,685,76,414,352,539,142,448,307,303,635,396,479,531,161,471,413,89,249,603,512,474,630,612,654,610,281,290,495,618,569,93,43,218,228,490,51,425,324,30,409,535,446,478,279,688,232,677,331,4,652,650,296,450,188,376,257,552,56,330,20,231,205,47,563,127,8,627,504,103,148,123,473,332,420,81,678,17,656,674,575,494,371,366]
NUSC_VAL_SPLIT_400 = [27,154,689,477,393,42,1,9,95,676,252,427,380,452,214,360,105,101,402,429,331,349,372,115,308,318,201,338,377,527,490,162,215,38,385,234,494,285,311,616,172,107,282,47,541,428,14,673,86,606,418,388,143,188,378,224,480,295,594,463,479,320,572,281,379,431,410,390,321,533,142,357,488,608,69,624,561,699,24,680,602,443,251,73,40,121,255,471,8,79,422,61,316,49,644,538,305,23,681,524,497,509,137,466,579,157,345,526,562,20,396,294,373,409,84,485,123,230,239,337,678,636,623,97,329,85,323,459,161,666,621,581,227,660,88,326,597,268,469,131,464,103,622,670,515,31,548,613,661,191,346,684,78,537,46,468,677,447,217,15,164,619,493,592,653,685,170,353,262,439,112,355,543,395,290,650,194,118,630,34,690,125,322,573,612,225,306,449,275,216,640,77,655,603,5,246,598,266,536,478,601,139,438,474,682,618,599,450,588,626,667,159,391,82,127,33,200,134,229,303,89,496,698,432,41,141,212,507,384,58,499,245,235,2,76,122,614,679,420,580,361,458,336,586,96,430,508,284,312,12,70,334,63,609,335,135,663,309,585,186,256,656,407,475,240,454,444,220,236,487,150,412,249,482,519,367,687,359,522,569,176,94,500,532,652,554,68,93,221,192,278,7,4,32,25,405,19,451,371,279,133,465,299,258,368,87,501,615,486,436,492,560,22,117,552,204,605,218,341,350,697,36,434,167,632,539,319,195,406,178,280,529,483,401,132,550,453,54,351,163,274,421,272,152,356,190,374,369,521,35,66,516,128,182,181,511,232,333,628,171,576,348,631,518,354,277,620,415,196,417,29,160,570,694,0,649,211,557,265,21,583,512,470,177,11,288,457,643,534,633,525,435,376,48,565,411,269,617,248,210]

CAT2KEY = {
    "car": ["vehicle.car"],
    "truck": ["vehicle.truck"],
    "bus": ["vehicle.bus"],
    "motorcycle": ["vehicle.motorcycle"],
    "trailer": ["vehicle.trailer"],
    "cyclist": ["vehicle.bicycle"],
    "pedestrian": ["human.pedestrian"],
    "emergency": ["vehicle.emergency"],
    "construction": ["vehicle.construction"],
}
REDUCE_MAP = {
    "vehicle.car": "car", "vehicle.truck": "truck", "vehicle.bus": "truck",
    "vehicle.motorcycle": "motorcycle", "vehicle.trailer": "truck",
    "vehicle.bicycle": "cyclist", "human.pedestrian": "pedestrian",
    "vehicle.emergency": "car", "vehicle.construction": "truck",
}


def velocity(pos, t):
    """Backward finite differences; forward diff for leading frames and
    nan->value transitions (reference ``nuscenes_utils.py:173-199``)."""
    vel_diff = (pos[1:] - pos[:-1]) / (t[1:] - t[:-1]).reshape(-1, 1)
    vel = np.concatenate([vel_diff[0:1], vel_diff], axis=0)
    posnan = np.isnan(pos.sum(axis=1)).astype(int)
    if posnan.sum() == 0:
        return vel
    lead = np.append([False], (posnan[1:] - posnan[:-1]) == -1)
    repl = np.append([False], lead[:-1])
    if repl.sum() != 0:
        if repl.sum() != lead.sum():
            lead[-1] = False
        vel[lead] = vel[repl]
    return vel


def heading_change_rate(h, t):
    """Same scheme for heading angles (reference
    ``nuscenes_utils.py:145-171``)."""
    period = 2 * np.pi
    diff = (h[1:] - h[:-1] + period / 2) % period - period / 2
    diff = np.where(diff > np.pi, diff - 2 * np.pi, diff) / (t[1:] - t[:-1])
    hdot = np.append(diff[0:1], diff)
    hnan = np.isnan(h).astype(int)
    if hnan.sum() == 0:
        return hdot
    lead = np.append([False], (hnan[1:] - hnan[:-1]) == -1)
    repl = np.append([False], lead[:-1])
    if repl.sum() != 0:
        if repl.sum() != lead.sum():
            lead[-1] = False
        hdot[lead] = hdot[repl]
    return hdot


def states_from_xyh(x, h, t):
    """(T, 4)+(T,)+(T,) -> traj (T, 6), accel (T, 2), is_vis (T,)."""
    vel = velocity(x[:, :2], t)
    s = np.linalg.norm(vel, axis=1)[:, None]
    a = np.linalg.norm(velocity(vel, t), axis=1)[:, None]
    hdot = heading_change_rate(h, t)[:, None]
    ddh = heading_change_rate(hdot[:, 0], t)[:, None]
    no_vis = np.isnan(s[:, 0])
    x = np.where(no_vis[:, None], np.nan, x)
    traj = np.concatenate([x, s, hdot], axis=1)
    accel = np.concatenate([a, ddh], axis=1)
    return traj, accel, (~no_vis).astype(np.float32)


def drivable_keep_mask(x, lw, map_idx, drivable, dx, carpark=None):
    """Per-frame agent filter (reference ``nuscenes_dataset.py:504-522``):
    keep an OBSERVED frame iff >= 30% of the footprint is on drivable area
    and (when a carpark layer exists) < 30% is on a carpark. Unobserved
    (NaN) frames are trivially kept — the reference only evaluates the
    filter at observed frames.

    :param x: (T, 4) raw (x, y, hx, hy), NaN at unobserved frames
    :param lw: (2,); map_idx: int
    :param drivable: (M, H, W) layer-0 raster (numpy, or a tensor on the
        device the filter runs on); carpark: (M, H, W) or None
    :param dx: (M, 2) meters per pixel
    :return: (T,) bool
    """
    return drivable_keep_masks(x[None], np.asarray(lw)[None], map_idx,
                               drivable, dx, carpark)[0]


def drivable_keep_masks(xs, lws, map_idx, drivable, dx, carpark=None):
    """:func:`drivable_keep_mask` of N agents of one map in one pass (each
    footprint's fraction is its own sum of 0/1 samples, so the masks are
    those of N separate calls).

    :param xs: (N, T, 4); lws: (N, 2)
    :return: (N, T) bool
    """
    from ..maps.queries import check_on_layer

    drivable = torch.as_tensor(drivable)
    dev = drivable.device
    N, T = xs.shape[:2]
    valid_in = ~np.isnan(xs).any(-1)
    safe = np.where(valid_in[..., None], xs, 0.0).astype(np.float32)
    lw_r = np.repeat(np.asarray(lws, np.float32)[:, None], T, axis=1)
    args = (torch.as_tensor(dx, device=dev),
            torch.from_numpy(safe.reshape(N * T, 4)).to(dev),
            torch.from_numpy(lw_r.reshape(N * T, 2)).to(dev),
            torch.full((N * T,), int(map_idx), dtype=torch.int64, device=dev))
    frac = check_on_layer(drivable, *args).cpu().numpy().reshape(N, T)
    keep = frac >= 0.3
    if carpark is not None:
        cfrac = check_on_layer(torch.as_tensor(carpark, device=dev),
                               *args).cpu().numpy().reshape(N, T)
        keep &= cfrac < 0.3
    return keep | ~valid_in


def agent_states_with_filter(x, hh, ts, keep=None):
    """Apply the frame filter to the RAW positions, THEN finite-difference
    (reference order, ``nuscenes_dataset.py:522-553``: filtered frames
    become NaN positions BEFORE velocity/heading rates, which shapes the
    visibility pattern at filter boundaries).

    :param x: (T, 4) raw states, NaN at unobserved frames; hh: (T,) heading
    :param keep: optional (T,) bool from :func:`drivable_keep_mask`
    :return: (traj (T, 6), accel (T, 2), vis (T,)) or None if every frame
        is filtered/unobserved (the reference drops such agents, ``:531``)
    """
    if keep is not None:
        x = np.where(keep[:, None], x, np.nan)
        hh = np.where(keep, hh, np.nan)
    if np.isnan(x[:, 0]).all():
        return None
    return states_from_xyh(x, hh, ts)


NUM_IN_TRAIN_VAL_CHALLENGE = 200  # reference nuscenes_dataset.py:34


def challenge_split_scenes(prediction_scenes, official_train, official_val,
                           split):
    """nuScenes prediction-challenge scene selection (reference
    ``nuscenes_dataset.py:35-62`` + the chall_split_map at ``:332-341``):
    our 'train' is the challenge train (official train scenes after the
    first 200), 'val' the challenge train_val (first 200), 'test' the
    official val split.

    :param prediction_scenes: scene_name -> ["{inst_tok}_{samp_tok}", ...]
        (the devkit's maps/prediction/prediction_scenes.json, plain JSON)
    :return: {scene_name: [inst_samp_tok, ...]} for the split
    """
    if split == "train":
        names = official_train[NUM_IN_TRAIN_VAL_CHALLENGE:]
    elif split == "val":
        names = official_train[:NUM_IN_TRAIN_VAL_CHALLENGE]
    else:
        names = official_val
    return {s: prediction_scenes.get(s, []) for s in names}


def challenge_anchors_for_scene(sc, tokens):
    """(agent_idx, t_idx) anchors for a scene's challenge tokens.

    The reference anchors each prediction case so the LAST PAST FRAME is
    the challenge sample frame (``nuscenes_dataset.py:573-581``).
    Requires the scene dict to carry ``agent_tokens`` (per agent) and
    ``sample_tokens`` (per timestep) from preprocessing.
    """
    tok2agent = {t: i for i, t in enumerate(sc.get("agent_tokens", []))}
    tok2t = {t: i for i, t in enumerate(sc.get("sample_tokens", []))}
    anchors = []
    for inst_samp in tokens:
        inst, samp = inst_samp.rsplit("_", 1)
        if inst in tok2agent and samp in tok2t:
            anchors.append((tok2agent[inst], tok2t[samp]))
    return anchors


def split_scene_names(all_scene_names, split, version, val_size=200,
                      randomize_val=False):
    """Reference get_scenes (:292-341), minus challenge splits."""
    scenes = np.array(sorted(all_scene_names))
    n_val = val_size if version == "trainval" else 2
    val_mask = np.zeros(len(scenes), bool)
    if split in ("train", "val"):
        if randomize_val:
            if version == "mini":
                inds = [0, 1]
            elif n_val == 200:
                inds = NUSC_VAL_SPLIT_200
            elif n_val == 400:
                inds = NUSC_VAL_SPLIT_400
            else:
                raise ValueError("val_size must be 200 or 400")
            val_mask[np.array(inds)] = True
        else:
            val_mask[:n_val] = True
    if split == "train":
        scenes = scenes[~val_mask]
    elif split == "val":
        scenes = scenes[val_mask]
    return sorted(scenes.tolist())


class WindowedSceneDataset:
    """Window view over per-scene agent arrays (duck-types SceneDataset).

    ``scenes``: list of dicts with keys traj (NAg, T, 6) (NaN at unobserved),
    vis (NAg, T), lw (NAg, 2), sem (NAg, NC), map_idx, name. Agent 0 is ego.
    ``get_batch`` puts its tensors on ``device``.
    """

    def __init__(self, scenes, na_max, nc, past_len, future_len,
                 state_norm: MeanStdNormalizer, att_norm: MeanStdNormalizer,
                 seq_interval=1, noise_std=0.0, seed=0,
                 require_full_past=False, include_final_window=False,
                 buckets=None, challenge=False, device="cuda"):
        if buckets:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            na_max = buckets[-1]
        self.buckets = buckets
        self.device = device
        self.scenes = scenes
        self.na_max = na_max
        self.nc = nc
        self.PT = past_len
        self.FT = future_len
        self.state_norm = state_norm
        self.att_norm = att_norm
        self.noise_std = noise_std
        self.require_full_past = require_full_past
        self.rng = np.random.default_rng(seed)
        seq_len = past_len + future_len
        # reference windowing (nuscenes_dataset.py:586) EXCLUDES the final
        # exact-length window; scenario re-ingestion needs it included
        # because saved scenarios are exactly seq_len long (PARITY.md)
        end_off = 1 if include_final_window else 0
        self.windows = []
        if challenge:
            # one window per challenge prediction case, anchored so the
            # last past frame is the challenge sample frame (reference
            # nuscenes_dataset.py:573-581)
            for si, sc in enumerate(scenes):
                T = sc["traj"].shape[1]
                for ai, t in sc.get("challenge_anchors", []):
                    start = int(t) - past_len + 1
                    if start >= 0 and start + seq_len <= T:
                        self.windows.append((si, start))
        else:
            for si, sc in enumerate(scenes):
                T = sc["traj"].shape[1]
                for start in range(0, T - seq_len + end_off, seq_interval):
                    self.windows.append((si, start))

    def __len__(self):
        return len(self.windows)

    def scene_dict(self, i):
        return self.window_scene(i)

    def window_scene(self, wi):
        """Build one per-scene dict (normalized) for a window index."""
        si, sidx = self.windows[wi]
        sc = self.scenes[si]
        midx = sidx + self.PT
        eidx = midx + self.FT
        traj = sc["traj"][:, sidx:eidx]
        vis = sc["vis"][:, sidx:eidx]
        # ego (agent 0) always kept; others need the last past frame
        keep = ~np.isnan(traj[:, self.PT - 1]).any(axis=-1)
        keep[0] = True
        if self.require_full_past:
            keep &= ~np.isnan(traj[:, : self.PT]).any(axis=(1, 2))
            keep[0] = True
        traj, vis = traj[keep], vis[keep]
        lw, sem = sc["lw"][keep], sc["sem"][keep]

        past = np.asarray(self.state_norm.normalize(traj[:, : self.PT]))
        future = np.asarray(self.state_norm.normalize(traj[:, self.PT :]))
        out = {
            "past": past, "past_vis": vis[:, : self.PT],
            "future": future, "future_vis": vis[:, self.PT :],
            "past_gt": past.copy(), "future_gt": future.copy(),
            "sem": sem.astype(np.float32),
            "lw": np.asarray(self.att_norm.normalize(lw)),
            "map_idx": int(sc["map_idx"]),
        }
        if self.noise_std > 0:
            for k in ("past", "future"):
                arr = out[k] + self.rng.normal(
                    0, self.noise_std, out[k].shape
                ).astype(np.float32)
                h = arr[..., 2:4]
                arr[..., 2:4] = h / np.maximum(
                    np.linalg.norm(h, axis=-1, keepdims=True), 1e-9
                )
                arr[..., :2] = np.maximum(arr[..., :2], 0.0)
                out[k] = arr
            out["lw"] = out["lw"] + self.rng.normal(
                0, self.noise_std, out["lw"].shape
            ).astype(np.float32)
        return _trim_scene(out, self.na_max)

    def window_na(self, wi):
        """Agent count of a window (cheap; no normalization)."""
        si, sidx = self.windows[wi]
        sc = self.scenes[si]
        traj = sc["traj"][:, sidx : sidx + self.PT + self.FT]
        keep = ~np.isnan(traj[:, self.PT - 1]).any(axis=-1)
        keep[0] = True
        if self.require_full_past:
            keep &= ~np.isnan(traj[:, : self.PT]).any(axis=(1, 2))
            keep[0] = True
        return min(int(keep.sum()), self.na_max)

    def bucket_of(self, i) -> int:
        if not self.buckets:
            return self.na_max
        na = self.window_na(i)
        for b in self.buckets:
            if na <= b:
                return b
        return self.buckets[-1]

    def get_batch(self, indices, na=None):
        from ..scene import pad_scene_arrays

        return pad_scene_arrays([self.window_scene(i) for i in indices],
                                na if na is not None else self.na_max,
                                self.nc, device=self.device)


def load_etl_dataset(etl_dir, split, cfg, state_norm, att_norm,
                     load_lanegraph=False, device="cuda"):
    """Load preprocessed npz artifacts into a windowed dataset; the map
    store (with each map's ``dx``) and the batches on ``device``."""
    from ..maps.store import MapStore

    meta = json.load(open(os.path.join(etl_dir, "meta.json")))
    with np.load(os.path.join(etl_dir, "maps.npz")) as maps:
        raster = torch.from_numpy(maps["raster"]).to(device)
        dx = torch.from_numpy(maps["dx"]).to(device)
    store = MapStore.from_raster(raster, dx, meta["map_names"])
    lgs = None
    if load_lanegraph:
        with open(os.path.join(etl_dir, "lane_graphs.pkl"), "rb") as f:
            lgs = pickle.load(f)

    use_challenge = bool(getattr(cfg, "use_challenge_splits", False))
    if use_challenge:
        chall = meta.get("challenge_scenes")
        if not chall:
            raise ValueError(
                "--use_challenge_splits requires an ETL produced with "
                "preprocess_nuscenes.py --use_challenge_splits")
        names = sorted(chall[split])
    else:
        names = split_scene_names(
            meta["scene_names"], split, meta["version"],
            val_size=getattr(cfg, "val_size", 200),
            randomize_val=getattr(cfg, "random_val", True))
    scenes = []
    with np.load(os.path.join(etl_dir, "scenes.npz"), allow_pickle=True) as z:
        payload = z["scenes"].item()
    for name in names:
        if name in payload:
            sc = payload[name]
            if use_challenge:
                # meta["challenge_scenes"] = {split: {scene: [tokens]}}
                sc = dict(sc)
                sc["challenge_anchors"] = challenge_anchors_for_scene(
                    sc, chall[split].get(name, []))
            scenes.append(sc)

    nc = len(cfg.agent_types)
    from .loading import parse_buckets

    ds = WindowedSceneDataset(
        scenes, cfg.max_agents, nc, cfg.past_len, cfg.future_len,
        state_norm, att_norm,
        seq_interval=getattr(cfg, "seq_interval", 1),
        noise_std=getattr(cfg, "data_noise_std", 0.0),
        buckets=parse_buckets(cfg),
        challenge=use_challenge, device=device,
    )
    return ds, store, lgs, state_norm, att_norm
