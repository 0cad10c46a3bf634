"""Offline nuScenes ETL: raw data -> npz artifacts for strive_tpu_torch.

    python -m strive_tpu_torch.scripts.preprocess_nuscenes --data_dir ./data/nuscenes --version trainval

Port of ``scripts/preprocess_nuscenes.py`` with the same flags and the
same output files. Requires nuscenes-devkit (imported inside ``main``) and
the raw nuScenes download. The drivable/carpark frame filter runs on
``--device`` (default ``cuda``; raises without a card unless ``--device
cpu``). Produces, under
``{data_dir}/strive_tpu_etl/{version}/``:
  maps.npz          raster (4, C, maxH, maxW) uint8 + dx (4, 2)
  lane_graphs.pkl   map-name -> lane-graph dict
  scenes.npz        per-scene agent arrays (traj/vis/lw/sem/map_idx)
  meta.json         map_names, scene_names, version, categories

This replaces the reference's at-startup rasterization + metadata scan
(``map_env.py:79-166``, ``nuscenes_dataset.py:350-589``) with a one-time
preprocessing pass; runtime jobs just mmap the arrays.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..data.etl import (CAT2KEY, REDUCE_MAP, agent_states_with_filter,
                        challenge_split_scenes, drivable_keep_masks)
from ..maps.lanegraph import flip_lanegraph_x, process_nuscenes_lanegraph
from ..maps.store import NUSC_MAP_SIZES, ROAD_LAYERS
from .common import resolve_device


def rasterize_maps(nusc_maps, layers, pix_per_m, flip_singapore=True):
    """Reference ``map_env.py:79-166`` — road layers collapsed to channel 0,
    Singapore flipped about x, all maps zero-padded to the max size."""
    map_list = list(nusc_maps.keys())
    sizes_px, dxs = [], []
    for mname in map_list:
        msize = np.array(NUSC_MAP_SIZES[mname])
        px = np.round(msize * pix_per_m).astype(np.int32)
        dxs.append(msize / px)
        sizes_px.append(tuple(px))
    maxH = max(s[0] for s in sizes_px)
    maxW = max(s[1] for s in sizes_px)

    road = [l for l in layers if l in ROAD_LAYERS]
    other = [l for l in layers if l not in ROAD_LAYERS]
    C = (1 if road else 0) + len(other)
    raster = np.zeros((len(map_list), C, maxH, maxW), np.uint8)
    for mi, mname in enumerate(map_list):
        nmap = nusc_maps[mname]
        sz = sizes_px[mi]
        chans = []
        if road:
            img = nmap.get_map_mask(None, 0.0, road, sz)
            chans.append(np.clip(img.sum(0), 0, 1)[None].astype(np.uint8))
        if other:
            chans.append(nmap.get_map_mask(None, 0.0, other, sz).astype(np.uint8))
        img = np.concatenate(chans, axis=0)
        if flip_singapore and mname.startswith("singapore"):
            img = np.flip(img, axis=1).copy()
        raster[mi, :, : sz[0], : sz[1]] = img
    return raster, np.stack(dxs).astype(np.float32), map_list


def extract_scenes(nusc, scene2map, map_list, key2cat, categories,
                   flip_singapore=True):
    """Reference ``nuscenes_dataset.py:350-589`` minus the drivable filter
    (applied below with the raster)."""
    from pyquaternion import Quaternion

    cat2vec = {c: np.eye(len(categories), dtype=np.float32)[i]
               for i, c in enumerate(sorted(categories))}
    recs = sorted(nusc.sample,
                  key=lambda r: (nusc.get("scene", r["scene_token"])["name"],
                                 r["timestamp"]))
    raw = {}
    for rec in recs:
        scene = nusc.get("scene", rec["scene_token"])["name"]
        if scene not in scene2map:
            continue
        mname = scene2map[scene]
        mheight = NUSC_MAP_SIZES[mname][0]
        flip = flip_singapore and mname.startswith("singapore")
        sc = raw.setdefault(scene, {"ego": {"rows": [], "l": 4.084, "w": 1.73,
                                            "k": "car"}})
        sc.setdefault("_samples", []).append((rec["timestamp"], rec["token"]))
        ego = nusc.get("ego_pose", nusc.get(
            "sample_data", rec["data"]["LIDAR_TOP"])["ego_pose_token"])
        rot = Quaternion(ego["rotation"]).rotation_matrix
        h = np.arctan2(rot[1, 0], rot[0, 0])
        y = mheight - ego["translation"][1] if flip else ego["translation"][1]
        hs = -np.sin(h) if flip else np.sin(h)
        sc["ego"]["rows"].append(
            (ego["translation"][0], y, np.cos(h), hs, ego["timestamp"]))
        for ann in rec["anns"]:
            inst = nusc.get("sample_annotation", ann)
            key = ".".join(inst["category_name"].split(".")[:2])
            if key not in key2cat:
                continue
            rot = Quaternion(inst["rotation"]).rotation_matrix
            h = np.arctan2(rot[1, 0], rot[0, 0])
            y = (mheight - inst["translation"][1] if flip
                 else inst["translation"][1])
            hs = -np.sin(h) if flip else np.sin(h)
            tok = inst["instance_token"]
            a = sc.setdefault(tok, {"rows": [], "w": inst["size"][0],
                                    "l": inst["size"][1], "k": key2cat[key]})
            a["rows"].append((inst["translation"][0], y, np.cos(h), hs,
                              rec["timestamp"]))
    out = {}
    for scene, agents in raw.items():
        sample_rows = sorted(agents.pop("_samples", []))
        ego_rows = agents["ego"]["rows"]
        t_index = {r[4]: i for i, r in enumerate(ego_rows)}
        T = len(ego_rows)
        ts = np.array([r[4] * 1e-6 for r in ego_rows])
        names = ["ego"] + [k for k in agents if k != "ego"]
        xs, hhs, lws, sems, kinds = [], [], [], [], []
        for name in names:
            a = agents[name]
            x = np.full((T, 4), np.nan)
            hh = np.full((T,), np.nan)
            for r in a["rows"]:
                i = t_index[r[4]]
                x[i] = r[:4]
                hh[i] = np.arctan2(r[3], r[2])
            xs.append(x)
            hhs.append(hh)
            lws.append([a["l"], a["w"]])
            sems.append(cat2vec[a["k"]])
            kinds.append(a["k"])
        # raw (pre-filter, pre-finite-difference) arrays; states are
        # computed in finalize_scene_states AFTER the drivable filter,
        # matching the reference order (nuscenes_dataset.py:504-553)
        out[scene] = {
            "raw_x": np.stack(xs),
            "raw_h": np.stack(hhs),
            "ts": ts,
            "lw": np.array(lws, np.float32),
            "sem": np.stack(sems),
            "map_idx": map_list.index(scene2map[scene]),
            "name": scene,
            "kinds": kinds,
            # instance tokens per agent / sample tokens per timestep — the
            # addressing the prediction-challenge splits use
            # (reference nuscenes_dataset.py:494-581)
            "agent_tokens": names,
            "sample_tokens": [tok for _, tok in sample_rows],
        }
    return out


def finalize_scene_states(scenes, raster, dx, carpark_channel,
                          challenge_keep=None, device="cpu"):
    """Reference ``nuscenes_dataset.py:504-553`` in the reference ORDER:
    drop observed frames off drivable (<30% of footprint) or on carpark
    (>=30%) from the RAW positions, drop agents left with no observed
    frame (``:531``), THEN compute finite-difference states — the filter
    shapes the velocity/visibility patterns at its boundaries. Agents with
    ANY prediction-challenge frame bypass the filter entirely (``:494-505``:
    "need all frames of any vehicles that we need to make a pred for").

    :param challenge_keep: optional {scene: (NAg,) bool} challenge agents
    :param device: where the filter reads the raster
    """
    drivable = torch.from_numpy(raster[:, 0]).to(device)
    carpark = (torch.from_numpy(raster[:, carpark_channel]).to(device)
               if carpark_channel is not None else None)
    out = {}
    for name, sc in scenes.items():
        NAg = sc["raw_x"].shape[0]
        ckeep = (challenge_keep or {}).get(sc["name"],
                                           np.zeros(NAg, bool))
        # ego and challenge agents are never filtered; the others' masks
        # in one pass over the scene
        filtered = [a for a in range(1, NAg)
                    if not (a < len(ckeep) and ckeep[a])]
        masks = dict(zip(filtered, drivable_keep_masks(
            sc["raw_x"][filtered], sc["lw"][filtered], sc["map_idx"],
            drivable, dx, carpark=carpark))) if filtered else {}
        trajs, viss, rows = [], [], []
        for a in range(NAg):
            x, hh = sc["raw_x"][a], sc["raw_h"][a]
            st = agent_states_with_filter(x, hh, sc["ts"], masks.get(a))
            if st is None:
                continue  # never on drivable surface -> dropped
            traj, _accel, vis = st
            trajs.append(traj)
            viss.append(vis)
            rows.append(a)
        rows = np.asarray(rows)
        out[name] = {
            "traj": np.stack(trajs).astype(np.float32),
            "vis": np.stack(viss).astype(np.float32),
            "lw": sc["lw"][rows],
            "sem": sc["sem"][rows],
            "map_idx": sc["map_idx"],
            "name": sc["name"],
            "kinds": [sc["kinds"][a] for a in rows],
            "agent_tokens": [sc["agent_tokens"][a] for a in rows],
            "sample_tokens": sc["sample_tokens"],
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--version", default="trainval", choices=["trainval", "mini"])
    ap.add_argument("--pix_per_m", type=float, default=4.0)
    ap.add_argument("--agent_types", nargs="+", default=["car", "truck"])
    ap.add_argument("--reduce_cats", action="store_true")
    ap.add_argument("--layers", nargs="+",
                    default=["drivable_area", "carpark_area", "road_divider",
                             "lane_divider"])
    ap.add_argument("--use_challenge_splits", action="store_true",
                    default=False,
                    help="record nuScenes prediction-challenge split "
                         "membership + anchors (reference "
                         "nuscenes_dataset.py:35-62,332-341)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from nuscenes.nuscenes import NuScenes
    from nuscenes.map_expansion.map_api import NuScenesMap

    data_path = os.path.join(args.data_dir, args.version)
    out_dir = os.path.join(args.data_dir, "strive_tpu_etl", args.version)
    os.makedirs(out_dir, exist_ok=True)

    print("Loading maps + rasterizing...")
    nusc_maps = {m: NuScenesMap(dataroot=data_path, map_name=m)
                 for m in NUSC_MAP_SIZES}
    raster, dx, map_list = rasterize_maps(nusc_maps, args.layers,
                                          args.pix_per_m)
    np.savez_compressed(os.path.join(out_dir, "maps.npz"), raster=raster, dx=dx)

    print("Building lane graphs...")
    lgs = {}
    for m, nmap in nusc_maps.items():
        lg = process_nuscenes_lanegraph(nmap)
        if m.startswith("singapore"):
            lg = flip_lanegraph_x(lg, NUSC_MAP_SIZES[m][0])
        lgs[m] = lg
    with open(os.path.join(out_dir, "lane_graphs.pkl"), "wb") as f:
        pickle.dump(lgs, f)

    print("Extracting scene trajectories...")
    nusc = NuScenes(version=f"v1.0-{args.version}", dataroot=data_path,
                    verbose=False)
    key2cat = {}
    for cat in args.agent_types:
        for k in CAT2KEY[cat]:
            key2cat[k] = cat
    categories = list(args.agent_types)
    if args.reduce_cats:
        key2cat = {k: REDUCE_MAP[k] for k in key2cat}
        categories = sorted(set(key2cat.values()))
    scene2map = {}
    for rec in nusc.scene:
        log = nusc.get("log", rec["log_token"])
        scene2map[rec["name"]] = log["location"]

    scenes = extract_scenes(nusc, scene2map, map_list, key2cat, categories)

    challenge_scenes = None
    challenge_keep = None
    if args.use_challenge_splits:
        from nuscenes.utils.splits import create_splits_scenes

        pred_path = os.path.join(data_path, "maps", "prediction",
                                 "prediction_scenes.json")
        with open(pred_path) as f:
            prediction_scenes = json.load(f)
        official = create_splits_scenes()
        challenge_scenes = {
            split: challenge_split_scenes(prediction_scenes,
                                          official["train"], official["val"],
                                          split)
            for split in ("train", "val", "test")
        }
        # agents with challenge frames bypass the drivable filter
        challenge_keep = {}
        all_tokens = {}
        for split_map in challenge_scenes.values():
            for sname, toks in split_map.items():
                all_tokens.setdefault(sname, []).extend(toks)
        for sname, toks in all_tokens.items():
            if sname not in scenes:
                continue
            sc = scenes[sname]
            keep = np.zeros(len(sc["agent_tokens"]), bool)
            tok2agent = {t: i for i, t in enumerate(sc["agent_tokens"])}
            for inst_samp in toks:
                inst = inst_samp.rsplit("_", 1)[0]
                if inst in tok2agent:
                    keep[tok2agent[inst]] = True
            challenge_keep[sname] = keep

    carpark_chan = (1 + [l for l in args.layers if l not in ROAD_LAYERS]
                    .index("carpark_area")
                    if "carpark_area" in args.layers else None)
    scenes = finalize_scene_states(scenes, raster, dx, carpark_chan,
                                   challenge_keep=challenge_keep,
                                   device=device)

    np.savez_compressed(os.path.join(out_dir, "scenes.npz"),
                        scenes=np.array(scenes, dtype=object))
    meta = {"map_names": map_list,
            "scene_names": sorted(scenes.keys()),
            "version": args.version,
            "categories": categories}
    if challenge_scenes is not None:
        meta["challenge_scenes"] = {
            split: {s: toks for s, toks in m.items() if s in scenes}
            for split, m in challenge_scenes.items()}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"Wrote ETL artifacts to {out_dir}")


if __name__ == "__main__":
    main()
