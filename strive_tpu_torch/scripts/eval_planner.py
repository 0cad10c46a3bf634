"""Evaluate the rule-based (or replay) planner on adversarial scenarios and
regular scenes, on PyTorch.

    python -m strive_tpu_torch.scripts.eval_planner -c configs/eval_planner.cfg
    python -m strive_tpu_torch.scripts.eval_planner -c CFG --device cpu

Port of ``scripts/eval_planner.py`` with the same flags, defaults, log
lines and ``all_eval_results.csv`` (reference ``eval_planner.py``):
collision rate, collision relative velocity, and comfort (fwd/lat
acceleration) metrics. The planner is the numpy ``RulePlanner``
(``planners/hardcode.py``) on the host, as in the JAX script; the data,
the map store and the trajectory interpolation are on ``--device``
(default ``cuda``; raises without a card unless ``--device cpu``).
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..data.loading import load_environment
from ..data.scenario_json import read_adv_scenes
from ..losses.metrics import check_single_veh_coll
from ..planners import PLANNER_CONFIGS, PlannerConfig, RulePlanner
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from .cluster_scenarios import interp_np
from .common import resolve_device


def parse_cfg(argv=None):
    parser = get_parser("Evaluate planner (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--val_size", type=int, default=400)
    parser.add_argument("--random_val", action="store_true", default=True)
    parser.add_argument("--seq_interval", type=int, default=10)
    parser.add_argument("--shuffle", action="store_true", default=False)
    parser.add_argument("--scenario_dir", type=str, default=None)
    parser.add_argument("--skip_regular", action="store_true", default=False)
    parser.add_argument("--filter_regular", action="store_true", default=False)
    parser.add_argument("--eval_replay_planner", action="store_true",
                        default=False)
    parser.add_argument("--max_scenes", type=int, default=None)
    parser.add_argument("--synth_scenes", type=int, default=24)
    # planner config overrides (reference eval_planner.py:66-81)
    for k, v in PLANNER_CONFIGS["default"].items():
        if isinstance(v, list):
            parser.add_argument(f"--planner_{k}", type=float, nargs="+",
                                default=v)
        elif isinstance(v, int) and not isinstance(v, bool):
            parser.add_argument(f"--planner_{k}", type=int, default=v)
        else:
            parser.add_argument(f"--planner_{k}", type=float, default=v)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def compute_metrics(planner_traj, non_ego_traj, veh_att, dt, metrics,
                    freq_cnt, freq_tot, prefix, device="cpu"):
    """Reference ``eval_planner.py:114-218``. numpy, UNNORMALIZED; the
    interpolation on ``device``."""
    interp_scale = 3
    interp_dt = dt / interp_scale
    pl_i = interp_np(np.asarray(planner_traj)[None], 3, device)[0]
    ne_i = interp_np(non_ego_traj, 3, device)

    coll_all, coll_time_all = check_single_veh_coll(
        pl_i, veh_att[0], ne_i, veh_att[1:]
    )
    did_collide = coll_all.sum() > 0
    coll_time = int(np.amin(coll_time_all))
    coll_agt = int(np.argmin(coll_time_all))
    freq_cnt[prefix + "_coll"] = freq_cnt.get(prefix + "_coll", 0) + int(did_collide)
    freq_tot[prefix + "_coll"] = freq_tot.get(prefix + "_coll", 0) + 1
    freq_cnt["total_coll"] = freq_cnt.get("total_coll", 0) + int(did_collide)
    freq_tot["total_coll"] = freq_tot.get("total_coll", 0) + 1

    seq = {"did_collide": int(did_collide)}
    coll_idx = (int((coll_time * interp_dt) / dt) if did_collide
                else planner_traj.shape[0] - 1)

    if did_collide:
        i0, i1 = (coll_idx - 1, coll_idx) if coll_idx > 0 else (coll_idx,
                                                                coll_idx + 1)
        atk_vel = (non_ego_traj[coll_agt, i1, :2]
                   - non_ego_traj[coll_agt, i0, :2]) / dt
        plan_vel = (planner_traj[i1, :2] - planner_traj[i0, :2]) / dt
        rel_s = float(np.linalg.norm(plan_vel - atk_vel))
        metrics.setdefault(prefix + "_coll_vel", []).append(rel_s)
        metrics.setdefault("total_coll_vel", []).append(rel_s)
        seq["coll_vel"] = rel_s

    pos = planner_traj[: coll_idx + 1, :2]
    head = planner_traj[: coll_idx + 1, 2:]
    if pos.shape[0] > 2:
        vel = (pos[1:] - pos[:-1]) / dt
        s = np.linalg.norm(vel, axis=-1)
        uh = head / np.linalg.norm(head, axis=-1, keepdims=True)
        vel = s[:, None] * uh[:-1]
        fwd = np.abs((s[1:] - s[:-1]) / dt)
        acc = (vel[1:] - vel[:-1]) / dt
        lat_dir = np.stack([-uh[:-2, 1], uh[:-2, 0]], -1)
        lat = np.abs(np.sum(acc * lat_dir, axis=-1))
        accn = np.linalg.norm(acc, axis=-1)
        for name, arr in (("accel", accn), ("accel_fwd", fwd),
                          ("accel_lat", lat)):
            metrics.setdefault(prefix + "_" + name, []).extend(arr.tolist())
            metrics.setdefault("total_" + name, []).extend(arr.tolist())
        seq["mean_accel"] = float(np.mean(accn))
        seq["mean_accel_fwd"] = float(np.mean(fwd))
        seq["mean_accel_lat"] = float(np.mean(lat))
    for k in ("mean_accel", "mean_accel_fwd", "mean_accel_lat", "coll_vel"):
        seq.setdefault(k, np.nan)
    return seq


def _np(x):
    return x.detach().cpu().numpy()


def main(argv=None):
    """Evaluate; returns (metrics, freq_cnt, freq_tot)."""
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    cfg.out = cfg.out + "_" + str(int(time.time()))
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "eval_planner_log.txt"))
    Logger.log("Args: " + str(vars(cfg)))
    dt = 0.5

    plan_cfg = PlannerConfig(**{
        k: getattr(cfg, f"planner_{k}") for k in PLANNER_CONFIGS["default"]
    })

    ds, store, lane_graphs, state_norm, att_norm = load_environment(
        cfg, cfg.split, load_lanegraph=True, device=device
    )
    planner = RulePlanner(lane_graphs, store.map_names, plan_cfg)

    metrics, freq_cnt, freq_tot = {}, {}, {}
    rows, names = [], []
    adv_scene_list = None

    def evaluate(prefix, init_state, veh_att, map_idx, non_ego, replay):
        NA = init_state.shape[0]
        planner.reset(init_state, veh_att, np.zeros(NA), 1, map_idx)
        FT = non_ego.shape[1]
        plan_t = np.linspace(dt, dt * FT, FT)
        if cfg.eval_replay_planner:
            ptraj = replay
        else:
            ptraj = planner.rollout(non_ego, plan_t, np.array([0, NA - 1]),
                                    plan_t)[0]
        rows.append(compute_metrics(ptraj, non_ego, veh_att, dt, metrics,
                                    freq_cnt, freq_tot, prefix, device))

    if cfg.scenario_dir is not None:
        Logger.log("Reading adversarial scenarios...")
        adv_scene_list = read_adv_scenes(cfg.scenario_dir)
        for sc in adv_scene_list:
            names.append("adv_" + sc["name"])
            evaluate("adv", sc["scene_past"][:, -1], sc["veh_att"],
                     np.array([store.map_names.index(sc["map"])]),
                     sc["scene_fut"][1:, :, :4], sc["scene_fut"][0, :, :4])

    if not cfg.skip_regular:
        filter_ids = None
        if cfg.filter_regular and adv_scene_list is not None:
            filter_ids = {int(sc["name"].split("_")[1]) for sc in
                          adv_scene_list}
        n = len(ds) if cfg.max_scenes is None else min(len(ds),
                                                       cfg.max_scenes)
        for i in range(n):
            if filter_ids is not None and i not in filter_ids:
                continue
            scene = ds.get_batch([i])
            na = int(_np(scene.mask[0]).sum())
            if na <= 1:
                continue
            names.append("regular_seq_%05d" % i)
            evaluate("regular",
                     state_norm.unnormalize(_np(scene.past_gt[0, :na, -1])),
                     att_norm.unnormalize(_np(scene.lw[0, :na])),
                     _np(scene.map_idx),
                     state_norm.unnormalize(
                         _np(scene.future_gt[0, 1:na, :, :4])),
                     state_norm.unnormalize(
                         _np(scene.future_gt[0, 0, :, :4])))

    csv_path = os.path.join(cfg.out, "all_eval_results.csv")
    with open(csv_path, "w") as f:
        w = csv.writer(f)
        keys = sorted(rows[0].keys()) if rows else []
        w.writerow(["scene"] + keys)
        for name, r in zip(names, rows):
            w.writerow([name] + [r[k] for k in keys])

    Logger.log("Final ================")
    for k, v in metrics.items():
        Logger.log("%s = %f" % (k, float(np.mean(v))))
    for k in freq_cnt:
        Logger.log("%s = %f" % (k, freq_cnt[k] / max(freq_tot[k], 1)))
    return metrics, freq_cnt, freq_tot


if __name__ == "__main__":
    main()
