"""Quantitative + qualitative evaluation of generated adversarial scenarios,
on PyTorch.

    python -m strive_tpu_torch.scripts.eval_adv_gen -c CFG --scenario_root DIR --eval_quant
    python -m strive_tpu_torch.scripts.eval_adv_gen -c CFG --scenario_root DIR --eval_quant --device cpu

Port of ``scripts/eval_adv_gen.py`` with the same flags, log lines and
outputs (reference ``eval_adv_gen.py``). Quant: per-scenario and
aggregate metrics over the result-taxonomy dirs — success rates, collision
geometry/velocity, pre-crash plausibility (vehicle/env collision rates
among non-ego agents), latent log-likelihoods under the saved prior,
solution kinematics (``per_seq_results.csv``, ``total_results.csv``);
optional cluster labels from a ``cluster.pkl``. Qual: re-render scenarios
at 8 px/m.

- ``--device`` defaults to ``cuda`` and raises without a card; the CPU
  runs only when asked for (``--device cpu``). The map store, the
  environment-collision checks (``check_on_layer``), the interpolation
  and the log-likelihoods run there.
- A ``cluster.pkl`` is read with ``pickle``: the port's ``KMeansResult``
  (``scripts/cluster_scenarios.py``) or sklearn's ``KMeans`` where sklearn
  is installed; the label of a scenario is its nearest center, ties to the
  first (``kmeans.predict``), as sklearn's ``predict``.
- The distribution chart (``scenario_distrib.png``) and ``--eval_qual``
  need matplotlib; without it the log says so for the chart.
"""

from __future__ import annotations

import csv
import os
import pickle
import time

import numpy as np
import torch

from .. import kmeans
from ..data.loading import load_environment
from ..data.scenario_json import read_adv_scenes
from ..losses.common import log_normal
from ..losses.metrics import check_pairwise_veh_coll, check_single_veh_coll
from ..losses.training import compute_coll_rate_env_from_traj
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from ..viz import get_adv_coloring, have_matplotlib, render_scene
from .cluster_scenarios import compute_coll_feat, interp_np
from .common import resolve_device

# canonical metric names (reference utils/scenario_gen.py:110-118); every
# entry here is computed by scenario_metrics when its inputs are present
METRIC_NAMES = [
    "planner_coll_atk", "planner_coll_others", "adv_success",
    "planner_coll_h", "planner_coll_ang", "planner_coll_env",
    "veh_coll_rate", "env_coll_atk", "env_coll_others",
    "match_ext_pos", "match_ext_ang",
    "z_ll_atk", "z_ll_others", "z_ll_internal",
    "init_pos_diff_atk", "init_pos_diff_others",
    "sol_coll_others", "sol_coll_env", "sol_success", "sol_z_ll",
    "sol_vel_mean", "sol_vel_max", "sol_acc_mean", "sol_acc_max",
    "sol_hdot_mean", "sol_hdot_max",
]


def parse_cfg(argv=None):
    parser = get_parser("Evaluate adversarial scenario generation (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--scenario_root", type=str, required=True,
                        help="dir containing adv_sol_success/sol_failed/"
                             "adv_failed subdirs")
    parser.add_argument("--eval_quant", action="store_true", default=False)
    parser.add_argument("--eval_qual", action="store_true", default=False)
    parser.add_argument("--cluster_pkl", type=str, default=None)
    parser.add_argument("--cluster_labels", type=str, default=None,
                        help="txt file with comma-separated semantic names "
                             "for each cluster (reference "
                             "eval_adv_gen.py:45 / "
                             "data/clustering/cluster_labels.txt); defaults "
                             "to 'cluster <idx>' names")
    parser.add_argument("--synth_scenes", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def load_cluster_labels(path, n_clusters):
    """Semantic cluster names from a comma-separated txt file (reference
    ``eval_adv_gen.py:45,208-233``); falls back to 'cluster <i>'."""
    if path:
        with open(path) as f:
            names = [s.strip() for s in f.read().split(",") if s.strip()]
        if len(names) != n_clusters:
            raise SystemExit(
                f"--cluster_labels has {len(names)} names but the "
                f"clustering has {n_clusters} clusters")
        return names
    return [f"cluster {i}" for i in range(n_clusters)]


def plot_scenario_distrib(n_clusters, cluster_labels, label_idx_by_taxonomy,
                          out_path):
    """Horizontal bar chart of collision-type counts, adv_sol_success vs
    sol_failed side by side per cluster (reference
    ``eval_adv_gen.py:170-206`` plot_scenario_distrib: clusters sorted by
    label name, 'Solution Found' orange / 'No Solution' red)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.array(cluster_labels)
    sort_inds = np.argsort(labels)
    labels = labels[sort_inds]

    fig = plt.figure(dpi=200)
    ax = plt.gca()
    ax.xaxis.get_major_locator().set_params(integer=True)
    counts = []
    for t in ("adv_sol_success", "sol_failed"):
        cur = np.asarray(label_idx_by_taxonomy.get(t, []), dtype=int)
        c = np.array([np.sum(cur == li) for li in range(n_clusters)])
        counts.append(c[sort_inds])
    y_pos = np.arange(n_clusters)
    y_off = np.linspace(-0.2, 0.2, len(counts))[::-1]
    w = abs(y_off[1] - y_off[0])  # bar height; y_off is descending
    for c, off, color, name in zip(counts, y_off, ("orange", "red"),
                                   ("Solution Found", "No Solution")):
        plt.barh(y_pos + off, c, w, color=color, align="center", label=name)
    plt.yticks(y_pos, tuple(labels))
    plt.legend()
    plt.xlabel("Count")
    plt.title("Collision Scenario Distribution")
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)


def _log_normal(x, m, v, device):
    """``losses.common.log_normal`` of float32 numpy inputs on ``device``."""
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
         for a in (x, m, v)]
    return log_normal(*t).cpu().numpy()


def scenario_metrics(sc, dt, store=None, map_idx=0, device="cpu"):
    """Per-scenario quant metrics from a saved JSON dict.

    Mirrors reference ``eval_adv_gen.py:339-513`` (compute_metrics):
    the effective attacker is the agent that ACTUALLY collides when a
    collision happened (``:371-378``), else the saved ``attack_agt``; the
    pre-crash window CT gates plausibility metrics. ``store`` enables the
    env-collision metrics (``:404-419``); the interpolation and the
    log-likelihoods run on ``device``.
    """
    m = {}
    fut = np.asarray(sc["scene_fut"])  # (NA, FT, >=4)
    lw = np.asarray(sc["veh_att"])
    NA, FT = fut.shape[:2]
    plan = fut[0, :, :4]
    others = fut[1:, :, :4]

    pl_i = interp_np(plan[None], 3, device)[0]
    ot_i = interp_np(others, 3, device)
    coll, coll_t = check_single_veh_coll(pl_i, lw[0], ot_i, lw[1:])
    did_collide = bool(coll.any())
    # effective attacker: the colliding agent when there is a collision
    # (reference :371-378); the saved attack_agt (the most-controlled
    # agent) otherwise. Dense index into the full scene, ego = 0.
    saved_atk = sc.get("attack_agt")
    if did_collide:
        atk = int(np.argmin(coll_t)) + 1
        t = int(coll_t[atk - 1])
        crash_idx = int(t / 3)
    else:
        atk = int(saved_atk) if saved_atk is not None else None
        crash_idx = FT - 1
    have_atk = atk is not None and 1 <= atk <= NA - 1

    m["planner_coll_atk"] = (float(coll[atk - 1]) if have_atk
                             else float(did_collide))
    m["planner_coll_others"] = float(
        (coll.sum() - (coll[atk - 1] if have_atk else 0)) > 0)
    m["adv_success"] = m["planner_coll_atk"]

    if did_collide:
        atk_h = ot_i[atk - 1, t, 2:4]
        pl_h = pl_i[t, 2:4]
        cosang = np.clip(np.dot(atk_h, pl_h), -1, 1)
        m["planner_coll_h"] = float(np.degrees(np.arccos(cosang)))
        d = ot_i[atk - 1, t, :2] - pl_i[t, :2]
        d = d / max(np.linalg.norm(d), 1e-9)
        m["planner_coll_ang"] = float(np.degrees(np.arctan2(d[1], d[0])))

    # plausibility: collisions among non-ego agents BEFORE the crash
    if NA > 2 and crash_idx > 0:
        res = check_pairwise_veh_coll(others[:, :crash_idx + 1], lw[1:])
        m["veh_coll_rate"] = res["num_coll_veh"] / max(res["num_traj_veh"], 1)

    # env collisions pre-crash for planner / attacker / others (ref :404-419)
    if store is not None and crash_idx > 0:
        env_coll = compute_coll_rate_env_from_traj(
            fut[:, :crash_idx + 1, :4], lw, store, map_idx)
        m["planner_coll_env"] = float(env_coll[0])
        if have_atk:
            m["env_coll_atk"] = float(env_coll[atk])
            if NA > 2:
                m["env_coll_others"] = float(
                    np.mean(np.delete(env_coll[1:], atk - 1)))
        else:
            m["env_coll_others"] = float(np.mean(env_coll[1:])) if NA > 1 \
                else np.nan

    # planner-match accuracy: internal ego prediction vs TRUE planner up to
    # the crash (reference :494-513)
    if "fut_internal_ego" in sc and crash_idx > 0:
        pred = np.asarray(sc["fut_internal_ego"])[:FT, :4]
        ct = min(crash_idx + 1, pred.shape[0])
        pos_err = np.linalg.norm(plan[:ct, :2] - pred[:ct, :2], axis=-1)
        m["match_ext_pos"] = float(pos_err.mean())
        gt_h = plan[:ct, 2:4] / np.maximum(
            np.linalg.norm(plan[:ct, 2:4], axis=-1, keepdims=True), 1e-9)
        pr_h = pred[:ct, 2:4] / np.maximum(
            np.linalg.norm(pred[:ct, 2:4], axis=-1, keepdims=True), 1e-9)
        cosang = np.clip(np.sum(gt_h * pr_h, axis=-1), -1, 1)
        m["match_ext_ang"] = float(np.degrees(np.arccos(cosang)).mean())

    # how far the optimization moved agents from their initial futures
    if "scene_init" in sc:
        init = np.asarray(sc["scene_init"])[:, :FT, :4]
        diff = np.linalg.norm(fut[:, :init.shape[1], :2] - init[:, :, :2],
                              axis=-1).mean(axis=-1)  # (NA,)
        if have_atk:
            m["init_pos_diff_atk"] = float(diff[atk])
            if NA > 2:
                m["init_pos_diff_others"] = float(
                    np.mean(np.delete(diff[1:], atk - 1)))
        elif NA > 1:
            m["init_pos_diff_others"] = float(np.mean(diff[1:]))

    # latent likelihoods under the saved prior
    if "z_adv" in sc and "z_prior" in sc:
        z = np.asarray(sc["z_adv"])
        mu = sc["z_prior"]["mean"]
        var = sc["z_prior"]["var"]
        ll = _log_normal(z, mu, var, device)
        m["z_ll_internal"] = float(ll[0])
        if have_atk:
            m["z_ll_atk"] = float(ll[atk])
            m["z_ll_others"] = float(np.mean(np.delete(ll[1:], atk - 1))) \
                if NA > 2 else np.nan
        else:
            m["z_ll_others"] = float(np.mean(ll[1:])) if NA > 1 else np.nan

    # solution metrics
    if "scene_sol" in sc:
        sol = np.asarray(sc["scene_sol"])[0, :, :4]
        sol_i = interp_np(sol[None], 3, device)[0]
        scoll, _ = check_single_veh_coll(sol_i, lw[0], ot_i, lw[1:])
        m["sol_coll_others"] = float(scoll.any())
        m["sol_success"] = float(~scoll.any())
        if store is not None:
            sol_env = compute_coll_rate_env_from_traj(
                sol[None], lw[0:1], store, map_idx)
            m["sol_coll_env"] = float(sol_env[0])
        if "z_sol" in sc and "z_prior" in sc:
            zs = np.asarray(sc["z_sol"])
            lls = _log_normal(zs[0:1], np.asarray(sc["z_prior"]["mean"])[0:1],
                              np.asarray(sc["z_prior"]["var"])[0:1], device)
            m["sol_z_ll"] = float(lls[0])
        vel = np.linalg.norm(np.diff(sol[:, :2], axis=0), axis=-1) / dt
        acc = np.abs(np.diff(vel)) / dt
        m["sol_vel_mean"] = float(vel.mean())
        m["sol_vel_max"] = float(vel.max())
        if len(acc):
            m["sol_acc_mean"] = float(acc.mean())
            m["sol_acc_max"] = float(acc.max())
        # heading-rate comfort (reference sol_hdot_* in METRIC_NAMES)
        h = sol[:, 2:4] / np.maximum(
            np.linalg.norm(sol[:, 2:4], axis=-1, keepdims=True), 1e-9)
        ang = np.unwrap(np.arctan2(h[:, 1], h[:, 0]))
        hdot = np.abs(np.diff(ang)) / dt
        if len(hdot):
            m["sol_hdot_mean"] = float(hdot.mean())
            m["sol_hdot_max"] = float(hdot.max())
    return m


def main(argv=None):
    """Evaluate; returns {taxonomy: [scenario dicts]}."""
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    cfg.out = cfg.out + "_" + str(int(time.time()))
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "eval_adv_gen_log.txt"))

    taxonomy = ["adv_sol_success", "sol_failed", "adv_failed"]
    all_scenes = {}
    for t in taxonomy:
        d = os.path.join(cfg.scenario_root, t)
        all_scenes[t] = read_adv_scenes(d) if os.path.isdir(d) else []
        Logger.log(f"{t}: {len(all_scenes[t])} scenarios")

    n_total = sum(len(v) for v in all_scenes.values())
    n_adv = len(all_scenes["adv_sol_success"]) + len(all_scenes["sol_failed"])
    n_sol = len(all_scenes["adv_sol_success"])
    Logger.log("adv success rate = %f" % (n_adv / max(n_total, 1)))
    Logger.log("sol success rate (of adv successes) = %f"
               % (n_sol / max(n_adv, 1)))

    clustering, cluster_names = None, None
    if cfg.cluster_pkl:
        with open(cfg.cluster_pkl, "rb") as f:
            clustering = pickle.load(f)
        cluster_names = load_cluster_labels(
            cfg.cluster_labels, int(clustering.n_clusters))

    store = None
    if cfg.eval_quant or cfg.eval_qual:
        # 8 px/m for qualitative re-rendering (reference eval_adv_gen.py:683)
        _, store, _, _, _ = load_environment(
            cfg, "val", pix_per_m=8.0 if cfg.eval_qual else None,
            device=device)

    if cfg.eval_quant:
        rows, names = [], []
        label_idx_by_taxonomy = {}
        for t in taxonomy:
            for sc in all_scenes[t]:
                map_idx = (store.map_names.index(sc["map"])
                           if sc["map"] in store.map_names else 0)
                m = scenario_metrics(sc, sc.get("dt", 0.5), store=store,
                                     map_idx=map_idx, device=device)
                m["taxonomy"] = t
                if clustering is not None:
                    f = compute_coll_feat(np.asarray(sc["veh_att"]),
                                          np.asarray(sc["scene_fut"]),
                                          sc.get("dt", 0.5), device)
                    if f is not None:
                        X = np.array(f["angvec"] + f["hvec"])[None]
                        li = int(kmeans.predict(clustering.cluster_centers_,
                                                X)[0])
                        m["cluster_label"] = li
                        # semantic label name in the per-seq CSV
                        # (reference :208-233 assign_cluster)
                        m["cluster_name"] = cluster_names[li]
                        label_idx_by_taxonomy.setdefault(t, []).append(li)
                rows.append(m)
                names.append(f"{t}/{sc['name']}")
        if clustering is not None and (
                label_idx_by_taxonomy.get("adv_sol_success")
                or label_idx_by_taxonomy.get("sol_failed")):
            plot_path = os.path.join(cfg.out, "scenario_distrib.png")
            if have_matplotlib():
                plot_scenario_distrib(int(clustering.n_clusters),
                                      cluster_names, label_idx_by_taxonomy,
                                      plot_path)
                Logger.log("wrote " + plot_path)
            else:
                Logger.log("matplotlib is not installed: no " + plot_path)
        csv_path = os.path.join(cfg.out, "per_seq_results.csv")
        keys = sorted({k for r in rows for k in r})
        with open(csv_path, "w") as f:
            w = csv.writer(f)
            w.writerow(["scene"] + keys)
            for name, r in zip(names, rows):
                w.writerow([name] + [r.get(k, np.nan) for k in keys])
        Logger.log("==== aggregate quant metrics ====")
        agg = {}
        for r in rows:
            for k, v in r.items():
                if isinstance(v, float) and not np.isnan(v):
                    agg.setdefault(k, []).append(v)
        with open(os.path.join(cfg.out, "total_results.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow(["metric", "mean", "count"])
            for k in sorted(agg):
                Logger.log("%s = %f (n=%d)" % (k, np.mean(agg[k]),
                                               len(agg[k])))
                w.writerow([k, np.mean(agg[k]), len(agg[k])])

    if cfg.eval_qual:
        for t in taxonomy:
            for sc in all_scenes[t]:
                map_idx = (store.map_names.index(sc["map"])
                           if sc["map"] in store.map_names else 0)
                NA = sc["scene_past"].shape[0]
                render_scene(
                    os.path.join(cfg.out, "qual", t, sc["name"] + ".jpg"),
                    store, map_idx, sc["scene_past"],
                    sc["scene_fut"][:, :, :4], sc["veh_att"],
                    np.ones(NA, bool),
                    car_colors=get_adv_coloring(NA, sc.get("attack_agt"), 0),
                    title=f"{t}/{sc['name']}",
                )
    return all_scenes


if __name__ == "__main__":
    main()
