"""Cluster generated collision scenarios by collision geometry, on PyTorch.

    python -m strive_tpu_torch.scripts.cluster_scenarios --scenario_dirs DIR [DIR ...] --k 10
    python -m strive_tpu_torch.scripts.cluster_scenarios --scenario_dirs DIR --device cpu

Port of ``scripts/cluster_scenarios.py`` with the same flags, log lines
and output files (reference ``cluster_scenarios.py``): feature = [unit
collision-direction vector in the planner frame, attacker heading vector
in the planner frame] at the interpolated first-collision time; k-means
(k=10); polar scatter plot; ``cluster.pkl`` and ``cluster_labels.txt``.

- ``--device`` defaults to ``cuda`` and raises without a card; the CPU
  runs only when asked for (``--device cpu``). The trajectory
  interpolation, frame transforms and k-means run there.
- sklearn's ``KMeans(random_state=0, n_init=10)`` becomes
  ``strive_tpu_torch.kmeans.fit`` (k-means++ seeded from a CPU generator
  seeded 0, 10 seedings, sklearn's Lloyd stopping rule); ``cluster.pkl``
  holds its ``KMeansResult``, read back without sklearn.
- The scatter plot (``cluster_k<k>.jpg``) needs matplotlib; without it the
  log says so and the rest is written.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from .. import kmeans
from ..data.scenario_json import read_adv_scenes
from ..geometry import interp_traj, transform2frame
from ..losses.metrics import check_single_veh_coll
from ..utils.config import get_parser
from ..utils.logger import Logger, mkdir
from ..viz import have_matplotlib
from .common import resolve_device


def parse_cfg(argv=None):
    parser = get_parser("Cluster scenarios (PyTorch)")
    parser.add_argument("--out", type=str, default="./out/cluster_out")
    parser.add_argument("--scenario_dirs", type=str, nargs="+", required=True)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--viz", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def interp_np(traj, scale, device="cpu"):
    """``geometry.interp_traj`` of a float32 numpy trajectory batch on
    ``device``; :return: numpy."""
    t = torch.from_numpy(np.asarray(traj, np.float32)).to(device)
    return interp_traj(t, scale).cpu().numpy()


def compute_coll_feat(lw, scene_traj, dt, device="cpu"):
    """Reference ``cluster_scenarios.py:76-117``; returns None if the
    scenario contains no collision."""
    planner = scene_traj[0, :, :4]
    others = scene_traj[1:, :, :4]
    interp_scale = 5
    pl_i = interp_np(planner[None], interp_scale, device)[0]
    ot_i = interp_np(others, interp_scale, device)
    coll, coll_t = check_single_veh_coll(pl_i, lw[0], ot_i, lw[1:])
    if coll.sum() == 0:
        return None
    coll_t = coll_t[coll]
    plan_states = pl_i[coll_t]            # (NC, 4)
    atk_states = ot_i[coll, coll_t]       # (NC, 4)
    first = int(np.argmin(coll_t))
    local = transform2frame(
        torch.from_numpy(plan_states).to(device),
        torch.from_numpy(atk_states).to(device)[:, None],
    ).cpu().numpy()[first, 0]
    hvec = [float(local[2]), float(local[3])]
    pos = local[:2] / max(np.linalg.norm(local[:2]), 1e-9)
    return {"hvec": hvec, "angvec": pos.tolist()}


def semantic_cluster_name(center):
    """Human-readable collision-type name for one k-means center.

    The reference hand-labels its 10 clusters
    (``data/clustering/cluster_labels.txt``: 'Merge from Right, Head On,
    Behind, Cutoff Left & Front, T-Bone Left, ...'); names of the same
    vocabulary come from the center's geometry. The 4-D feature is
    [angvec (unit planner->attacker direction at collision, planner frame),
    hvec (attacker heading, planner frame)] (``cluster_scenarios.py:76-117``;
    planner frame: +x forward, +y left).
    """
    ax, ay, hx, hy = [float(v) for v in center]
    a = np.degrees(np.arctan2(ay, ax))    # where the attacker hits from
    h = np.degrees(np.arctan2(hy, hx))    # attacker heading vs planner's
    side = "Left" if ay > 0 else "Right"
    if abs(a) <= 45.0:          # impact at the front
        if abs(h) >= 135.0:
            return "Head On"
        if abs(h) <= 45.0:
            return "Cutoff " + side + " & Front"
        return "Front from " + side
    if abs(a) >= 135.0:         # impact from behind
        return "Behind"
    # impact on the flank
    if abs(h) <= 45.0:
        return "Merge from " + side
    return "T-Bone " + side


def write_cluster_labels(clustering, out_dir):
    """Auto-derived semantic names, one per cluster, comma-separated —
    consumable by ``eval_adv_gen --cluster_labels`` (same format as the
    reference's hand-written ``cluster_labels.txt``). Duplicate names get
    a numeric suffix so the label set stays unambiguous."""
    names = [semantic_cluster_name(c) for c in clustering.cluster_centers_]
    seen = {}
    for i, n in enumerate(names):
        seen[n] = seen.get(n, 0) + 1
        if seen[n] > 1:
            names[i] = f"{n} ({seen[n]})"
    path = os.path.join(out_dir, "cluster_labels.txt")
    with open(path, "w") as f:
        f.write(", ".join(names))
    return path, names


def plot_clusters(angvec, hvec, labels, out_path):
    """Polar scatter of the two feature halves, one colour a cluster."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(10, 5))
    th = np.linspace(0, 2 * np.pi, 100)
    for ax, title in zip(axs, ("collision direction", "adversary heading")):
        ax.plot(np.cos(th), np.sin(th), "--b", alpha=0.15)
        ax.set_title(title)
        ax.axis("equal")
    for ki in np.unique(labels):
        axs[0].plot(angvec[labels == ki, 0], angvec[labels == ki, 1], "o",
                    markersize=4)
        axs[1].plot(hvec[labels == ki, 0], hvec[labels == ki, 1], "o",
                    markersize=4)
    plt.savefig(out_path)
    plt.close(fig)


def main(argv=None):
    """Cluster; returns the ``KMeansResult`` (None without collisions)."""
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    cfg.out = cfg.out + "_" + str(int(time.time()))
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "cluster_log.txt"))

    scenes = []
    for d in cfg.scenario_dirs:
        scenes += read_adv_scenes(d)
    Logger.log(f"Loaded {len(scenes)} scenarios")

    feats, names = [], []
    for si, sc in enumerate(scenes):
        f = compute_coll_feat(np.asarray(sc["veh_att"]),
                              np.asarray(sc["scene_fut"]), sc["dt"], device)
        if f is None:
            Logger.log(f"{sc['name']}: no collision, skipping")
            continue
        feats.append(f)
        names.append("%04d_%s" % (si, sc["name"]))

    if len(feats) < cfg.k:
        Logger.log(f"Only {len(feats)} collision scenarios; need >= k={cfg.k}")
        if not feats:
            return None

    angvec = np.array([f["angvec"] for f in feats])
    hvec = np.array([f["hvec"] for f in feats])
    X = np.concatenate([angvec, hvec], axis=1)

    k = min(cfg.k, len(feats))
    clustering = kmeans.fit(X, k, n_init=10, seed=0, device=device)
    labels = clustering.labels_
    with open(os.path.join(cfg.out, "cluster.pkl"), "wb") as f:
        pickle.dump(clustering, f)
    labels_path, label_names = write_cluster_labels(clustering, cfg.out)
    Logger.log("cluster labels: " + ", ".join(label_names)
               + " -> " + labels_path)

    plot_path = os.path.join(cfg.out, "cluster_k%d.jpg" % k)
    if have_matplotlib():
        plot_clusters(angvec, hvec, labels, plot_path)
    else:
        Logger.log("matplotlib is not installed: no " + plot_path)
    Logger.log(f"Clustered {len(feats)} scenarios into {k} groups -> "
               f"{cfg.out}")
    return clustering


if __name__ == "__main__":
    main()
