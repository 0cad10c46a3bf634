"""Re-ingest saved adversarial scenarios as training data.

Port of reference ``nuscenes_dataset.py:231-290`` (compile_scenarios): load
scenario JSONs, recompute future velocities/heading rates by finite
differences, and expose them as extra scenes appended to the training set
(the reference's ``--scenario_dir`` training flag).

Copy of ``strive_tpu/data/scenario_ingest.py`` (numpy).
"""

from __future__ import annotations

import numpy as np

from .etl import heading_change_rate, velocity
from .scenario_json import read_adv_scenes


def scenarios_as_scenes(scenario_path, map_names, nc, cat_index=None):
    """Scenario JSONs -> per-scene dicts compatible with
    WindowedSceneDataset.scenes (traj (NAg, T, 6) with NaNs, vis, lw, sem,
    map_idx, name). Agent 0 stays the ego/planner slot.
    """
    out = []
    for sc in read_adv_scenes(scenario_path):
        past = np.asarray(sc["scene_past"], np.float32)   # (NA, PT, 6)
        fut4 = np.asarray(sc["scene_fut"], np.float32)[..., :4]
        NA, FT = fut4.shape[:2]
        dt = float(sc["dt"])
        # recompute future velocities/hdot incl. the handoff frame
        fut_traj = np.concatenate([past[:, -1:, :4], fut4], axis=1)
        t = np.arange(fut_traj.shape[1]) * dt
        fut6 = np.empty((NA, FT, 6), np.float32)
        for a in range(NA):
            vel = velocity(fut_traj[a, :, :2], t)[1:]
            s = np.linalg.norm(vel, axis=1)
            h = np.arctan2(fut_traj[a, :, 3], fut_traj[a, :, 2])
            hdot = heading_change_rate(h, t)[1:]
            fut6[a] = np.concatenate(
                [fut4[a], s[:, None], hdot[:, None]], axis=1
            )
        traj = np.concatenate([past, fut6], axis=1)  # (NA, PT+FT, 6)
        vis = (~np.isnan(traj).any(axis=-1)).astype(np.float32)

        if "sem" in sc:
            sem = np.asarray(sc["sem"], np.float32)
        else:
            sem = np.zeros((NA, nc), np.float32)
            sem[:, cat_index if cat_index is not None else 0] = 1.0

        map_idx = map_names.index(sc["map"]) if sc["map"] in map_names else 0
        out.append({
            "traj": traj, "vis": vis,
            "lw": np.asarray(sc["veh_att"], np.float32),
            "sem": sem, "map_idx": map_idx, "name": sc["name"],
        })
    return out
