"""Scenario JSON serialization — EXACT reference schema.

Copy of ``strive_tpu/data/scenario_json.py`` (numpy + json); callers pass
numpy arrays. Reference ``utils/scenario_gen.py:189-254``
(prepare_output_dict) and the readers at ``datasets/utils.py:10-38``,
``eval_planner.py:90-112``, ``eval_adv_gen.py:74-114``. Files produced
here are interchangeable with the reference's: keys N, dt, map, lw, sem,
past, fut_init, fut_adv, fut_internal_ego, fut_sol, attack_agt, attack_t,
z_adv, z_sol, z_prior{mean,var}, attack_bike_prof — all UNNORMALIZED
nested lists.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np


def prepare_output_dict(scene, map_idx, map_names, dt, state_norm, att_norm,
                        init_fut_traj, adv_fut_traj, sol_fut_traj=None,
                        attack_agt=None, attack_t=None, adv_z=None, sol_z=None,
                        prior_distrib=None, attack_bike_prof=None,
                        internal_ego_traj=None):
    """Build the output dict for ONE scene (arrays already masked to the
    real agent count).

    :param scene: dict with past_gt (NA, PT, 6) NORMALIZED, lw (NA, 2)
        NORMALIZED, sem (NA, NC)
    :param init_fut_traj, adv_fut_traj: (NA, FT, 4) NORMALIZED
    """
    unnorm_s = lambda x: np.asarray(state_norm.unnormalize(x))
    unnorm_a = lambda x: np.asarray(att_norm.unnormalize(x))

    out = {
        "N": int(init_fut_traj.shape[0]),
        "dt": float(dt),
        "map": map_names[int(map_idx)],
        "lw": unnorm_a(scene["lw"]).tolist(),
        "sem": np.asarray(scene["sem"]).tolist(),
        "past": unnorm_s(scene["past_gt"]).tolist(),
        "fut_init": unnorm_s(init_fut_traj).tolist(),
        "fut_adv": unnorm_s(adv_fut_traj).tolist(),
    }
    if internal_ego_traj is not None:
        out["fut_internal_ego"] = unnorm_s(internal_ego_traj).tolist()
    if sol_fut_traj is not None:
        out["fut_sol"] = unnorm_s(sol_fut_traj).tolist()
    if attack_agt is not None:
        out["attack_agt"] = int(attack_agt)
    if attack_t is not None:
        out["attack_t"] = int(attack_t)
    if adv_z is not None:
        out["z_adv"] = np.asarray(adv_z).tolist()
    if sol_z is not None:
        out["z_sol"] = np.asarray(sol_z).tolist()
    if prior_distrib is not None:
        out["z_prior"] = {
            "mean": np.asarray(prior_distrib[0]).tolist(),
            "var": np.asarray(prior_distrib[1]).tolist(),
        }
    if attack_bike_prof is not None:
        out["attack_bike_prof"] = np.asarray(attack_bike_prof).tolist()
    return out


def save_scenario(out_dir, name, out_dict):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(out_dict, f)
    return path


def read_adv_scenes(scene_path):
    """Load saved scenarios (reference ``datasets/utils.py:10-38``)."""
    scene_list = []
    for fpath in sorted(glob.glob(os.path.join(scene_path, "*.json"))):
        with open(fpath) as f:
            jdict = json.load(f)
        if jdict is None:
            continue
        cur = {
            "name": os.path.basename(fpath)[:-5],
            "map": jdict["map"],
            "dt": jdict["dt"],
            "veh_att": np.array(jdict["lw"], np.float32),
            "scene_past": np.array(jdict["past"], np.float32),
            "scene_fut": np.array(jdict["fut_adv"], np.float32),
        }
        if "attack_t" in jdict:
            cur["attack_t"] = jdict["attack_t"]
        if "attack_agt" in jdict:
            cur["attack_agt"] = jdict["attack_agt"]
        if "sem" in jdict:
            cur["sem"] = np.array(jdict["sem"], np.float32)
        if "fut_sol" in jdict:
            cur["scene_sol"] = np.array(jdict["fut_sol"], np.float32)
        if "fut_internal_ego" in jdict:
            cur["fut_internal_ego"] = np.array(jdict["fut_internal_ego"],
                                               np.float32)
        if "fut_init" in jdict:
            cur["scene_init"] = np.array(jdict["fut_init"], np.float32)
        if "z_prior" in jdict:
            cur["z_prior"] = {
                "mean": np.array(jdict["z_prior"]["mean"], np.float32),
                "var": np.array(jdict["z_prior"]["var"], np.float32),
            }
        if "z_adv" in jdict:
            cur["z_adv"] = np.array(jdict["z_adv"], np.float32)
        if "z_sol" in jdict:
            cur["z_sol"] = np.array(jdict["z_sol"], np.float32)
        scene_list.append(cur)
    return scene_list
