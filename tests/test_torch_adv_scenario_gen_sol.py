"""The solution branch of the scenario-generation pipeline, whole, against
strive_tpu's.

With random weights no scene becomes an adversarial success in a few
iterations, so tests/test_torch_adv_scenario_gen.py never reaches the
solution optimization. Here ``compute_adv_gen_success`` is replaced by
one that always succeeds, in both packages' entry points, so every batch
runs the solution optimization, the solution check and the saving of
``fut_sol`` / ``z_sol``: ``configs/adv_gen_synthetic.cfg`` with
``--num_iters 2 --num_samples 4 --synth_scenes 4 --max_scenes 4``, the
port with strive_tpu's initial weights and prior noise, as in
tests/test_torch_adv_scenario_gen.py.

Must match: the stats (``sol_success`` included), the folders
(``adv_sol_success`` / ``sol_failed``), ``attack_agt`` and ``attack_t``
exactly; every file carries ``fut_sol`` and ``z_sol`` and loads through
``strive_tpu.data.scenario_json.read_adv_scenes``. Trajectories and
latents are held at the same measured bounds as there (1.1 m, 2.7; the
fits amplify float noise, ROADMAP §3).
"""

import os

import numpy as np
import jax
import pytest

import torch_helpers  # noqa: F401  (sets the torch thread count)
from strive_tpu.data.scenario_json import read_adv_scenes
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.utils.convert import params_from_flax
from test_torch_adv_scenario_gen import (COMMON, FOLDERS, LATENT_TOL,
                                         TRAJ_TOL_M, _jax_noise_stream,
                                         _scenes, jgen)

CFG = "configs/adv_gen_synthetic.cfg"


def _always(*a, **k):
    return True, None, None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sol")
    jout, tout = str(tmp / "jax"), str(tmp / "port")
    params = {}
    mp = pytest.MonkeyPatch()
    try:
        real_init = jgen.init_model_params

        def capture(*a, **k):
            params["flax"] = real_init(*a, **k)
            return params["flax"]

        mp.setattr(jgen, "init_model_params", capture)
        mp.setattr(jgen, "compute_adv_gen_success", _always)
        jstats = jgen.main(["-c", CFG, "--out", jout] + COMMON)

        def jax_weights(model):
            model.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, params["flax"])))

        mp.setattr(tgen, "init_params", jax_weights)
        mp.setattr(tgen, "prior_noise", _jax_noise_stream())
        mp.setattr(tgen, "compute_adv_gen_success", _always)
        tstats = tgen.main(["-c", CFG, "--out", tout, "--device", "cpu"]
                           + COMMON)
    finally:
        mp.undo()
    return jout, tout, jstats, tstats


def test_solution_branch_matches(runs):
    jout, tout, jstats, tstats = runs
    assert tstats == jstats
    assert jstats["adv_success"] == jstats["feasible"] > 0
    js, ts = _scenes(jout), _scenes(tout)
    assert not ts["adv_failed"]
    worst = {}
    for d in FOLDERS:
        assert sorted(ts[d]) == sorted(js[d]), d
        for name, want in js[d].items():
            got = ts[d][name]
            assert sorted(got) == sorted(want)
            assert {"fut_sol", "z_sol"} <= set(got)
            assert (got["attack_agt"], got["attack_t"]) == \
                (want["attack_agt"], want["attack_t"])
            for k in ("fut_sol", "z_sol", "fut_adv", "z_adv"):
                g, w = np.asarray(got[k]), np.asarray(want[k])
                assert g.shape == w.shape, k
                worst[k] = max(worst.get(k, 0.0), float(np.abs(g - w).max()))
    print("largest differences, port against strive_tpu:", worst)
    for k, v in worst.items():
        assert v <= (LATENT_TOL if k.startswith("z_") else TRAJ_TOL_M), (k, v)


def test_solution_jsons_load_in_strive_tpu(runs):
    _, tout, _, tstats = runs
    n = 0
    for d in ("adv_sol_success", "sol_failed"):
        path = os.path.join(tout, "scenario_results", d)
        if os.path.isdir(path):
            for sc in read_adv_scenes(path):
                n += 1
                assert sc["scene_sol"].shape == sc["scene_fut"].shape
                assert sc["z_sol"].shape == sc["z_adv"].shape
    assert n == tstats["adv_success"]
