"""The port's adversarial scenario generation against strive_tpu's, whole.

``scripts/adv_scenario_gen.main`` (JAX, on the CPU) and
``strive_tpu_torch.scripts.adv_scenario_gen.main`` (``--device cpu``) run
in this process on ``configs/adv_gen_synthetic.cfg`` (open loop) and
``configs/adv_gen_synthetic_hardcode.cfg`` (closed loop: the device
planner on both sides, JAX's eager 'chunked' loop), with ``--num_iters 2
--num_samples 4 --synth_scenes 4 --max_scenes 4``. The port gets JAX's
initial weights and JAX's per-candidate prior noise (``PRNGKey(0)``, split
as ``scripts/adv_scenario_gen.py:248``) through its ``init_params`` and
``prior_noise``.

Must match: the stats dicts, the feasible-scene log lines, the scene JSONs
in each of the three folders, and their ``attack_agt`` and ``attack_t``
exactly; the recorded past, sizes, classes and prior to float noise. The
port's JSONs load through ``strive_tpu.data.scenario_json.read_adv_scenes``.

The optimized trajectories and latents are held at what was measured, not
at 1e-2 m / 1e-3: the drift starts in the first stage, the 75-iteration
fit to the recorded scene, whose objective is discontinuous at float-noise
scale (a crop sample on a pixel's rounding tie; a gradient that jumps when
z moves by a relative 1e-5: tests/test_torch_pipeline_stages.py
``test_init_optim_matches`` and ``test_init_objective_jumps_within_float_
noise``, ROADMAP §3), and the 75 + 100 + 2 Adam steps amplify it. Measured
here, the port against strive_tpu: 0.17 m / 0.55 (open loop) and 1.05 m /
2.64 (closed loop, where the rule planner's reaction feeds the fit back),
so the bounds are 1.1 m and 2.7. The test prints the largest differences.
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (sets the torch thread count)
from strive_tpu.data.scenario_json import read_adv_scenes
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.utils.convert import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import adv_scenario_gen as jgen  # noqa: E402

COMMON = ["--num_iters", "2", "--num_samples", "4", "--synth_scenes", "4",
          "--max_scenes", "4"]
RUNS = {
    "open_loop": ("configs/adv_gen_synthetic.cfg", [], []),
    "closed_loop": ("configs/adv_gen_synthetic_hardcode.cfg",
                    ["--planner_backend", "tpu", "--closed_loop_mode",
                     "chunked"],
                    ["--planner_backend", "tpu"]),
}
FOLDERS = ("adv_sol_success", "sol_failed", "adv_failed")
TRAJ_KEYS = ("fut_init", "fut_adv", "fut_internal_ego", "fut_sol")
LATENT_KEYS = ("z_adv", "z_sol")
TRAJ_TOL_M, LATENT_TOL = 1.1, 2.7  # measured (module doc)


def _feasible_lines(out):
    with open(os.path.join(out, "adv_gen_log.txt")) as f:
        return [l for l in f.read().splitlines() if ": feasible (" in l]


def _scenes(out):
    """{folder: {name: json dict}} of one run's scenario folders."""
    root = os.path.join(out, "scenario_results")
    res = {}
    for d in FOLDERS:
        path = os.path.join(root, d)
        names = sorted(os.listdir(path)) if os.path.isdir(path) else []
        res[d] = {}
        for n in names:
            with open(os.path.join(path, n)) as f:
                res[d][n] = json.load(f)
    return res


def _jax_noise_stream():
    """JAX's per-candidate prior noise: PRNGKey(0), one split a candidate."""
    key = jax.random.PRNGKey(0)

    def noise(generator, shape):
        nonlocal key
        key, k1 = jax.random.split(key)
        return torch.from_numpy(np.array(
            jax.random.normal(k1, shape, jnp.float32)))

    return noise


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    cfg, jax_extra, port_extra = RUNS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    jout, tout = str(tmp / "jax"), str(tmp / "port")
    params = {}
    mp = pytest.MonkeyPatch()
    try:
        real_init = jgen.init_model_params

        def capture(*a, **k):
            params["flax"] = real_init(*a, **k)
            return params["flax"]

        mp.setattr(jgen, "init_model_params", capture)
        jstats = jgen.main(["-c", cfg, "--out", jout] + COMMON + jax_extra)

        def jax_weights(model):
            model.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, params["flax"])))

        mp.setattr(tgen, "init_params", jax_weights)
        mp.setattr(tgen, "prior_noise", _jax_noise_stream())
        tstats = tgen.main(["-c", cfg, "--out", tout, "--device", "cpu"]
                           + COMMON + port_extra)
    finally:
        mp.undo()
    return jout, tout, jstats, tstats


def test_stats_and_feasible_scenes_match(runs):
    jout, tout, jstats, tstats = runs
    assert tstats == jstats
    assert _feasible_lines(tout) == _feasible_lines(jout)
    assert jstats["feasible"] > 0


def test_scene_taxonomy_and_attack_match(runs):
    jout, tout, _, _ = runs
    js, ts = _scenes(jout), _scenes(tout)
    for d in FOLDERS:
        assert sorted(ts[d]) == sorted(js[d]), d
        for name, want in js[d].items():
            got = ts[d][name]
            assert sorted(got) == sorted(want), (d, name)
            assert (got["attack_agt"], got["attack_t"]) == \
                (want["attack_agt"], want["attack_t"]), (d, name)
            assert (got["N"], got["dt"], got["map"]) == \
                (want["N"], want["dt"], want["map"])
            np.testing.assert_array_equal(got["sem"], want["sem"])


def test_trajectories_and_latents_match(runs):
    jout, tout, _, _ = runs
    js, ts = _scenes(jout), _scenes(tout)
    worst = {}
    for d in FOLDERS:
        for name, want in js[d].items():
            got = ts[d][name]
            for k in ("past", "lw"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
            for k in TRAJ_KEYS + LATENT_KEYS:
                if k not in want:
                    continue
                g, w = np.asarray(got[k]), np.asarray(want[k])
                assert g.shape == w.shape, (d, name, k)
                worst[k] = max(worst.get(k, 0.0), float(np.abs(g - w).max()))
            for k in ("mean", "var"):
                g = np.asarray(got["z_prior"][k])
                w = np.asarray(want["z_prior"][k])
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert worst, "no scene was saved"
    print("largest differences, port against strive_tpu:", worst)
    for k, v in worst.items():
        tol = LATENT_TOL if k in LATENT_KEYS else TRAJ_TOL_M
        assert v <= tol, f"{k}: largest difference {v:.3g} > {tol}"


def test_port_json_loads_in_strive_tpu(runs):
    _, tout, _, _ = runs
    root = os.path.join(tout, "scenario_results")
    n = 0
    for d in FOLDERS:
        path = os.path.join(root, d)
        if not os.path.isdir(path):
            continue
        for sc in read_adv_scenes(path):
            n += 1
            assert sc["scene_fut"].shape == sc["scene_init"].shape
            assert sc["z_adv"].shape[0] == sc["veh_att"].shape[0]
            assert ("scene_sol" in sc) == (d != "adv_failed")
    assert n > 0
