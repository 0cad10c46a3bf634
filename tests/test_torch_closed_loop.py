"""The port's closed-loop adversarial optimization against strive_tpu's.

``run_adv_gen_optim(planner_name='hardcode')`` on both sides, with the
tiny model of tests/test_torch_adv_optim.py (B=2 scenes x NA=4, FT=6), 4
Adam iterations, the planner re-rolled every k in {1, 2, 3} iterations
(3: the ``4 % 3`` remainder block), and each backend:

- host: the numpy ``RulePlanner`` through ``make_planner_host_fn`` on both
  sides (strive_tpu's chunked loop calls it between jitted chunks);
- device: the port's ``DeviceRulePlanner.make_fn`` against strive_tpu's
  ``TpuRulePlanner.make_fused_fn``, bound to the planner's state (the
  chunked loop calls it eagerly between jitted chunks, so both backends
  share one compiled runner per k).

Tolerances: loss history rtol 1e-3; final latents, final result (true
planner at slot 0) and internal prediction atol 1e-4; ``min_agt`` and
``min_t`` exactly; ``compute_adv_gen_success`` equal on every scene. The
latents are passed in (a JAX PRNG stream cannot be replayed in torch).
"""

import numpy as np
import jax
import pytest
import torch

from helpers import TEST_CATS, make_scene, tiny_model, tiny_store
from torch_helpers import n, port_model, scene_to_torch

import strive_tpu.maps.lanegraph as jlg
from strive_tpu.model.traffic_model import init_model_params
from strive_tpu.normalize import att_normalizer_for as j_att_norm
from strive_tpu.normalize import state_normalizer_for as j_state_norm
from strive_tpu.optim.adv import compute_adv_gen_success as j_success
from strive_tpu.optim.adv import run_adv_gen_optim as j_run
from strive_tpu.planners import RulePlanner as JRulePlanner
from strive_tpu.planners.host_bridge import make_planner_host_fn as j_host_fn
from strive_tpu.planners.tpu_planner import TpuRulePlanner
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.optim.adv import compute_adv_gen_success
from strive_tpu_torch.optim.adv import run_adv_gen_optim as t_run
from strive_tpu_torch.planners import PLANNER_CONFIGS, RulePlanner
from strive_tpu_torch.planners.device_planner import DeviceRulePlanner
from strive_tpu_torch.planners.host_bridge import (make_planner_host_fn,
                                                   reset_planner)

WEIGHTS = {"adv_crash": 2.0, "motion_prior": 1.0, "motion_prior_atk": 0.005,
           "coll_veh": 20.0, "coll_veh_plan": 20.0, "coll_env": 20.0,
           "init_z": 0.5, "init_z_atk": 0.05, "match_ext": 10.0,
           "motion_prior_ext": 0.0001}
FEAS_T, ITERS, DT, FT = 2, 4, 0.5, 6
CFG = PLANNER_CONFIGS["default"]


def _lanegraph(m):
    return m.synthetic_lanegraph(extent_m=128.0, spacing_m=32.0)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=FT)
    model = tiny_model(FT=FT, PT=4)
    js = tiny_store()
    params = init_model_params(model, scene, js, jax.random.PRNGKey(0))
    je = jax.jit(lambda p, s: model.apply(p, s, js, method="embed"))(params,
                                                                     scene)
    tm = port_model(model, params, 3)
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    tsc = scene_to_torch(scene)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    state_norm = state_normalizer_for(TEST_CATS)
    init = state_norm.unnormalize(n(tsc.past_gt[:, :, -1]))
    lw = att_normalizer_for(TEST_CATS).unnormalize(n(tsc.lw))
    mask, map_idx = n(tsc.mask), n(tsc.map_idx)
    names = list(js.map_names)

    # the planners of both packages, reset on the batch
    jsn = j_state_norm(TEST_CATS)
    jgraphs = {m: _lanegraph(jlg) for m in names}
    tgraphs = {m: _lanegraph(tlg) for m in names}
    jhost = JRulePlanner(jgraphs, names, CFG)
    counts = np.maximum(mask.sum(1), 1)
    jhost.reset(np.concatenate([s[:c] for s, c in zip(init, counts)]),
                np.concatenate([a[:c] for a, c in zip(lw, counts)]),
                np.repeat(np.arange(len(counts)), counts), len(counts),
                map_idx)
    thost = RulePlanner(tgraphs, names, CFG)
    reset_planner(thost, init, lw, mask, map_idx)
    jdev = TpuRulePlanner(jgraphs, names, CFG)
    jdev.reset(init, lw, mask, map_idx)
    tdev = DeviceRulePlanner(tgraphs, names, CFG, device="cpu")
    tdev.reset(init, lw, mask, map_idx)
    jfused = jdev.make_fused_fn(jsn, DT, FT)
    planners = {
        "host": (dict(planner_rollout_fn=j_host_fn(jhost, mask, jsn, DT, FT)),
                 make_planner_host_fn(thost, mask, state_norm, DT, FT)),
        "device": (dict(planner_rollout_fn=lambda p: jfused(p, jdev.state)),
                   tdev.make_fn(state_norm, DT, FT)),
    }
    return model, params, scene, js, je, tm, tsc, ts, te, planners


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_closed_loop_matches_strive_tpu(setup, backend, k):
    model, params, scene, js, je, tm, tsc, ts, te, planners = setup
    jkw, tfn = planners[backend]
    jp, tp = je["prior_out"], te["prior_out"]
    jout = j_run(model, params, jp[0], 0.05, WEIGHTS, scene, js, ITERS, je,
                 "hardcode", (jp[0][:, 0], jp[1][:, 0]), jp, FEAS_T, None,
                 closed_loop_mode="chunked", planner_refresh_every=k, **jkw)
    tout = t_run(tm, tp[0], 0.05, WEIGHTS, tsc, ts, ITERS, te, "hardcode",
                 (tp[0][:, 0], tp[1][:, 0]), tp, FEAS_T, None,
                 planner_rollout_fn=tfn, planner_refresh_every=k)
    z, result, min_agt, min_t, losses, pred = tout
    assert all(p.requires_grad for p in tm.parameters())  # restored
    np.testing.assert_allclose(n(losses), n(jout[4]), rtol=1e-3)
    np.testing.assert_allclose(n(z), n(jout[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(min_agt), n(jout[2]))
    np.testing.assert_array_equal(n(min_t), n(jout[3]))
    np.testing.assert_allclose(n(result), n(jout[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(pred), n(jout[5]), rtol=0, atol=1e-4)
    # the planner's future differs from the model's own ego prediction
    assert np.abs(n(result[:, 0]) - n(pred[:, 0])).max() > 1e-3

    norms = (state_normalizer_for(TEST_CATS), att_normalizer_for(TEST_CATS))
    jnorms = (j_state_norm(TEST_CATS), j_att_norm(TEST_CATS))
    for b in range(scene.B):
        atk = int(n(min_agt)[b])
        args = (n(tsc.lw)[b], n(tsc.mask)[b], atk)
        got = compute_adv_gen_success(result[b], *norms, *args)
        for g, w in zip(got, j_success(n(jout[1])[b], *jnorms, *args)):
            np.testing.assert_array_equal(g, w)
        # the same function on the same (JAX) trajectory: a numpy copy
        same = compute_adv_gen_success(n(jout[1])[b], *norms, *args)
        for g, w in zip(same, j_success(n(jout[1])[b], *jnorms, *args)):
            np.testing.assert_array_equal(g, w)
