"""The stages of the port's scenario-generation pipeline against strive_tpu.

Each module of the pipeline, on the CPU, with numpy-seeded inputs and the
tiny model of tests/test_torch_closed_loop.py (B=2 scenes x NA=4, FT=6):

- ``TrafficModel.sample_batched`` with JAX's noise passed as ``eps``, with
  and without ``include_mean``: future_pred rtol 1e-4 / atol 1e-4 (a
  rollout whose crop took another pixel on a rounding tie only up to that
  step, ROADMAP §3); z_samp
  atol 1e-6 against JAX's formula on the port's prior, and atol 1e-4 (the
  embed's tolerance, tests/test_torch_model.py) against strive_tpu's;
  z_logprob and z_mdist rtol 1e-5;
- ``determine_feasibility``: feasible and feasible_t exact, feasible_dist
  rtol 1e-5 (in-front filter on/off, separation filter on/off, an exact
  argmin tie, tests/test_optim.py's two hand-built cases);
- ``restrict_attackers_to_category`` (tests/test_adv_attack_with.py's
  cases);
- ``avoid_coll_loss``: loss rtol 1e-4, gradients rtol 1e-3 / atol 1e-5,
  for ``single_veh_idx`` None and 0, buffer 0.5;
- ``compute_coll_rate_env``: did_collide exact;
- ``run_init_optim`` and ``run_find_solution_optim``, 3 iterations: loss
  history rtol 1e-3; latents and trajectories atol 1e-4 (see
  ``test_init_optim_matches`` for the one measured exception); the
  solution's non-ego rows equal to its input;
- ``compute_sol_success`` and ``prepare_output_dict``: equal;
- the config reader: every file in configs/ gives ``yaml.safe_load``'s
  dict, the adversarial entry point's flags parse each adv_gen config as
  strive_tpu's do, and a malformed line raises;
- the repairs this pipeline needs: ``SceneBatch.take``/``num_agents``,
  ``MapStore.map_names``, ``upsample_store``, ``SceneDataset`` and
  ``load_environment`` (synthetic) equal to strive_tpu's.
"""

import argparse
import glob
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from helpers import TEST_CATS, make_scene, tiny_model, tiny_store
from torch_helpers import (assert_gather_parity, n, port_model,
                           scene_to_torch, t)

from strive_tpu.data import dataset as jds
from strive_tpu.data.loading import load_environment as j_load
from strive_tpu.data.scenario_json import prepare_output_dict as j_prepare
from strive_tpu.losses import adv as jadv
from strive_tpu.losses.training import compute_coll_rate_env as j_coll_env
from strive_tpu.maps import MapStore as JMapStore
from strive_tpu.maps import synthetic_map_store as j_store
from strive_tpu.maps.queries import get_map_crop as j_crop
from strive_tpu.maps.store import upsample_store as j_upsample
from strive_tpu.model.traffic_model import init_model_params
from strive_tpu.normalize import att_normalizer_for as j_att_norm
from strive_tpu.normalize import state_normalizer_for as j_state_norm
from strive_tpu.optim import feasibility as jfeas
from strive_tpu.optim.init_optim import run_init_optim as j_init
from strive_tpu.optim.sol import compute_sol_success as j_sol_success
from strive_tpu.optim.sol import run_find_solution_optim as j_sol
from strive_tpu_torch.data import dataset as tds
from strive_tpu_torch.data.loading import load_environment as t_load
from strive_tpu_torch.data.scenario_json import prepare_output_dict
from strive_tpu_torch.losses import adv as tadv
from strive_tpu_torch.losses.training import compute_coll_rate_env
from strive_tpu_torch.maps import queries as tq
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.maps.store import MapStore, upsample_store
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.optim import feasibility as tfeas
from strive_tpu_torch.optim.init_optim import run_init_optim
from strive_tpu_torch.optim.sol import (compute_sol_success,
                                        run_find_solution_optim)
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.utils.config import read_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.cfg")))
ADV_CONFIGS = [c for c in CONFIGS
               if os.path.basename(c).startswith("adv_gen_")]
FT, NS = 6, 5
INIT_W = {"match_ext": 10.0, "motion_prior_ext": 0.1}
SOL_W = {"coll_veh": 10.0, "coll_env": 10.0, "motion_prior": 0.005,
         "init_z": 0.0, "motion_prior_ext": 0.001, "match_ext": 10.0}
LOSS = dict(rtol=1e-4, atol=1e-6)
GRAD = dict(rtol=1e-3, atol=1e-5)
SN, AN = state_normalizer_for(TEST_CATS), att_normalizer_for(TEST_CATS)
JSN, JAN = j_state_norm(TEST_CATS), j_att_norm(TEST_CATS)


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
    return model, params, scene, js, je, tm, tsc, ts, te


# ---- sampling ---------------------------------------------------------------

@pytest.mark.parametrize("include_mean", [False, True])
def test_sample_batched_matches(setup, include_mean):
    model, params, scene, js, _, tm, tsc, ts, _ = setup
    rng = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, s, k: model.apply(
        p, s, js, NS, k, include_mean, method="sample_batched"))(params,
                                                                 scene, rng)
    D = want["z_samp"].shape[-1]
    eps = jax.random.normal(rng, (scene.B, NS, scene.NA, D), jnp.float32)
    with torch.no_grad():
        got = tm.sample_batched(tsc, ts, NS, include_mean=include_mean,
                                eps=t(eps))
    assert got["future_pred"].shape == (scene.B, NS, scene.NA, FT, 4)
    # the draw itself is JAX's formula on the port's prior, to 1e-6; the
    # prior (the embed) agrees with strive_tpu's at atol 1e-4, as in
    # tests/test_torch_model.py, and so does z_samp
    mu, var = (n(x) for x in got["prior_out"])
    z = mu[:, None] + n(eps) * np.sqrt(var[:, None])
    if include_mean:
        z[:, -1] = mu
    np.testing.assert_allclose(n(got["z_samp"]), z, rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got["z_samp"]), n(want["z_samp"]), rtol=0,
                               atol=1e-4)
    for k in ("z_logprob", "z_mdist"):
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # a rollout whose crop took another pixel on a rounding tie (the known
    # crop difference, ROADMAP §3) is held from the next step on only to
    # be finite; every other output at rtol 1e-4 / atol 1e-4
    gf, wf = n(got["future_pred"]), n(want["future_pred"])
    keep = np.ones(gf.shape[:4], bool)
    for (b, s), step in _tie_flipped_rollouts(model, js, ts, scene, gf,
                                              wf).items():
        keep[b, s, :, step:] = False
    assert keep.mean() > 0.9, "most rollouts crossed a rounding tie"
    np.testing.assert_allclose(gf[keep], wf[keep], rtol=1e-4, atol=1e-4)
    assert np.isfinite(gf).all()
    for a, b in zip(got["prior_out"], want["prior_out"]):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-4)


def _tie_flipped_rollouts(model, js, ts, scene, got, want):
    """{(b, s): first step whose input differs} for the sample rollouts
    (B, NS, NA, FT, 4) NORMALIZED where the port's crop at its own pose
    differs from strive_tpu's at its pose; every differing pixel must be
    within TIE_BAND_PX of a rounding tie (else the assertion fails)."""
    sstd = np.asarray(model.norm.state_std[:4], np.float32)
    smean = np.asarray(model.norm.state_mean[:4], np.float32)
    L = model.map_obs_size_pix
    out = {}
    for b in range(got.shape[0]):
        mapix = np.full(got.shape[2], int(scene.map_idx[b]), np.int32)
        for s in range(got.shape[1]):
            for step in range(got.shape[3] - 1):
                pg = got[b, s, :, step] * sstd + smean
                pw = want[b, s, :, step] * sstd + smean
                cw = j_crop(js.raster, js.dx, jnp.asarray(pw),
                            jnp.asarray(mapix), model.map_bounds, L=L, W=L,
                            packed=js.packed, layout="nhwc")
                cg = tq.get_map_crop(ts.packed, ts.dx, t(pg), t(mapix),
                                     model.map_bounds, ts.C, L=L, W=L,
                                     layout="nhwc")
                diff = (n(cg) != n(cw)).any(-1)
                if diff.any():
                    xys = tq.gen_car_coords(t(pg[:, :2]), t(pg[:, 2:]), L, L,
                                            bounds=model.map_bounds)
                    d = ts.dx[t(mapix)][:, None, None, :].expand_as(xys)
                    assert_gather_parity(diff, np.zeros_like(diff), xys, d)
                    out[(b, s)] = step + 1
                    break
    return out


def test_sample_axis_folds_into_the_batch(setup):
    """A (B, NS, NA, D) decode equals NS separate (B, NA, D) decodes."""
    _, _, _, _, _, tm, tsc, ts, te = setup
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(tsc.B, 3, tsc.NA, 32)).astype(np.float32))
    with torch.no_grad():
        folded = tm.decode_embedding(z, te, tsc, ts)["future_pred"]
        for s in range(3):
            one = tm.decode_embedding(z[:, s], te, tsc, ts)["future_pred"]
            torch.testing.assert_close(folded[:, s], one, rtol=0, atol=1e-6)


# ---- feasibility ------------------------------------------------------------

def _feas_samples(seed):
    """NS x NA (incl. ego) random futures around the tiny store's centre,
    unnormalized -> normalized."""
    rng = np.random.default_rng(seed)
    NSf, NAf = 4, 6
    start = rng.uniform(40, 90, (NSf, NAf, 1, 2))
    vel = rng.normal(0, 4, (NSf, NAf, 1, 2))
    xy = start + vel * np.arange(FT)[None, None, :, None] * 0.5
    h = np.arctan2(vel[..., 1], vel[..., 0])
    s = np.concatenate([xy, np.cos(h)[..., None].repeat(FT, 2),
                        np.sin(h)[..., None].repeat(FT, 2)], -1)
    return np.asarray(JSN.normalize(s.astype(np.float32)))


def _feasibility_both(samples, mask, js, ts, **kw):
    want = jfeas.determine_feasibility(
        jnp.asarray(samples), jnp.asarray(mask), JSN, **kw,
        **({"drivable": js.drivable(), "dx": js.dx, "map_idx": jnp.asarray(1)}
           if kw.get("check_non_drivable_separation") else {}))
    got = tfeas.determine_feasibility(
        t(samples), t(mask), SN, **kw,
        **({"drivable": ts.drivable(), "dx": ts.dx, "map_idx": t(1)}
           if kw.get("check_non_drivable_separation") else {}))
    return got, want


def _assert_feasibility_equal(got, want):
    np.testing.assert_array_equal(n(got[0]), n(want[0]))
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    np.testing.assert_allclose(n(got[2]), n(want[2]), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("infront", [None, 0.0])
@pytest.mark.parametrize("sep", [False, True])
def test_determine_feasibility_matches(setup, seed, infront, sep):
    _, _, _, js, _, _, _, ts, _ = setup
    samples = _feas_samples(seed)
    mask = np.ones(samples.shape[1], bool)
    mask[-1] = False
    got, want = _feasibility_both(
        samples, mask, js, ts, feasibility_thresh=25.0, feasibility_time=2,
        feasibility_vel=0.5, feasibility_infront_min=infront,
        check_non_drivable_separation=sep)
    _assert_feasibility_equal(got, want)
    assert n(got[0]).any() and not n(got[0]).all()


def test_determine_feasibility_exact_tie(setup):
    """Two samples (and two steps) at exactly the same distance: the first
    of each is taken, as ``jnp.argmin`` takes it."""
    _, _, _, js, _, _, _, ts, _ = setup
    s = np.zeros((3, 3, FT, 4), np.float32)
    s[..., 2] = 1.0
    s[:, 0, :, 0], s[:, 0, :, 1] = 60.0, 60.0                 # ego parked
    s[:, 1, :, 0] = np.float32([70, 66, 68, 66, 75, 80])     # tie at t=1, 3
    s[:, 1, :, 1] = 60.0
    s[1, 1] = s[0, 1]                                         # sample tie
    s[2, 1, :, 0] += 1.0
    s[:, 2, :, 0], s[:, 2, :, 1] = 64.0, np.float32([57, 56, 55, 54, 53, 52])
    s = np.asarray(JSN.normalize(s))
    mask = np.ones(3, bool)
    for sep in (False, True):
        got, want = _feasibility_both(
            s, mask, js, ts, feasibility_thresh=10.0, feasibility_time=0,
            feasibility_vel=0.0, feasibility_infront_min=None,
            check_non_drivable_separation=sep)
        _assert_feasibility_equal(got, want)
        assert int(n(got[1])[0]) == 1


def test_determine_feasibility_hand_built(setup):
    """tests/test_optim.py's two cases: an agent approaching head-on is
    feasible and a far one is not; a wall separates a close candidate."""
    _, _, scene, js, _, _, _, ts, _ = setup
    NA = scene.NA
    s = np.zeros((3, NA, FT, 4), np.float32)
    s[..., 2] = 1.0
    s[:, 0, :, 0], s[:, 0, :, 1] = np.linspace(60, 70, FT), 60.0
    s[:, 1, :, 0], s[:, 1, :, 1] = np.linspace(75, 66, FT), 60.0
    s[:, 2, :, 0], s[:, 2, :, 1] = 10.0, 10.0
    mask = np.zeros(NA, bool)
    mask[:3] = True
    got, want = _feasibility_both(
        np.asarray(JSN.normalize(s)), mask, js, ts, feasibility_thresh=10.0,
        feasibility_time=0, feasibility_vel=0.0,
        check_non_drivable_separation=False)
    _assert_feasibility_equal(got, want)
    np.testing.assert_array_equal(n(got[0]), [True, False] + [False] * (NA - 3))

    arr = np.ones((1, 1, 512, 512), np.uint8)
    arr[0, 0, :, 200:210] = 0  # a wall at x in [50, 52.5] m
    jwall = JMapStore(raster=jnp.asarray(arr),
                      dx=jnp.asarray(np.full((1, 2), 0.25, np.float32)))
    twall = MapStore.from_raster(torch.from_numpy(arr),
                                 torch.full((1, 2), 0.25))
    s = np.zeros((2, 3, FT, 4), np.float32)
    s[..., 2] = 1.0
    s[:, :, :, 1] = 60.0
    s[:, 0, :, 0], s[:, 1, :, 0], s[:, 2, :, 0] = 40.0, 45.0, 58.0
    kw = dict(feasibility_thresh=25.0, feasibility_time=0,
              feasibility_vel=-1.0, feasibility_infront_min=None,
              check_non_drivable_separation=True)
    sn = np.asarray(JSN.normalize(s))
    want = jfeas.determine_feasibility(
        jnp.asarray(sn), jnp.ones(3, bool), JSN, drivable=jwall.drivable(),
        dx=jwall.dx, map_idx=jnp.asarray(0), **kw)
    got = tfeas.determine_feasibility(
        t(sn), torch.ones(3, dtype=torch.bool), SN,
        drivable=twall.drivable(), dx=twall.dx, map_idx=t(0), **kw)
    _assert_feasibility_equal(got, want)
    np.testing.assert_array_equal(n(got[0]), [True, False])


@pytest.mark.parametrize("category,reduced,cats,sem_cols,feas", [
    ("cyclist", False, ("car", "cyclist", "truck"), [0, 1, 0, 1],
     [True, True, False]),
    ("bus", True, ("car", "cyclist", "truck"), [0, 2, 0, 2],
     [True, True, True]),
    ("bus", False, ("car", "cyclist", "truck"), [0, 2, 0, 2],
     [True, True, True]),
    ("pedestrian", True, ("car", "cyclist", "truck"), [0, 2, 0, 2],
     [True, True, True]),
])
def test_restrict_attackers_matches(category, reduced, cats, sem_cols, feas):
    sem = np.eye(len(cats), dtype=np.float32)[sem_cols]
    want = jfeas.restrict_attackers_to_category(
        jnp.asarray(feas), jnp.asarray(sem), cats, category, reduced=reduced)
    got = tfeas.restrict_attackers_to_category(
        torch.tensor(feas), t(sem), cats, category, reduced=reduced)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(n(got), n(want))


# ---- avoid_coll_loss and compute_coll_rate_env ------------------------------

@pytest.fixture(scope="module")
def loss_data():
    """tests/test_torch_losses.py's data: agents over a 512 px map, one
    overlapping the ego, another agent 1, some partially off the road, so
    that vehicle and environment terms are both active."""
    rng = np.random.default_rng(21)
    B, NA, T, D = 2, 5, 6, 8
    start = rng.uniform(5, 125, (B, NA, 1, 2))
    vel = rng.normal(0, 3, (B, NA, 1, 2))
    xy = start + vel * np.arange(T)[None, None, :, None] * 0.5
    th = np.arctan2(vel[..., 1], vel[..., 0]) + rng.normal(0, 0.1, (B, NA, T))
    traj = np.concatenate([xy, np.cos(th)[..., None], np.sin(th)[..., None]],
                          -1).astype(np.float32)
    traj[:, 2] = traj[:, 0] + np.float32(1.0)  # agent 2 overlaps the ego
    traj[:, 3] = traj[:, 1] + np.float32(1.5)  # and agent 3 agent 1
    lw = np.stack([rng.uniform(4, 6, (B, NA)), rng.uniform(1.8, 2.4, (B, NA))],
                  -1).astype(np.float32)
    mask = np.ones((B, NA), bool)
    mask[1, -1] = False
    ego = np.zeros((B, NA), bool)
    ego[:, 0] = True
    d = dict(traj=traj, lw=lw, mask=mask, ego=ego,
             mapix=np.array([0, 1], np.int32),
             z=rng.normal(size=(B, NA, D)).astype(np.float32),
             mu=rng.normal(size=(B, NA, D)).astype(np.float32),
             var=rng.uniform(0.5, 1.5, (B, NA, D)).astype(np.float32),
             init_z=rng.normal(size=(B, NA, D)).astype(np.float32))
    js = j_store(num_maps=2, size_px=512, channels=3, seed=3)
    ts = t_store(num_maps=2, size_px=512, channels=3, seed=3, device="cpu")
    return d, js, ts


@pytest.mark.parametrize("single", [None, 0])
def test_avoid_coll_loss_matches(loss_data, single):
    d, js, ts = loss_data
    weights = dict(SOL_W, init_z=0.5)
    zm = d["ego"] if single == 0 else d["mask"]
    kw = dict(veh_coll_buffer=0.5, single_veh_idx=single, weights=weights)

    def jloss(pred, z):
        out = jadv.avoid_coll_loss(
            pred, z, (jnp.asarray(d["mu"]), jnp.asarray(d["var"])),
            lw=jnp.asarray(d["lw"]), mask=jnp.asarray(d["mask"]),
            mapixes=jnp.asarray(d["mapix"]), drivable=js.drivable(),
            dx=js.dx, init_z=jnp.asarray(d["init_z"]),
            z_mask=jnp.asarray(zm), **kw)
        return out["loss"], out

    pred = t(d["traj"]).requires_grad_(True)
    z = t(d["z"]).requires_grad_(True)
    out = tadv.avoid_coll_loss(
        pred, z, (t(d["mu"]), t(d["var"])), lw=t(d["lw"]), mask=t(d["mask"]),
        mapixes=t(d["mapix"]), packed=ts.packed, dx=ts.dx,
        init_z=t(d["init_z"]), z_mask=t(zm), **kw)
    grads = torch.autograd.grad(out["loss"], (pred, z))
    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True))(
        jnp.asarray(d["traj"]), jnp.asarray(d["z"]))
    for k in ("loss", "coll_veh_loss", "coll_env_loss", "motion_prior_loss",
              "init_loss"):
        np.testing.assert_allclose(n(out[k]), n(jout[k]), **LOSS, err_msg=k)
    assert n(out["coll_veh_loss"]) > 0 and n(out["coll_env_loss"]) > 0
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(n(a), n(b), **GRAD)


@pytest.mark.parametrize("ego_only", [False, True])
def test_compute_coll_rate_env_matches(setup, ego_only):
    _, _, scene, js, _, _, tsc, ts, _ = setup
    rng = np.random.default_rng(5)
    # the scenes' futures, 3 samples, moved up to ~15 m; sample 2 far off
    fut = np.repeat(np.asarray(scene.future_gt[:, None, :, :, :4]), 3, 1)
    fut[..., :2] += rng.normal(0, 1.0, (2, 3, 4, 1, 2)).astype(np.float32)
    fut[:, 2, :, :, :2] -= np.float32(3.0)
    want = j_coll_env(scene, jnp.asarray(fut), js, JSN, JAN, ego_only=ego_only)
    got = compute_coll_rate_env(tsc, t(fut), ts, SN, AN, ego_only=ego_only)
    np.testing.assert_array_equal(n(got["did_collide"]),
                                  n(want["did_collide"]))
    assert float(n(got["num_coll_map"])) == float(n(want["num_coll_map"]))
    assert int(got["num_traj_map"]) == int(want["num_traj_map"])
    if not ego_only:
        did = n(got["did_collide"])
        assert did.any() and not did[n(tsc.mask)[:, None, :].repeat(3, 1)].all()


# ---- the optimizations ------------------------------------------------------

# the measured exception of scene 0 (test_init_optim_matches): lr ->
# (latents, normalized trajectories) atol
INIT_SCENE0_TOL = {0.1: (1e-2, 3.2e-3), 0.05: (2e-3, 8e-4)}


@pytest.mark.parametrize("lr", [0.1, 0.05])
def test_init_optim_matches(setup, lr):
    """3 iterations at the script's two learning rates (0.1 for the fit to
    the recorded scene, ``--lr`` 0.05 for the refit to the planner).

    Scene 1 holds 1e-4. Scene 0 is held at what was measured, because its
    second iterate lies within float noise of a discontinuity of
    strive_tpu's own objective: at lr 0.05 strive_tpu's gradient there
    moves by 0.030 when z moves by a relative 1e-5 (the port's gradient
    differs from strive_tpu's by 0.0298 there, 5e-5 at the other
    iterates), and at lr 0.1 its decode jumps by 1.9e-3 (normalized) while
    the iterates agree to 1.4e-5 (a crop sample on a pixel's rounding tie;
    ROADMAP §3). Measured on scene 0 after 3 iterations: latents 9.9e-3 /
    1.9e-3 and trajectories 3.1e-3 / 7.6e-4 (normalized) at lr 0.1 / 0.05.
    """
    model, params, scene, js, je, tm, tsc, ts, te = setup
    jz, jfut, jl = j_init(model, params, je["posterior_out"][0],
                          scene.future_gt, scene.future_vis, lr, INIT_W,
                          scene, js, 3, je, je["prior_out"])
    z, fut, losses = run_init_optim(tm, te["posterior_out"][0],
                                    tsc.future_gt, tsc.future_vis, lr, INIT_W,
                                    tsc, ts, 3, te, te["prior_out"])
    assert all(p.requires_grad for p in tm.parameters())  # restored
    np.testing.assert_allclose(n(losses), n(jl), rtol=1e-3)
    m = n(tsc.mask)
    for b in range(scene.B):
        zt, ft = INIT_SCENE0_TOL[lr] if b == 0 else (1e-4, 1e-4)
        np.testing.assert_allclose(n(z)[b][m[b]], n(jz)[b][m[b]], rtol=0,
                                   atol=zt)
        np.testing.assert_allclose(n(fut)[b][m[b]], n(jfut)[b][m[b]], rtol=0,
                                   atol=ft)


def test_init_objective_jumps_within_float_noise(setup):
    """Why test_init_optim_matches holds scene 0 at the measured size:
    strive_tpu's own gradient of the fit objective, at its own second
    iterate (lr 0.05), moves by more than 1e-2 (0.030 measured) when z
    moves by a relative -1e-5, and by less than 1e-4 for +1e-5."""
    from strive_tpu.losses.adv import tgt_matching_loss

    model, params, scene, js, je, _, _, _, _ = setup
    z2 = j_init(model, params, je["posterior_out"][0], scene.future_gt,
                scene.future_vis, 0.05, INIT_W, scene, js, 2, je,
                je["prior_out"])[0]
    smean = jnp.asarray(model.norm.state_mean[:4])
    sstd = jnp.asarray(model.norm.state_std[:4])
    w = scene.future_vis * scene.mask[:, :, None].astype(jnp.float32)

    def loss(z):
        fp = model.apply(params, z, je, scene, js, None,
                         method="decode_embedding")["future_pred"]
        return tgt_matching_loss(fp * sstd + smean,
                                 scene.future_gt[..., :4] * sstd + smean, z,
                                 je["prior_out"], INIT_W, frame_weights=w,
                                 agent_mask=scene.mask)["loss"]

    grad = jax.jit(jax.grad(loss))
    g = np.asarray(grad(z2))
    jump = [float(np.abs(np.asarray(grad(z2 * (1 + e))) - g).max())
            for e in (1e-5, -1e-5)]
    assert jump[0] < 1e-4 and jump[1] > 1e-2, jump


def test_solution_optim_matches(setup):
    model, params, scene, js, je, tm, tsc, ts, te = setup
    final = scene.future_gt[..., :4]
    jp, tp = je["prior_out"], te["prior_out"]
    jz, jsol, jl = j_sol(model, params, jp[0], final, FT + 2, 0.05, SOL_W,
                         scene, js, 3, je, jp, jp)
    z, sol, losses = run_find_solution_optim(
        tm, tp[0], tsc.future_gt[..., :4], FT + 2, 0.05, SOL_W, tsc, ts, 3,
        te, tp, tp)
    np.testing.assert_allclose(n(losses), n(jl), rtol=1e-3)
    m = n(tsc.mask)
    np.testing.assert_allclose(n(z)[m], n(jz)[m], rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(sol)[m], n(jsol)[m], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(sol[:, 1:]), n(tsc.future_gt[:, 1:, :, :4]))


def test_compute_sol_success_matches(setup):
    _, _, scene, js, _, _, tsc, ts, _ = setup
    base = np.asarray(scene.future_gt[..., :4])
    variants = [base.copy()]
    crash = base.copy()
    crash[:, 0] = base[:, 1]          # the ego drives into agent 1
    variants.append(crash)
    off = base.copy()
    off[:, 0, :, :2] += np.float32(-300.0 / 15.0)  # the ego leaves the map
    variants.append(off)
    results = []
    for v in variants:
        for b in range(scene.B):
            want = j_sol_success(jnp.asarray(v[b]), jax.tree_util.tree_map(
                lambda x: x[b:b + 1], scene), js, JSN, JAN)
            got = compute_sol_success(t(v[b]), tsc.take([b]), ts, SN, AN)
            assert got == want
            results.append(got)
    assert any(results) and not all(results)


def test_prepare_output_dict_matches(setup):
    _, _, scene, js, _, _, _, _, _ = setup
    rng = np.random.default_rng(2)
    na, D = 3, 8
    sc = {"past_gt": np.asarray(scene.past_gt[0, :na]),
          "lw": np.asarray(scene.lw[0, :na]), "sem": np.asarray(scene.sem[0, :na])}

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    kw = dict(sol_fut_traj=r(na, FT, 4), attack_agt=2, attack_t=3,
              adv_z=r(na, D), sol_z=r(na, D),
              prior_distrib=(r(na, D), np.abs(r(na, D))),
              attack_bike_prof=r(FT, 2), internal_ego_traj=r(FT, 4))
    init, adv = r(na, FT, 4), r(na, FT, 4)
    for extra in (kw, {}):
        want = j_prepare(sc, 1, js.map_names, 0.5, JSN, JAN, init, adv, **extra)
        got = prepare_output_dict(sc, 1, js.map_names, 0.5, SN, AN, init, adv,
                                  **extra)
        assert got == want


# ---- config -----------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_reader_matches_yaml(path):
    with open(path) as f:
        want = yaml.safe_load(f) or {}
    got = read_config(path)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("path", ADV_CONFIGS, ids=os.path.basename)
def test_adv_configs_parse_as_strive_tpu(path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import adv_scenario_gen as jgen

    want = vars(jgen.parse_cfg(["-c", path]))
    got = vars(tgen.parse_cfg(["-c", path]))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("line", [
    "  indented: 1", "key 1", "key:", "a: yes", "a: ~", "a: 0755",
    "a: 2001-12-14", "a: [1, [2]]", "a: [1, 2", "a: {b: 1}", "a: 'open",
    'a: "x\\ty"', "a: b: c", "- item", "a: &anchor 1", "a: 1\na: 2",
])
def test_config_reader_raises_outside_the_subset(tmp_path, line):
    p = tmp_path / "bad.cfg"
    p.write_text("ok: 1\n" + line + "\n")
    with pytest.raises(ValueError):
        read_config(str(p))


# ---- the entry point's refusals -----------------------------------------------

@pytest.mark.parametrize("extra,want", [
    (["--data_version", "trainval"], FileNotFoundError),
    (["--viz"], "viz_results"),
    (["--mesh_devices", "2"], "scenario_results"),
    (["--data_version", "mini"], FileNotFoundError),
], ids=["trainval-no-etl-FileNotFoundError", "viz-renders",
        "mesh_devices-runs", "mini-no-etl-FileNotFoundError"])
def test_entry_point_raises_on_options_not_ported(tmp_path, extra, want):
    """Real nuScenes without its ETL directory raises strive_tpu's
    FileNotFoundError; --viz renders every saved scene before and after
    the adversarial optimization; --mesh_devices 2 runs the pipeline in
    two gloo processes on the CPU and writes its scenes (held against the
    one-process run in tests/test_torch_distributed.py)."""
    argv = ["-c", os.path.join(REPO, "configs/adv_gen_synthetic.cfg"),
            "--out", str(tmp_path), "--device", "cpu",
            "--data_dir", str(tmp_path / "no_etl")] + extra
    if want == "scenario_results":
        stats = tgen.main(argv + ["--num_iters", "1", "--max_scenes", "2"],
                          init_method=f"file://{tmp_path}/pg")
        jsons = glob.glob(str(tmp_path / want / "*" / "*.json"))
        assert stats["feasible"] == len(jsons) == 2
        return
    if want != "viz_results":
        with pytest.raises(want):
            tgen.main(argv)
        return
    tgen.main(argv + ["--num_iters", "1", "--max_scenes", "2"])
    jsons = glob.glob(str(tmp_path / "scenario_results" / "*" / "*.json"))
    assert len(jsons) == 2
    for path in jsons:
        folder, name = path.split(os.sep)[-2:]
        for view in ("before", "after"):
            img = tmp_path / want / folder / f"{name[:-5]}_{view}.jpg"
            assert img.stat().st_size > 1000, img


def test_entry_point_stops_after_max_batches(tmp_path):
    """``max_batches=1`` ends the run after its first optimized batch: the
    stats and scenario files of a run cut by ``--max_scenes`` at the
    candidate that filled that batch."""
    argv = ["-c", os.path.join(REPO, "configs/adv_gen_synthetic.cfg"),
            "--device", "cpu", "--num_iters", "1", "--batch_size", "1"]
    timings = {}
    got = tgen.main(argv + ["--out", str(tmp_path / "a"), "--max_scenes",
                            "8"], timings, max_batches=1)
    assert len(timings["batches"]) == 1 and got["feasible"] == 1
    assert got["candidates"] < 8
    want = tgen.main(argv + ["--out", str(tmp_path / "b"), "--max_scenes",
                             str(got["candidates"])])
    assert got == want

    def files(d):
        root = tmp_path / d / "scenario_results"
        return sorted(os.path.relpath(p, root)
                      for p in glob.glob(str(root / "*" / "*.json")))
    assert files("a") == files("b") and files("a")


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tgen.main(["-c", os.path.join(REPO, "configs/adv_gen_synthetic.cfg"),
                   "--out", str(tmp_path)])


# ---- scenes, stores, datasets -------------------------------------------------

def test_scene_take_and_num_agents(setup):
    _, _, scene, _, _, _, tsc, _, _ = setup
    ids = [1, 0, 1]
    got = tsc.take(ids)
    want = jax.tree_util.tree_map(lambda x: x[np.array(ids)], scene)
    for k in got.__dataclass_fields__:
        np.testing.assert_array_equal(n(getattr(got, k)), n(getattr(want, k)))
    np.testing.assert_array_equal(n(tsc.num_agents()), n(scene.num_agents()))


def test_map_store_names_and_upsample():
    js = tiny_store()
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    assert ts.map_names == js.map_names == ("synthetic-0", "synthetic-1")
    jup, tup = j_upsample(js, 2), upsample_store(ts, 2)
    np.testing.assert_array_equal(n(tup.raster), n(jup.raster))
    np.testing.assert_array_equal(n(tup.dx), n(jup.dx))
    H, W = tup.raster.shape[-2:]
    np.testing.assert_array_equal(n(tup.packed), n(jup.packed)[:, :H, :W])
    assert tup.map_names == jup.map_names
    assert upsample_store(ts, 1) is ts


def test_scene_dataset_matches():
    rng = np.random.default_rng(4)
    scenes = []
    for na in (3, 12, 6):
        scenes.append({"past": rng.normal(size=(na, 4, 6)).astype(np.float32),
                       "future": rng.normal(size=(na, FT, 6)).astype(np.float32),
                       "sem": np.eye(2, dtype=np.float32)[rng.integers(0, 2, na)],
                       "lw": rng.normal(size=(na, 2)).astype(np.float32),
                       "map_idx": 1})
    want = jds.SceneDataset(scenes, 8, 2).get_batch([1, 0, 2])
    got = tds.SceneDataset(scenes, 8, 2, device="cpu").get_batch([1, 0, 2])
    for k in got.__dataclass_fields__:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(n(a), n(b), err_msg=k)
    # NA buckets: every scene keeps its agents up to the largest bucket
    want = jds.SceneDataset(scenes, 8, 2, buckets=(4, 8)).get_batch([2, 1],
                                                                   na=8)
    got = tds.SceneDataset(scenes, 8, 2, buckets=(4, 8),
                           device="cpu").get_batch([2, 1], na=8)
    for k in got.__dataclass_fields__:
        a, b = getattr(got, k), getattr(want, k)
        if a is not None:
            np.testing.assert_array_equal(n(a), n(b), err_msg=k)


@pytest.mark.parametrize("split", ["val", "train"])
def test_load_environment_matches(split):
    cfg = argparse.Namespace(
        data_version="synthetic", agent_types=["truck", "car"],
        reduce_cats=False, synth_scenes=3, past_len=4, future_len=FT,
        max_agents=8, na_buckets=None)
    jd, jst, jlg, jsn, jan = j_load(cfg, split, load_lanegraph=True)
    td, tst, tlg, tsn, tan = t_load(cfg, split, load_lanegraph=True,
                                    device="cpu")
    assert len(td) == len(jd) == 3
    got, want = td.get_batch([0, 1, 2]), jd.get_batch([0, 1, 2])
    for k in got.__dataclass_fields__:
        np.testing.assert_array_equal(n(getattr(got, k)),
                                      n(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(n(tst.raster), n(jst.raster))
    assert tst.map_names == jst.map_names
    assert sorted(tlg) == sorted(jlg)
    for name in tlg:
        np.testing.assert_array_equal(tlg[name]["xy"], jlg[name]["xy"])
        assert tlg[name]["in_edges"] == jlg[name]["in_edges"]
    np.testing.assert_array_equal(tsn.mean_np, np.asarray(jsn.mean))
    np.testing.assert_array_equal(tan.std_np, np.asarray(jan.std))
    # real nuScenes reads the ETL directory: absent, both raise alike
    cfg.data_version, cfg.data_dir = "mini", "/nonexistent"
    with pytest.raises(FileNotFoundError):
        j_load(cfg, split)
    with pytest.raises(FileNotFoundError):
        t_load(cfg, split, device="cpu")


# ---- the kernels' shapes on this path ---------------------------------------

def test_sampling_crops_every_pose_of_a_step_in_one_call(setup, monkeypatch):
    """A rollout step of ``sample_batched`` crops all B x NS x NA poses in
    one call (one K1 launch on the card): 1 + FT calls a sampling."""
    from strive_tpu_torch.model import traffic_model as ttm

    _, _, scene, _, _, tm, tsc, ts, _ = setup
    sizes = []

    def spy(packed, dx, pos, *a, **k):
        sizes.append(pos.shape[0])
        return tq.get_map_crop(packed, dx, pos, *a, **k)

    monkeypatch.setattr(ttm, "get_map_crop", spy)
    with torch.no_grad():
        tm.sample_batched(tsc, ts, NS, eps=torch.zeros(
            (scene.B, NS, scene.NA, 32)))
    assert sizes == [scene.B * scene.NA] + [scene.B * NS * scene.NA] * FT


def test_solution_k2_args_are_the_avoid_loss(monkeypatch):
    """``kernel_cases.solution_k2`` (the inputs chip_smoke.py and the card
    tests hold K2 to at the solution loss's shape) is what
    ``avoid_coll_loss(single_veh_idx=0)`` hands ``get_coll_point``: one car
    a scene, its poses interpolated x3."""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.geometry import interp_traj
    from strive_tpu_torch.losses import penalties

    store, args = kc.solution_k2("cpu")
    _, scene, (smean, sstd, amean, astd) = kc._full_width_scene("cpu", 16)
    seen = []

    def spy(*a, **k):
        seen.append(a)
        return tq.get_coll_point(*a, **k)

    monkeypatch.setattr(penalties, "get_coll_point", spy)
    fut = scene.future_gt[..., :4] * sstd + smean
    tadv.avoid_coll_loss(
        fut, torch.zeros(4, 16, 2), (torch.zeros(4, 16, 2),
                                     torch.ones(4, 16, 2)),
        lw=scene.lw * astd + amean, mask=scene.mask, mapixes=scene.map_idx,
        packed=store.packed, dx=store.dx, init_z=torch.zeros(4, 16, 2),
        weights={"coll_env": 10.0}, single_veh_idx=0)
    (got,) = seen
    assert got[2].shape == (4 * 48, 4) == args[2].shape
    for a, b in zip(got[:5], args[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(torch.equal(got[2], interp_traj(fut[:, :1], 3).reshape(-1, 4)))
