"""The port's numpy planner modules against strive_tpu's.

- ``maps.lanegraph``'s synthetic builders: arrays equal;
- ``losses.metrics``: the cases of tests/test_metrics.py, and
  ``oriented_box_iou`` / ``check_single_veh_coll`` equal to strive_tpu's on
  random boxes;
- ``planners.hardcode``: the cases of tests/test_planner.py, and
  ``RulePlanner.rollout`` equal to strive_tpu's bit for bit on random
  scenes on the three synthetic lane graphs;
- ``planners.host_bridge``: equal to strive_tpu's ``make_planner_host_fn``
  on a batch with a fully masked padding scene.

The modules are numpy copies, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import strive_tpu.losses.metrics as jm
import strive_tpu.maps.lanegraph as jlg
from strive_tpu.normalize import state_normalizer_for as j_state_norm
from strive_tpu.planners import RulePlanner as JRulePlanner
from strive_tpu.planners.host_bridge import make_planner_host_fn as j_host_fn
from strive_tpu_torch.losses.metrics import (
    box_corners, check_pairwise_veh_coll, check_single_veh_coll,
    convex_quad_intersection_area, oriented_box_iou)
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.maps.lanegraph import synthetic_lanegraph
from strive_tpu_torch.normalize import state_normalizer_for
from strive_tpu_torch.planners import (PLANNER_CONFIGS, PlannerConfig,
                                       RulePlanner)
from strive_tpu_torch.planners.hardcode import (
    approx_bbox_distance, boxes2circles, cluster_matches_combine,
    compute_speed_profile, expand_verts, gen_sprofiles, get_lane_matches,
    get_prediction_splines, postprocess_act_for_speed, score_dists,
    sprof2dists, xyh2speed)
from strive_tpu_torch.planners.host_bridge import (make_planner_host_fn,
                                                   reset_planner)

BUILDERS = {
    "grid": lambda m: m.synthetic_lanegraph(extent_m=256.0, spacing_m=64.0),
    "forks": lambda m: m.synthetic_lanegraph_forks(),
    "ring": lambda m: m.synthetic_lanegraph_ring(),
}
CDIST20 = 1.0 - np.cos(np.radians(20.0))


@pytest.mark.parametrize("graph", list(BUILDERS))
def test_synthetic_lanegraphs_equal(graph):
    t, j = BUILDERS[graph](tlg), BUILDERS[graph](jlg)
    assert sorted(t) == sorted(j)
    for k in ("xy", "edges", "edgeixes"):
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    assert t["in_edges"] == j["in_edges"]
    assert t["out_edges"] == j["out_edges"]


# --- losses.metrics (tests/test_metrics.py) --------------------------------


def quad(cx, cy, l, w, h=0.0):
    state = np.array([cx, cy, np.cos(h), np.sin(h)])
    return box_corners(state[None], np.array([[l, w]]))[0]


@pytest.mark.parametrize("case", [
    ("identical", quad(0, 0, 4, 2), quad(0, 0, 4, 2), 8.0),
    ("disjoint", quad(0, 0, 4, 2), quad(100, 100, 4, 2), 0.0),
    ("half_overlap", quad(0, 0, 4, 2), quad(2, 0, 4, 2), 4.0),
    ("contained", quad(0, 0, 2, 1), quad(0, 0, 10, 10), 2.0),
    ("contains", quad(0, 0, 10, 10), quad(0, 0, 2, 1), 2.0),
    ("rotated", quad(0, 0, 2, 2), quad(0, 0, 2, 2, h=np.pi / 4),
     8 * (np.sqrt(2) - 1)),
], ids=lambda c: c[0])
def test_quad_intersection(case):
    _, A, B, area = case
    np.testing.assert_allclose(
        convex_quad_intersection_area(A[None], B[None])[0], area, atol=1e-6)


def test_iou_known():
    lw = np.array([[4.0, 2.0]])
    iou = oriented_box_iou(np.array([[0.0, 0.0, 1.0, 0.0]]), lw,
                           np.array([[2.0, 0.0, 1.0, 0.0]]), lw)
    np.testing.assert_allclose(iou, 4.0 / 12.0, atol=1e-9)


def test_check_single_veh_coll():
    T = 5
    tgt = np.tile(np.array([0.0, 0.0, 1.0, 0.0]), (T, 1))
    # agent 0 collides at t=3, agent 1 never, agent 2 has NaN everywhere
    others = np.tile(np.array([100.0, 0.0, 1.0, 0.0]), (3, T, 1))
    others[0, 3] = [1.0, 0.0, 1.0, 0.0]
    others[2] = np.nan
    coll, t = check_single_veh_coll(
        tgt, np.array([4.0, 2.0]), others, np.tile([4.0, 2.0], (3, 1)))
    assert coll.tolist() == [True, False, False]
    assert t[0] == 3 and t[1] == T and t[2] == T


def test_check_pairwise():
    traj = np.tile(np.array([0.0, 0.0, 1.0, 0.0]), (3, 3, 1))
    traj[1, :, 0] = 1.0   # overlaps agent 0
    traj[2, :, 0] = 50.0  # far away
    out = check_pairwise_veh_coll(traj, np.tile([4.0, 2.0], (3, 1)))
    assert out["did_collide"].tolist() == [True, False, False]
    assert out["num_coll_veh"] == 1.0


def _random_boxes(rng, shape):
    th = rng.uniform(-np.pi, np.pi, shape)
    s = np.stack([rng.uniform(-4, 4, shape), rng.uniform(-4, 4, shape),
                  np.cos(th), np.sin(th)], -1)
    lw = np.stack([rng.uniform(2, 8, shape), rng.uniform(1, 3, shape)], -1)
    return s, lw


def test_metrics_equal_strive_tpu_on_random_boxes():
    rng = np.random.default_rng(0)
    (sa, la), (sb, lb) = _random_boxes(rng, (400,)), _random_boxes(rng,
                                                                    (400,))
    iou = oriented_box_iou(sa, la, sb, lb)
    np.testing.assert_array_equal(iou, jm.oriented_box_iou(sa, la, sb, lb))
    assert (iou > 0).sum() > 50  # the draw overlaps often enough
    tgt, tlw = _random_boxes(rng, (7,))
    oth, olw = _random_boxes(rng, (9, 7))
    oth[2, 4] = np.nan
    got = check_single_veh_coll(tgt, tlw[0], oth, olw[:, 0])
    want = jm.check_single_veh_coll(tgt, tlw[0], oth, olw[:, 0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- planners.hardcode (tests/test_planner.py) -----------------------------


@pytest.fixture(scope="module")
def lg():
    return synthetic_lanegraph(extent_m=128.0, spacing_m=32.0, res_m=2.0)


def test_speed_profile_clamps():
    up = compute_speed_profile(0.0, 5.0, 2.0, 20, 0.2)
    assert up[0] == 0.0 and up[-1] == 5.0 and np.all(np.diff(up) >= 0)
    down = compute_speed_profile(5.0, 1.0, 2.0, 10, 0.2)
    assert down[0] == 5.0 and down[-1] == 1.0 and np.all(np.diff(down) <= 0)
    np.testing.assert_allclose(compute_speed_profile(3.0, 3.0, 2.0, 4, 0.2),
                               3.0)


def test_sprof2dists():
    np.testing.assert_allclose(sprof2dists(np.array([2.0, 2.0, 2.0]), 0.5),
                               [0.0, 1.0, 2.0])


def test_gen_sprofiles_count():
    profs = gen_sprofiles(5.0, 0.2, 25, [1.0], 3.0, 15.0, 5)
    assert len(profs) == 25  # NS * NS per accfac
    for p in profs:
        assert len(p["sprof"]) == 26
        assert np.all(p["sprof"] >= 0) and np.all(p["sprof"] <= 15.0 + 1e-9)


def test_boxes2circles_cover():
    c = boxes2circles(np.array([[[0.0, 0.0, 0.0, 4.0, 2.0]]]))
    assert c.shape == (1, 1, 5, 3)
    np.testing.assert_allclose(c[0, 0, 4], [0, 0, 1.0])  # center: w/2
    assert np.abs(c[0, 0, :4, 0]).max() <= 2.0


def test_approx_bbox_distance_sign():
    ego = np.array([[[0.0, 0.0, 0.0, 4.0, 2.0]]])
    near = np.array([[[1.0, 0.0, 0.0, 4.0, 2.0]]])
    far = np.array([[[30.0, 0.0, 0.0, 4.0, 2.0]]])
    assert approx_bbox_distance(ego, near)[0, 0] < 0  # overlapping
    assert approx_bbox_distance(ego, far)[0, 0] > 20  # clear


def test_score_dists():
    p = score_dists(np.array([-1.0, 0.0, 50.0]), 0.7, 0.05)
    assert p[0] == 1.0 and p[1] == 1.0 and p[2] < 1e-6


def test_lane_matches(lg):
    m = get_lane_matches(64.0, 32.0, 0.0, lg, CDIST20, 2.0)  # +x lane y=32
    assert m["ixes"].shape[0] > 0
    m2 = get_lane_matches(64.0, 32.0, np.pi, lg, CDIST20, 2.0)
    for close in m2["closest"]:
        assert abs(close[1] - 32.0) > 1.0  # matches only the -x lane


def test_postprocess_exact_speed():
    x, y, h = postprocess_act_for_speed(0, 0, 0.0, 1.1, 0.2, 0.1, 5.0, 0.2)
    assert abs(xyh2speed(0, 0, x, y, h, 0.2) - 5.0) < 1e-6


def _one_scene_rollout(lg, init_state, T):
    planner = RulePlanner({"m0": lg}, ["m0"],
                          PlannerConfig(**PLANNER_CONFIGS["default"]))
    planner.reset(init_state, np.array([[4.5, 2.0], [4.5, 2.0]]),
                  np.array([0, 0]), 1, np.array([0]))
    agent_t = np.linspace(0.5, 0.5 * T, T)
    obs = np.tile(init_state[1, :4], (1, T, 1))
    return planner.rollout(obs, agent_t, np.array([0, 1]), agent_t)


def test_rollout_straight_lane(lg):
    # ego on the y=32 +x lane at 5 m/s; one other far away
    out = _one_scene_rollout(lg, np.array([[20.0, 32.0, 1.0, 0.0, 5.0, 0.0],
                                           [100.0, 96.0, 1.0, 0.0, 0.0, 0.0]]),
                             6)
    assert out.shape == (1, 6, 4)
    assert np.all(np.diff(out[0, :, 0]) > 0)
    assert np.abs(out[0, :, 1] - 32.0).max() < 2.0
    np.testing.assert_allclose(np.linalg.norm(out[0, :, 2:], axis=-1), 1.0,
                               atol=1e-6)


def test_rollout_brakes_for_blocker(lg):
    init_state = np.array([[20.0, 32.0, 1.0, 0.0, 8.0, 0.0],
                           [45.0, 32.0, 1.0, 0.0, 0.0, 0.0]])
    blocked = _one_scene_rollout(lg, init_state, 8)
    init_state[1, 0] = 120.0  # the blocker out of the way
    free = _one_scene_rollout(lg, init_state, 8)
    assert blocked[0, -1, 0] < free[0, -1, 0] - 1.0
    assert blocked[0, -1, 0] < 45.0


def test_cluster_matches_dedup(lg):
    m = get_lane_matches(64.0, 32.0, 0.0, lg, CDIST20, 2.0)
    clustered = cluster_matches_combine(64.0, 32.0, m, lg)
    assert 1 <= clustered["ixes"].shape[0] <= m["ixes"].shape[0]
    orig = {tuple(e) for e in m["ixes"]}
    assert all(tuple(e) in orig for e in clustered["ixes"])


def test_expand_verts_reaches_distance(lg):
    lanes = expand_verts(0, lg["xy"], lg["out_edges"], mindist=20.0)
    assert len(lanes) >= 1
    for lane in lanes:
        assert lane["l"] > 20.0 or len(lg["out_edges"][lane["v"][-1]]) == 0


def test_prediction_splines_pass_through_pose(lg):
    x, y, h = 64.0, 33.0, 0.1  # near the y=32 lane, slightly offset
    m = cluster_matches_combine(
        x, y, get_lane_matches(x, y, h, lg, CDIST20, 2.0), lg)
    splines = get_prediction_splines(m, lg, backdist=5.0, fordist=40.0,
                                     xydistmax=2.0, egoxy=np.array([x, y]),
                                     egoh=h)
    assert len(splines) >= 1
    for sp in splines:
        at0 = sp(np.array([0.0]))[0]
        assert np.hypot(at0[0] - x, at0[1] - y) < 0.5
        np.testing.assert_allclose(at0[2:], [np.cos(h), np.sin(h)], atol=1e-9)


def test_constant_heading_fallback():
    empty = {"ixes": np.empty((0, 2), np.int64), "closest": np.empty((0, 2))}
    sp = get_prediction_splines(empty, None, 5.0, 20.0, 2.0,
                                np.array([10.0, 10.0]), 0.5)
    assert len(sp) == 1
    pts = sp[0](np.array([0.0, 10.0]))
    np.testing.assert_allclose(pts[0, :2], [10.0, 10.0], atol=1e-9)
    np.testing.assert_allclose(
        pts[1, :2], [10.0 + 10 * np.cos(0.5), 10.0 + 10 * np.sin(0.5)],
        atol=1e-9)


# --- RulePlanner and the host bridge against strive_tpu --------------------


def lane_scene(rng, lg, B, NA, T=12, dt=0.5):
    """Agents on random edges of ``lg`` with their heading and a few m/s,
    observed driving straight on: (B, NA, 6) init, (B, NA, T, 4) obs."""
    e = lg["edges"][rng.integers(0, len(lg["edges"]), (B, NA))]
    xy = e[..., :2] + rng.uniform(0, 1, (B, NA, 1)) * e[..., 4:5] * e[..., 2:4]
    xy = xy + rng.uniform(-0.7, 0.7, (B, NA, 2))
    s = rng.uniform(0.5, 8.0, (B, NA))
    init = np.concatenate([xy, e[..., 2:4], s[..., None],
                           np.zeros((B, NA, 1))], -1).astype(np.float32)
    obs_t = np.arange(1, T + 1) * dt
    obs = np.concatenate([xy[:, :, None] + (s[..., None, None] * obs_t[:, None])
                          * e[:, :, None, 2:4],
                          np.broadcast_to(e[:, :, None, 2:4], (B, NA, T, 2))],
                         -1).astype(np.float32)
    return init, obs, obs_t


@pytest.mark.parametrize("graph", list(BUILDERS))
def test_rule_planner_rollout_bit_exact(graph):
    rng = np.random.default_rng(5)
    lgt, lgj = BUILDERS[graph](tlg), BUILDERS[graph](jlg)
    cfg = PLANNER_CONFIGS["default"]
    B, NA = 3, 3
    init, obs, obs_t = lane_scene(rng, lgt, B, NA)
    obs[1, 2, 7:] = np.nan  # an agent that leaves the observation
    lw = np.broadcast_to(np.float32([4.5, 2.0]), (B * NA, 2))
    outs = []
    for P, g in ((RulePlanner, lgt), (JRulePlanner, lgj)):
        planner = P({"m": g}, ["m"], cfg)
        planner.reset(init.reshape(B * NA, 6), lw, np.repeat(np.arange(B), NA),
                      B, np.zeros(B, np.int64))
        outs.append(planner.rollout(obs[:, 1:].reshape(-1, 12, 4), obs_t,
                                    np.arange(B + 1) * (NA - 1), obs_t))
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_host_bridge_matches_strive_tpu():
    rng = np.random.default_rng(2)
    lg = BUILDERS["grid"](tlg)
    B, NA, FT = 3, 4, 6
    init, obs, _ = lane_scene(rng, lg, B, NA, T=FT)
    mask = np.ones((B, NA), bool)
    mask[0, 3:] = False
    mask[2] = False  # a fully masked padding scene
    lw = np.broadcast_to(np.float32([4.5, 2.0]), (B, NA, 2))
    map_idx = np.array([0, 1, 0])
    norm = state_normalizer_for(("car", "truck"))
    pred = norm.normalize(obs)  # (B, NA, FT, 4) normalized
    graphs = {"a": lg, "b": lg}
    planner = RulePlanner(graphs, ["a", "b"], PLANNER_CONFIGS["default"])
    reset_planner(planner, torch.from_numpy(init), lw, mask, map_idx)
    got = make_planner_host_fn(planner, torch.from_numpy(mask), norm, 0.5,
                               FT)(torch.from_numpy(pred))
    jplanner = JRulePlanner(graphs, ["a", "b"], PLANNER_CONFIGS["default"])
    counts = np.maximum(mask.sum(1), 1)
    jplanner.reset(np.concatenate([s[:n] for s, n in zip(init, counts)]),
                   np.concatenate([a[:n] for a, n in zip(lw, counts)]),
                   np.repeat(np.arange(B), counts), B, map_idx)
    want = j_host_fn(jplanner, mask, j_state_norm(("car", "truck")), 0.5,
                     FT)(pred)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == (B, FT, 4) and np.isfinite(want).all()
    np.testing.assert_array_equal(got.numpy(), want)
