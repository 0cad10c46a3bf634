"""The port's device planner (``planners/device_planner.py``) on the CPU.

- the lane tables that ``DeviceTables.from_graphs`` builds equal
  strive_tpu's ``build_lane_tables`` / ``stack_lane_tables``, field by
  field, bit for bit and dtypes included (``emap`` in the port's int64), on
  the graphs below and on the closed-loop benchmark cell's connector grid
  (a turn connector each way at every crossing) at a small extent;
- the cases of tests/test_tpu_planner.py, held against the port's host
  planner at that file's decision-parity tolerances: 0.5 m and 5 degrees
  (1.0 m and 8 degrees on the ring), the sweep's median and max;
- ``DeviceRulePlanner.rollout_batch`` against strive_tpu's
  ``TpuRulePlanner.rollout_batch`` on the same inputs (two maps, padded
  agents, an observation that ends early, a negative ego speed; and
  ego-only scenes): within 1e-4 m in position and 1e-4 rad in heading.
  Both compute in float32 with the same formulas, in another order (XLA's
  fused reductions and its own sin, cos and atan2), so they agree to a few
  ulps of the coordinates: 1.5e-5 m is one ulp at 128-256 m. The scenes
  keep every ego on its lane for the whole plan. An ego that drives off
  the end of the lane graph keeps the heading it had there (the
  constant-heading fallback), and a heading that differs by float noise
  (~2e-5 rad, the warp grid's 0.4 m knot spacing at ~256 m coordinates)
  then turns into a drift that grows with the distance driven: 1.2e-3 m
  after 22 steps in a random scene of this kind. No decision flip (a jump
  far beyond float noise) has been seen; one would be recorded in
  ROADMAP.md's queue of faults;
- the searchsorted interpolation against the compare-sum form on knots
  with repeats, and argmin ties resolving to the first edge;
- the lane match's dispatch: on CPU tensors ``_match_reps`` is the plain
  ``_cluster_reps(*_match_edges(...))`` (the kernel's wrapper raises on
  them); each map's edges are contiguous in the stacked tables from
  ``edge_offsets``, the range the kernel scans.
"""

import copy

import numpy as np
import pytest
import torch

import strive_tpu.maps.lanegraph as jlg
import strive_tpu.planners.tpu_planner as jtp
from benchmark.harness import BENCH, load_json
from benchmark.inputs import lanes
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.normalize import state_normalizer_for
from strive_tpu_torch.planners import (PLANNER_CONFIGS, PlannerConfig,
                                       RulePlanner)
from strive_tpu_torch.planners import device_planner as dp
from strive_tpu_torch.planners import lane_match

GRAPHS = {
    "grid": lambda m: m.synthetic_lanegraph(extent_m=256.0, spacing_m=64.0),
    "forks": lambda m: m.synthetic_lanegraph_forks(),
    "ring": lambda m: m.synthetic_lanegraph_ring(),
}
CFG = PLANNER_CONFIGS["default"]


@pytest.fixture(scope="module")
def graphs():
    return {k: f(tlg) for k, f in GRAPHS.items()}


@pytest.fixture(scope="module")
def lg(graphs):
    return graphs["grid"]


def _cfg():
    return dp.StaticPlanCfg.from_planner_config(PlannerConfig(**CFG))


def _tables(lg):
    return dp.DeviceTables.from_graphs({"m": lg}, ["m"], _cfg(), "cpu")


def _connector_grid():
    """``benchmark/inputs/lanes.py``'s graph on one 256 m map at 64 m
    spacing: four lanes a band, a turn connector each way at every
    crossing, a vertex every metre."""
    st = copy.deepcopy(load_json(BENCH / "configs"
                                 / "strive_adv_rule_nusc.json")["store"])
    st["extents_m"] = {"boston-seaport": [256.0, 256.0]}
    st["maps"] = ["boston-seaport"]
    st["spacing_m"] = 64.0
    return lanes.graph(st, "boston-seaport")


def _graph_pair(name):
    """The graph ``name`` as each package builds it (the connector grid:
    one dict for both)."""
    if name == "connectors":
        g = _connector_grid()
        return g, g
    return GRAPHS[name](tlg), GRAPHS[name](jlg)


def _assert_tables_equal(got, want):
    """Each field of ``DeviceTables`` that holds lane tables equal to
    strive_tpu's ``LaneTables`` field of that name."""
    for f in dp.DeviceTables._fields[:6]:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "emap":
            b = b.astype(np.int64)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("graph", list(GRAPHS) + ["connectors"])
def test_build_lane_tables_equal(graph):
    tg, jg = _graph_pair(graph)
    _assert_tables_equal(_tables(tg), jtp.build_lane_tables(jg))


def test_stack_lane_tables_equal():
    names = ["grid", "forks", "ring", "forks"]
    pairs = {n: _graph_pair(n) for n in set(names)}
    _assert_tables_equal(
        dp.DeviceTables.from_graphs({n: p[0] for n, p in pairs.items()},
                                    names, _cfg(), "cpu"),
        jtp.stack_lane_tables([jtp.build_lane_tables(pairs[n][1])
                               for n in names]))


# --- the cases of tests/test_tpu_planner.py, against the host planner ------


def _host_rollout(lg, init_state, lw, other_obs, obs_t, cfg=CFG):
    planner = RulePlanner({"m": lg}, ["m"], cfg)
    NA = init_state.shape[0]
    planner.reset(init_state, lw, np.zeros(NA, np.int64), 1,
                  np.zeros(1, np.int64))
    return planner.rollout(other_obs[1:], obs_t, np.array([0, NA - 1]),
                           obs_t)[0]


def _dev_rollout(lg, init_state, lw, other_obs, obs_t, cfg=CFG):
    planner = dp.DeviceRulePlanner({"m": lg}, ["m"], cfg, device="cpu")
    NA = init_state.shape[0]
    planner.reset(init_state[None], lw[None], np.ones((1, NA), bool),
                  np.zeros(1, np.int64))
    return planner.rollout_batch(other_obs[None], obs_t, obs_t)[0].numpy()


def _scene(NA=3, seed=0, T=12, dt=0.5):
    """Agents driving along the grid's y=128 lane row."""
    rng = np.random.default_rng(seed)
    speeds = rng.uniform(3.0, 8.0, NA)
    ys = 128.0 + rng.uniform(-1.0, 1.0, NA)
    xs = 40.0 + np.arange(NA) * 25.0 + rng.uniform(-3, 3, NA)
    return _obs_along([lambda t, a=a: (xs[a] + speeds[a] * t, ys[a], 1.0, 0.0)
                       for a in range(NA)], speeds, T, dt)


def _obs_along(path_fn, speeds, T=12, dt=0.5):
    """Observed futures of agents moving along parametric paths
    ``fn(t) -> (x, y, hx, hy)``."""
    NA = len(path_fn)
    obs_t = np.arange(1, T + 1) * dt
    obs = np.full((NA, T, 4), np.nan, np.float32)
    init = np.zeros((NA, 6), np.float32)
    for a, f in enumerate(path_fn):
        init[a] = [*f(0.0), speeds[a], 0.0]
        for i, t in enumerate(obs_t):
            obs[a, i] = f(t)
    return init, np.full((NA, 2), [4.5, 2.0], np.float32), obs, obs_t


def _parity(lg, init, lw, obs, obs_t, tol_pos=0.5, tol_deg=5.0):
    host = _host_rollout(lg, init, lw, obs, obs_t)
    dev = _dev_rollout(lg, init, lw, obs, obs_t)
    assert np.isfinite(dev).all()
    pos_err = np.linalg.norm(host[:, :2] - dev[:, :2], axis=-1)
    assert pos_err.max() < tol_pos, f"max position divergence {pos_err.max()}"
    cosang = np.sum(host[:, 2:4] * dev[:, 2:4], axis=-1)
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))).max() < tol_deg
    return host, dev


@pytest.mark.parametrize("seed", [0, 3])
def test_decision_parity_straight_lanes(lg, seed):
    _parity(lg, *_scene(NA=3, seed=seed))


def test_single_agent_follows_lane(lg):
    init, lw, obs, obs_t = _scene(NA=1, seed=1)
    _, dev = _parity(lg, init, lw, obs, obs_t)
    assert dev[-1, 0] - init[0, 0] > 5.0  # it moves forward along the lane


def test_off_lane_constant_heading(lg):
    init, lw, obs, obs_t = _scene(NA=1, seed=2)
    init[0, :2] = 30.0  # between grid lines
    _parity(lg, init, lw, obs, obs_t)


def test_parity_fork_trunk(graphs):
    _parity(graphs["forks"],
            *_obs_along([lambda t: (20.0 + 6.0 * t, 50.0, 1.0, 0.0)], [6.0]))


def test_parity_fork_oncoming_branch(graphs):
    """An agent on the non-main fork branch interacts with the ego near the
    fork: the prediction fan needs the branch-coded chains."""
    curve_x = lambda t: 60.0 + 20 * np.sin(0.25 + 0.12 * t)
    curve_y = lambda t: 50.0 + 40 * (1 - np.cos(0.25 + 0.12 * t))

    def b_agent(t):
        dx = curve_x(t + 0.3) - curve_x(t)
        dy = curve_y(t + 0.3) - curve_y(t)
        n = np.hypot(dx, dy) + 1e-9
        return (curve_x(t), curve_y(t), dx / n, dy / n)

    _parity(graphs["forks"], *_obs_along(
        [lambda t: (30.0 + 7.0 * t, 50.0, 1.0, 0.0), b_agent], [7.0, 3.0]))


def test_parity_ring(graphs):
    R, cx, cy = 40.0, 64.0, 64.0
    w = 5.0 / R

    def ego(t):
        a = 0.1 + w * t
        return (cx + R * np.cos(a), cy + R * np.sin(a), -np.sin(a), np.cos(a))

    _parity(graphs["ring"], *_obs_along([ego], [5.0]), tol_pos=1.0,
            tol_deg=8.0)


def test_parity_interaction_brakes(graphs):
    """A slow leader on the ego's lane: both planners brake, and the ego
    does not rear-end it."""
    init, lw, obs, obs_t = _obs_along(
        [lambda t: (30.0 + 7.0 * t, 50.0, 1.0, 0.0),
         lambda t: (48.0 + 1.0 * t, 50.0, 1.0, 0.0)], [7.0, 1.0])
    _, dev = _parity(graphs["forks"], init, lw, obs, obs_t)
    assert dev[-1, 0] - init[0, 0] < 6.0 * 0.5 * len(obs_t)
    assert np.all(48.0 + 1.0 * obs_t - dev[:, 0] > 2.0)


def test_parity_randomized_sweep(graphs):
    rng = np.random.default_rng(7)
    errs = []
    for graph, lanes in [
        ("grid", [((40.0, 128.0), (1.0, 0.0)), ((128.0, 40.0), (0.0, 1.0)),
                  ((60.0, 64.0), (1.0, 0.0))]),
        ("forks", [((10.0, 50.0), (1.0, 0.0)), ((70.0, 50.0), (1.0, 0.0)),
                   ((110.0, 50.0), (1.0, 0.0))]),
    ]:
        for _ in range(4):
            fns, speeds = [], []
            for _ in range(int(rng.integers(1, 4))):
                (x0, y0), (hx, hy) = lanes[int(rng.integers(len(lanes)))]
                x0 = x0 + rng.uniform(-5, 15)
                y0 = y0 + rng.uniform(-1.0, 1.0)
                s = rng.uniform(2.0, 8.0)
                fns.append(lambda t, x0=x0, y0=y0, hx=hx, hy=hy, s=s:
                           (x0 + hx * s * t, y0 + hy * s * t, hx, hy))
                speeds.append(s)
            init, lw, obs, obs_t = _obs_along(fns, speeds)
            host = _host_rollout(graphs[graph], init, lw, obs, obs_t)
            dev = _dev_rollout(graphs[graph], init, lw, obs, obs_t)
            errs.append(np.linalg.norm(host[:, :2] - dev[:, :2], axis=-1))
    errs = np.concatenate(errs)
    assert np.median(errs) < 0.25
    assert errs.max() < 1.0


def test_reversing_other_predicted_stopping(lg):
    """A reversing other agent's fan stays near its observed position: at
    speed 0 (the clamp of PARITY.md §16) and at a raw negative speed, whose
    fan distances clamp to the route-closest point."""
    cfg = _cfg()
    tab = _tables(lg)
    pos = np.array([100.0, 128.0])
    for s in (0.0, -5.0):
        ocirc, ovalid = dp._others_step_data(
            torch.tensor([[[pos[0], pos[1], 0.0, s]]]),
            torch.ones((1, 1), dtype=torch.bool), torch.tensor([[[4.5, 2.0]]]),
            torch.zeros(1, dtype=torch.int64), tab, cfg)
        centers = ocirc[0][:, ovalid[0], :, :2].reshape(-1, 2).numpy()
        d = np.linalg.norm(centers - pos, axis=-1)
        assert ovalid.any() and d.max() < 4.0, f"s={s} fan escaped to {d.max()}"


def test_rollout_with_reversing_agent_and_negative_ego_speed(lg):
    """A reversing lead agent and a negative initial ego speed: finite, and
    the ego brakes instead of driving into the closing reverser."""
    T, dt = 12, 0.5
    obs_t = np.arange(1, T + 1) * dt
    init = np.zeros((2, 6), np.float32)
    init[0] = [40.0, 128.0, 1.0, 0.0, -2.0, 0.0]
    init[1] = [70.0, 128.0, 1.0, 0.0, -4.0, 0.0]
    obs = np.full((2, T, 4), np.nan, np.float32)
    obs[1] = np.stack([70.0 - 4.0 * obs_t, np.full(T, 128.0), np.ones(T),
                       np.zeros(T)], -1)
    lw = np.full((2, 2), [4.5, 2.0], np.float32)
    dev = _dev_rollout(lg, init, lw, obs, obs_t)
    assert np.isfinite(dev).all()
    rev_x = np.interp(obs_t, np.concatenate([[0.0], obs_t]),
                      np.concatenate([[70.0], obs[1, :, 0]]))
    ego_dx = np.diff(np.concatenate([[40.0], dev[:, 0]]))
    close = rev_x - dev[:, 0] < 8.0
    assert np.all(ego_dx[close] < 0.3)
    assert np.abs(dev[-1, 0] - dev[-2, 0]) < 0.3


def test_make_fn_contract(lg):
    """``make_fn`` takes the model's normalized (B, NA, FT, 4) prediction
    and returns the normalized (B, FT, 4) planner future; a prediction on
    another device than the planner's raises."""
    norm = state_normalizer_for(("car", "truck"))
    init, lw, obs, _ = _scene(NA=3, seed=4, T=6)
    planner = dp.DeviceRulePlanner({"m": lg}, ["m"], CFG, device="cpu")
    planner.reset(init[None], lw[None], np.ones((1, 3), bool),
                  np.zeros(1, np.int64))
    fn = planner.make_fn(norm, 0.5, 6)
    pred = torch.from_numpy(norm.normalize(obs[None]))
    out = fn(pred)
    assert out.shape == (1, 6, 4) and torch.isfinite(out).all()
    assert torch.equal(pred, torch.from_numpy(norm.normalize(obs[None])))
    with pytest.raises(ValueError):
        fn(pred.to("meta"))


# --- against strive_tpu's TpuRulePlanner ----------------------------------


def _batch(rng, grid, ring, B, NA, T=12, dt=0.5):
    """Scenes alternating between the 256 m grid (map 0) and the ring
    (map 1): agents on random edges in the first 100 m of their lane,
    heading along it, observed driving straight on. Every ego stays on its
    lane for the whole plan (module docstring)."""
    obs_t = np.arange(1, T + 1) * dt
    init = np.zeros((B, NA, 6), np.float32)
    obs = np.zeros((B, NA, T, 4), np.float32)
    lane_edges = len(grid["edges"]) // 12  # 3 rows x 4 lanes of equal length
    for b in range(B):
        g = (grid, ring)[b % 2]
        e = rng.integers(0, len(g["edges"]), NA)
        if b % 2 == 0:
            e = e // lane_edges * lane_edges + e % 50
        e = g["edges"][e]
        xy = e[:, :2] + rng.uniform(0.2, 0.8, (NA, 1)) * e[:, 4:] * e[:, 2:4]
        xy += rng.uniform(-0.5, 0.5, (NA, 2))
        s = rng.uniform(0.0, 8.0, NA)
        init[b] = np.concatenate([xy, e[:, 2:4], s[:, None],
                                  np.zeros((NA, 1))], -1)
        obs[b, :, :, :2] = xy[:, None] + (s[:, None, None] * obs_t[:, None]
                                          * e[:, None, 2:4])
        obs[b, :, :, 2:] = e[:, None, 2:4]
    lw = np.stack([rng.uniform(4, 5.5, (B, NA)), rng.uniform(1.8, 2.2, (B, NA))],
                  -1).astype(np.float32)
    return init, lw, obs, obs_t, np.arange(B) % 2


@pytest.mark.parametrize("NA", [4, 1], ids=["agents", "ego_only"])
def test_rollout_batch_matches_strive_tpu(NA):
    rng = np.random.default_rng(11)
    graphs = {m.__name__: [GRAPHS["grid"](m), GRAPHS["ring"](m)]
              for m in (tlg, jlg)}
    init, lw, obs, obs_t, map_idx = _batch(rng, *graphs[tlg.__name__], 3, NA)
    mask = np.ones((3, NA), bool)
    if NA > 1:
        mask[2, 2:] = False      # padded agents
        obs[0, 1, 7:] = np.nan   # an observation that ends early
        init[1, 0, 4] = -1.5     # a negative ego speed (clamped to 0)
    names = ["grid", "ring"]
    jp = jtp.TpuRulePlanner(dict(zip(names, graphs[jlg.__name__])), names,
                            jtp.PlannerConfig(**CFG))
    jp.reset(init, lw, mask, map_idx)
    want = np.asarray(jp.rollout_batch(obs, obs_t, obs_t))
    tp = dp.DeviceRulePlanner(dict(zip(names, graphs[tlg.__name__])), names,
                              CFG, device="cpu")
    tp.reset(init, lw, mask, map_idx)
    got = tp.rollout_batch(obs, obs_t, obs_t).numpy()
    assert got.shape == want.shape == (3, len(obs_t), 4)
    assert np.isfinite(got).all()
    pos = np.linalg.norm(got[..., :2] - want[..., :2], axis=-1)
    ang = np.abs(np.angle(np.exp(1j * (np.arctan2(got[..., 3], got[..., 2])
                                       - np.arctan2(want[..., 3],
                                                    want[..., 2])))))
    assert pos.max() < 1e-4, f"position {pos.max()} m, scenes {pos.max(1)}"
    assert ang.max() < 1e-4, f"heading {ang.max()} rad"
    moved = np.linalg.norm(got[:, -1, :2] - init[:, 0, :2], axis=-1)
    assert (moved > 1.0).any()  # some ego actually drives


# --- interpolation and ties ------------------------------------------------


def test_searchsorted_interp_matches_compare_sum():
    """The searchsorted interval equals the compare-sum count on knots with
    repeats (JAX's form), and the two-gather lerp equals the one-hot
    masked-sum read bit for bit."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.05, 0.5, 64)).astype(np.float32)
    t[10:13] = t[10]   # repeated knots
    t[40:42] = t[40]
    t -= t[20]
    vals = rng.normal(size=(64, 4)).astype(np.float32)
    tq = np.concatenate([rng.uniform(t[0] - 1.0, t[-1] + 1.0, 37),
                         t[[0, 10, 11, 12, 40, 41, 63]]]).astype(np.float32)
    got = dp._interp_cols(torch.from_numpy(tq), torch.from_numpy(t),
                          torch.from_numpy(vals)).numpy()
    # the compare-sum form, written out in numpy float32
    i = np.clip((t[None] <= tq[:, None]).sum(1) - 1, 0, 62)
    oh0 = (i[:, None] == np.arange(64)).astype(np.float32)
    oh1 = (i[:, None] + 1 == np.arange(64)).astype(np.float32)
    t0, t1 = (oh0 * t).sum(1), (oh1 * t).sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(t1 > t0, (tq - t0) / np.maximum(t1 - t0, 1e-9), 0.0)
    w = np.clip(w, 0.0, 1.0).astype(np.float32)
    v0, v1 = oh0 @ vals, oh1 @ vals
    want = (1.0 - w)[:, None] * v0 + w[:, None] * v1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.asarray(jtp._interp_cols(tq, t, vals)), rtol=0, atol=1e-6)


def test_argmin_ties_pick_the_first_edge():
    """A pose exactly between two parallel lanes of equal heading: the ego's
    closest-match pick and the first cluster representative take the lower
    edge id (``jnp.argmin``'s first index), and the second lane stays a
    representative of its own (2 m apart, not < dedupe_r)."""
    xs = np.arange(0.0, 41.0, 2.0)
    g = tlg._GraphBuilder()
    g.add_chain([(x, 0.0) for x in xs])   # edges 0..19 at y = 0
    g.add_chain([(x, 2.0) for x in xs])   # edges 20..39 at y = 2
    cfg = _cfg()
    tab = _tables(g.build())
    x, y, h = (torch.tensor([v]) for v in (11.0, 1.0, 0.0))
    mid = torch.zeros(1, dtype=torch.int64)
    ok, cx, cy, dist = dp._match_edges(x, y, h, mid, tab, cfg)
    assert dist[0, 5] == dist[0, 25] == dist[ok].min()  # the exact tie
    reps, rep_valid = dp._cluster_reps(ok, cx, cy, dist, cfg)
    assert reps[0].tolist()[:2] == [5, 25] and rep_valid[0, :2].all()
    t2, vals, has = dp._ego_spline(x, y, h, mid, tab, cfg)
    assert has.item()
    assert abs(vals[0, -1, 1].item()) < 1e-5  # the y = 0 lane's route


@pytest.mark.parametrize("MC", [3, 1])
def test_match_reps_on_the_cpu_is_the_plain_composition(graphs, MC):
    names = ["grid", "forks", "ring"]
    cfg = _cfg()
    tab = dp.DeviceTables.from_graphs(graphs, names, cfg, "cpu")
    rng = np.random.default_rng(MC)
    N = 96
    # near random edges, most on the edge's map, some headed off its lane
    e = tab.edges.numpy()
    i = rng.integers(0, e.shape[0], N)
    t = rng.uniform(0.0, 1.0, N) * e[i, 4]
    x, y = (torch.as_tensor(e[i, k] + t * e[i, k + 2]
                            + rng.normal(0.0, 0.7, N), dtype=torch.float32)
            for k in (0, 1))
    h = torch.as_tensor(np.arctan2(e[i, 3], e[i, 2])
                        + rng.normal(0.0, 0.3, N), dtype=torch.float32)
    mid = tab.emap[i].clone()
    mid[::8] = torch.as_tensor(rng.integers(-1, 4, 12))
    before = dict(dp.COUNTS)
    reps, valid = dp._match_reps(x, y, h, mid, tab, cfg, MC)
    got = {k: v - before[k] for k, v in dp.COUNTS.items()}
    assert got["matches"] == N and got["kernel_matches"] == 0
    assert got["match_pairs"] == N * tab.edges.shape[0]
    want = dp._cluster_reps(*dp._match_edges(x, y, h, mid, tab, cfg),
                            cfg._replace(MC=MC))
    assert reps.shape == (N, MC) and torch.equal(reps, want[0])
    assert torch.equal(valid, want[1])
    assert valid[:, 0].any() and not valid[:, 0].all()


def test_lane_match_kernel_takes_cuda_tensors_only(lg):
    tab = _tables(lg)
    cfg = _cfg()
    x = torch.zeros(3)
    mid = torch.zeros(3, dtype=torch.int64)
    launched = lane_match.LAUNCHES["lane_match"]
    with pytest.raises(ValueError, match="CUDA"):
        lane_match.lane_match(x, x, x, x, mid, tab.edge_offsets, tab.edges,
                              cfg.cdistmax, cfg.xydistmax, cfg.dedupe_r, 3)
    assert lane_match.LAUNCHES["lane_match"] == launched


def test_edge_offsets_bound_each_maps_edges(graphs):
    names = ["grid", "forks", "ring", "forks"]
    tab = dp.DeviceTables.from_graphs(graphs, names, _cfg(), "cpu")
    off = tab.edge_offsets.tolist()
    assert tab.edge_offsets.dtype == torch.int64
    assert off[0] == 0 and off[-1] == tab.edges.shape[0]
    for m, name in enumerate(names):
        assert off[m + 1] - off[m] == len(graphs[name]["edges"])
        assert (tab.emap[off[m]:off[m + 1]] == m).all()
    planner = dp.DeviceRulePlanner(graphs, names, CFG, device="cpu")
    assert planner.map_edges == np.diff(off).tolist()


def test_card_pairs_worked_out_from_the_poses_matched(graphs, monkeypatch):
    """On a card a call's ``match_pairs`` are each scene's poses against
    its own map's edges, worked out from the poses the call matched; a
    call that matched an uneven count a scene raises. The card's call is
    a stand-in here that only counts its matches."""
    names = ["grid", "forks", "ring"]
    planner = dp.DeviceRulePlanner(graphs, names, CFG, device="cpu")
    planner.device = torch.device("cuda")
    planner._mids = [2, 0, 2, 5]  # map 5 lies outside the tables
    matched = []

    def plan_cuda(fn, args, Tsteps):
        dp.COUNTS["matches"] += matched[-1]
        return None

    monkeypatch.setattr(planner, "_plan_cuda", plan_cuda)
    before = dp.COUNTS["match_pairs"]
    matched.append(4 * 31)
    planner._plan((), 30)
    edges = [len(graphs[n]["edges"]) for n in names]
    assert dp.COUNTS["match_pairs"] - before == 31 * (2 * edges[2]
                                                      + edges[0])
    matched.append(4 * 31 + 1)
    with pytest.raises(RuntimeError, match="as many a scene"):
        planner._plan((), 30)
