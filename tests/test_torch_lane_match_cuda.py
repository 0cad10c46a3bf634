"""The device planner's lane-match kernel (``csrc/lane_match.cu``) on the
card: ``device_planner._match_reps`` on CUDA tensors equals the plain
``_cluster_reps(*_match_edges(...))`` on the same CUDA tensors, ids and
validity bit for bit, for MC 3 (the others' clusters) and MC 1 (the ego's
closest match); and the planner's plans are the same whichever computes
the representatives, eagerly and through its CUDA graph's replays.

Needs an NVIDIA GPU; skips elsewhere. Imports no JAX. Run on the card with

    python -m pytest --noconftest tests/test_torch_lane_match_cuda.py -q

Inputs:
- the closed-loop cell's lane graph (``benchmark/inputs/lanes.py``: four
  maps at nuScenes' extents, a vertex every metre, 375,976 edges) and 1,984
  poses, 496 a map (so the maps at both ends of the stacked table too):
  poses at lane vertices with the lane's heading (two edges at distance 0:
  an exact tie), near lanes, near crossings among the turn connectors,
  turned off the lanes' headings, and off every lane; two poses carry map
  ids outside the tables;
- the two-lane tie of ``test_torch_device_planner.py``;
- stacked random tables of short edges crowded around the poses, some of
  length 0: fewer matches a pose than the kernel lists (256) and more, so
  that its rounds run over its list and over the map's whole range;
- for the plans, the scenes of ``test_torch_planner_graph_cuda.py``.
"""

import numpy as np
import pytest
import torch

import test_torch_planner_graph_cuda as graph_cases
from benchmark.harness import BENCH, load_json
from benchmark.inputs import lanes
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.planners import PLANNER_CONFIGS, PlannerConfig
from strive_tpu_torch.planners import device_planner as dp
from strive_tpu_torch.planners import lane_match

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _cfg():
    return dp.StaticPlanCfg.from_planner_config(
        PlannerConfig(**PLANNER_CONFIGS["default"]))


def _plain(x, y, h, mid, tab, cfg, MC):
    return dp._cluster_reps(*dp._match_edges(x, y, h, mid, tab, cfg),
                            cfg._replace(MC=MC))


def _both(x, y, h, mid, tab, MC):
    cfg = _cfg()
    got = dp._match_reps(x, y, h, mid, tab, cfg, MC)
    want = _plain(x, y, h, mid, tab, cfg, MC)
    return got, want


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("reps", "rep_valid")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bad = (g != w).any(1).nonzero().flatten().tolist()
        assert not bad, f"{name} differs at poses {bad[:10]}"


@pytest.fixture(scope="module")
def cell(dev):
    """The cell's tables on the card, and its maps' lane graphs."""
    cfg = load_json(BENCH / "configs" / "strive_adv_rule_nusc.json")
    st = cfg["store"]
    gs = lanes.graphs(st, cfg["lane_graph"]["res_m"])
    tab = dp.DeviceTables.from_graphs(gs, st["maps"], _cfg(), dev)
    return tab, [gs[m] for m in st["maps"]], st


def _cell_poses(graphs, st, seed=7):
    """(x, y, h, mid) numpy, 496 poses a map (module doc)."""
    rng = np.random.default_rng(seed)
    xs, ys, hs, mids = [], [], [], []
    for m, g in enumerate(graphs):
        e = np.asarray(g["edges"], np.float32)
        head = np.arctan2(e[:, 3], e[:, 2])
        ext = min(st["extents_m"][st["maps"][m]])
        lanes_xy = np.arange(st["spacing_m"], ext, st["spacing_m"])
        # at a vertex: the edge's start, with its heading
        i = rng.integers(0, len(e), 124)
        px, py, ph = [e[i, 0]], [e[i, 1]], [head[i]]
        # near a lane, heading within the match's cone or not
        for n, turn in ((124, 0.15), (62, np.pi / 2)):
            i = rng.integers(0, len(e), n)
            t = rng.uniform(0.0, 1.0, n) * e[i, 4]
            px.append(e[i, 0] + t * e[i, 2] + rng.normal(0, 0.8, n))
            py.append(e[i, 1] + t * e[i, 3] + rng.normal(0, 0.8, n))
            ph.append(head[i] + rng.normal(0, turn, n))
        # near a crossing, among the turn connectors
        c = rng.choice(lanes_xy, (124, 2)) - rng.integers(0, 2, (124, 2)) \
            * st["spacing_m"] / 4
        px.append(c[:, 0] + rng.normal(0, 1.5, 124))
        py.append(c[:, 1] + rng.normal(0, 1.5, 124))
        ph.append(rng.integers(0, 4, 124) * np.pi / 2
                  + rng.normal(0, 0.2, 124))
        # off every lane: inside a block, 10 m or more from its lanes
        px.append(rng.integers(0, len(lanes_xy), 62) * st["spacing_m"]
                  + rng.uniform(10, 180, 62))
        py.append(rng.integers(0, len(lanes_xy), 62) * st["spacing_m"]
                  + rng.uniform(10, 180, 62))
        ph.append(rng.uniform(-np.pi, np.pi, 62))
        xs += px
        ys += py
        hs += ph
        mids.append(np.full(496, m))
    mid = np.concatenate(mids)
    mid[[5, 1500]] = (4, -1)
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.float32),
            np.concatenate(hs).astype(np.float32), mid.astype(np.int64))


@pytest.mark.parametrize("MC", [3, 1])
def test_cell_graph(cell, dev, MC):
    tab, graphs, st = cell
    x, y, h, mid = (torch.as_tensor(a, device=dev)
                    for a in _cell_poses(graphs, st))
    assert x.shape[0] == 1984
    before = dict(dp.COUNTS)
    got, want = _both(x, y, h, mid, tab, MC)
    _assert_equal(got, want)
    assert dp.COUNTS["kernel_matches"] - before["kernel_matches"] == 1984
    valid = want[1].cpu()
    # what the poses cover: a match and none (on 1 m lanes 64 m apart a
    # pose has one cluster: the crowded tables below give the others)
    assert not valid[:, 0].all() and valid[:, 0].sum() > 900
    assert not valid[[5, 1500]].any()
    # exact distance ties at the vertices
    ok, _, _, dist = dp._match_edges(x[:124], y[:124], h[:124], mid[:124],
                                     tab, _cfg())
    d = torch.where(ok, dist, dp.BIG)
    ties = ((d == d.min(1, keepdim=True).values) & ok).sum(1) > 1
    assert ties.sum() > 50


def test_two_lane_tie(dev):
    xs = np.arange(0.0, 41.0, 2.0)
    g = tlg._GraphBuilder()
    g.add_chain([(x, 0.0) for x in xs])   # edges 0..19 at y = 0
    g.add_chain([(x, 2.0) for x in xs])   # edges 20..39 at y = 2
    tab = dp.DeviceTables.from_graphs({"m": g.build()}, ["m"], _cfg(), dev)
    x, y, h = (torch.tensor([v], device=dev) for v in (11.0, 1.0, 0.0))
    mid = torch.zeros(1, dtype=torch.int64, device=dev)
    got, want = _both(x, y, h, mid, tab, 3)
    _assert_equal(got, want)
    assert got[0][0, :2].tolist() == [5, 25] and got[1][0, :2].all()


def _crowded(rng, E, n_maps, dev):
    """``n_maps`` stacked tables of E short edges each, their starts within
    2.2 m of the origin, heading east within 0.3 rad; one in ten of length
    0. A stand-in for ``DeviceTables``: the fields the match reads."""
    parts = []
    for _ in range(n_maps):
        r = 2.2 * np.sqrt(rng.uniform(0, 1, E))
        a = rng.uniform(-np.pi, np.pi, E)
        th = rng.normal(0, 0.3, E)
        ln = np.where(rng.uniform(size=E) < 0.1, 0.0, rng.uniform(0.1, 1, E))
        parts.append(np.stack([r * np.cos(a), r * np.sin(a), np.cos(th),
                               np.sin(th), ln], 1))
    edges = torch.as_tensor(np.concatenate(parts), dtype=torch.float32,
                            device=dev)
    emap = torch.arange(n_maps, device=dev).repeat_interleave(E)
    offsets = torch.arange(n_maps + 1, device=dev) * E
    return dp.DeviceTables(edges, emap, *[None] * 7, offsets)


@pytest.mark.parametrize("E", [150, 1200])
def test_crowded_tables(dev, E):
    rng = np.random.default_rng(E)
    tab = _crowded(rng, E, 3, dev)
    N = 192
    x, y = (torch.as_tensor(rng.normal(0, 0.3, N), dtype=torch.float32,
                            device=dev) for _ in range(2))
    h = torch.as_tensor(rng.normal(0, 0.2, N), dtype=torch.float32,
                        device=dev)
    mid = torch.as_tensor(rng.integers(0, 3, N), device=dev)
    for MC in (3, 1):
        got, want = _both(x, y, h, mid, tab, MC)
        _assert_equal(got, want)
        if MC == 3:
            assert want[1][:, 2].sum() > 10  # three clusters
    ok = dp._match_edges(x, y, h, mid, tab, _cfg())[0]
    most = int(ok.sum(1).max())
    # E 150: every pose's matches fit the kernel's list; E 1200: they do not
    assert (most <= 256) == (E == 150), most


def test_plans_equal_plain(dev, monkeypatch):
    """The planner's plans on the card (the first call eager, the second
    capturing and replaying, the rest replays) equal eager ``plan_rollout``
    calls that take the plain functions, bit for bit."""
    lg = graph_cases.synthetic_lanegraph(extent_m=512.0, spacing_m=64.0)
    norm = graph_cases.state_normalizer_for(("car", "truck"))
    planner = graph_cases._planner(lg, dev)
    scene = graph_cases._scenes(11, 4, 8)
    graph_cases._reset(planner, scene)
    fn = planner.make_fn(norm, graph_cases.DT, graph_cases.FT)
    preds = graph_cases._preds(scene, norm, 4, dev, seed=11)
    before = dict(dp.COUNTS)
    launched = lane_match.LAUNCHES["lane_match"]
    got = [fn(p) for p in preds]
    n = {k: dp.COUNTS[k] - before[k] for k in dp.COUNTS}
    launched = lane_match.LAUNCHES["lane_match"] - launched
    monkeypatch.setattr(dp, "_match_reps", _plain)
    want = [graph_cases._eager(planner, dp.plan_rollout, p, norm, dev)
            for p in preds]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"call {i}"
    assert n["replays"] == 3 and n["kernel_matches"] == n["matches"] > 0
    # a call runs the kernel once for the others and once an ego plan step,
    # eager or replayed (the capture, which launches nothing, counts none)
    Tsteps = int(round(graph_cases.DT * graph_cases.FT / planner.cfg.dt))
    assert launched == len(preds) * (1 + Tsteps + 1)
