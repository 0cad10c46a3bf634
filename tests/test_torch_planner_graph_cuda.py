"""The device planner's CUDA graph on the card: every call of a
``DeviceRulePlanner`` after the first of its shapes replays one captured
graph of ``plan_rollout`` (``planners/device_planner.py``), and its plans
equal the eager ``plan_rollout``'s bit for bit; a replay counts the work
its capture counted (``device_planner.COUNTS``), and the planner counts
each call's lane-match pairs.

Needs an NVIDIA GPU; skips elsewhere. Imports no JAX. Run on the card with

    python -m pytest --noconftest tests/test_torch_planner_graph_cuda.py -q

Scenes: B scenes of NA agents on a 512 m lane grid (64 m apart), each ego
on an eastbound lane with a stopped car 15 m ahead, the other agents on
random lanes, observed driving straight on; each call's prediction moves
them by another draw of noise.
"""

import numpy as np
import pytest
import torch

from benchmark.planner_faults import fault
from strive_tpu_torch.maps.lanegraph import synthetic_lanegraph
from strive_tpu_torch.maps.queries import linspace
from strive_tpu_torch.normalize import state_normalizer_for
from strive_tpu_torch.planners import PLANNER_CONFIGS
from strive_tpu_torch.planners import device_planner as dp

pytestmark = pytest.mark.cuda

DT, FT = 0.5, 12
NAMES = ["a", "b"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def lg():
    return synthetic_lanegraph(extent_m=512.0, spacing_m=64.0)


@pytest.fixture(scope="module")
def norm():
    return state_normalizer_for(("car", "truck"))


def _planner(lg, dev):
    return dp.DeviceRulePlanner({m: lg for m in NAMES}, NAMES,
                                PLANNER_CONFIGS["default"], device=dev)


def _scenes(seed, B, NA):
    """(init (B, NA, 6), lw, mask, map_idx, obs (B, NA, FT, 4)), unnormalized
    (module doc)."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, FT + 1) * DT
    lane = rng.integers(1, 8, (B, NA)) * 64.0
    east = rng.uniform(size=(B, NA)) < 0.5
    east[:, :2] = True
    x = rng.uniform(40.0, 300.0, (B, NA))
    s = rng.uniform(2.0, 9.0, (B, NA))
    lane[:, 1] = lane[:, 0]
    x[:, 1] = x[:, 0] + 15.0
    s[:, 1] = 0.0
    xy = np.where(east[..., None], np.stack([x, lane], -1),
                  np.stack([lane, 512.0 - x], -1))
    h = np.where(east[..., None], [1.0, 0.0], [0.0, -1.0])
    init = np.concatenate([xy, h, s[..., None], np.zeros((B, NA, 1))], -1)
    obs = np.concatenate([xy[:, :, None] + s[..., None, None]
                          * t[:, None] * h[:, :, None],
                          np.broadcast_to(h[:, :, None], (B, NA, FT, 2))], -1)
    lw = np.stack([rng.uniform(4.0, 5.5, (B, NA)),
                   rng.uniform(1.8, 2.2, (B, NA))], -1)
    mask = np.ones((B, NA), bool)
    mask[-1, NA - 2:] = False
    return (init.astype(np.float32), lw.astype(np.float32), mask,
            np.arange(B) % len(NAMES), obs.astype(np.float32))


def _reset(planner, scene):
    planner.reset(*scene[:4])


def _preds(scene, norm, n, dev, seed=0):
    """``n`` normalized predictions of ``scene``'s agents, each moved by
    its own noise."""
    rng = np.random.default_rng(seed)
    obs = scene[4]
    out = []
    for _ in range(n):
        p = obs.copy()
        p[..., :2] += rng.normal(0.0, 0.4, p[..., :2].shape).astype(
            np.float32)
        out.append(torch.as_tensor(norm.normalize(p), device=dev))
    return out


def _eager(planner, fn, pred, norm, dev):
    """What ``make_fn``'s function returns for ``pred``, with the rollout
    ``fn`` called eagerly."""
    smean = torch.as_tensor(norm.mean_np[:4], device=dev)
    sstd = torch.as_tensor(norm.std_np[:4], device=dev)
    fp = pred * sstd + smean
    fp[:, 0] = float("nan")
    plan_t = linspace(DT, DT * FT, FT, dev)
    Tsteps = int(round(DT * FT / planner.cfg.dt))
    st = planner.state
    out = fn(planner.tables, planner.cfg, st["init"], st["lw"], st["mask"],
             fp, plan_t, Tsteps, st["map_idx"])
    out_t = linspace(planner.cfg.dt, planner.cfg.dt * Tsteps, Tsteps + 1,
                     dev)
    return (dp._interp_cols(plan_t, out_t, out) - smean) / sstd


def _counted(f):
    before = dict(dp.COUNTS)
    out = f()
    return out, {k: dp.COUNTS[k] - before[k] for k in dp.COUNTS}


def test_replays_equal_eager_calls(lg, norm, dev):
    planner = _planner(lg, dev)
    scene = _scenes(1, 4, 8)
    _reset(planner, scene)
    fn = planner.make_fn(norm, DT, FT)
    preds = _preds(scene, norm, 6, dev)
    got, counts = _counted(lambda: [fn(p) for p in preds])
    want, eager = _counted(lambda: [_eager(planner, dp.plan_rollout, p,
                                           norm, dev) for p in preds])
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"call {i}"
    assert not torch.equal(got[0], got[1])  # the predictions differ
    # every pose through the lane-match kernel; the planner counts each
    # call's pairs, a scene's poses against its own map's edges (plan_rollout
    # called alone counts none)
    matched = eager["matches"]
    pairs = dp.own_map_pairs(planner.map_edges, scene[3].tolist(),
                             matched // 6 // 4)
    assert counts == {"calls": 6, "match_pairs": 6 * pairs,
                      "matches": matched, "kernel_matches": matched,
                      "replays": 5}
    assert eager == {"calls": 6, "match_pairs": 0, "matches": matched,
                     "kernel_matches": matched, "replays": 0}


def test_first_plan_unchanged_by_later_replays(lg, norm, dev):
    planner = _planner(lg, dev)
    scene = _scenes(2, 4, 8)
    _reset(planner, scene)
    fn = planner.make_fn(norm, DT, FT)
    preds = _preds(scene, norm, 5, dev, seed=1)
    first = fn(preds[0])
    kept = first.clone()
    later = [fn(p) for p in preds[1:]]
    assert torch.equal(first, kept)
    assert all(out.data_ptr() != first.data_ptr() for out in later)


def test_resets_and_a_shape_change(lg, norm, dev):
    planner = _planner(lg, dev)
    calls = []
    for seed, NA in ((3, 8), (4, 8), (5, 6)):
        scene = _scenes(seed, 4, NA)
        _reset(planner, scene)
        fn = planner.make_fn(norm, DT, FT)
        for p in _preds(scene, norm, 3, dev, seed=seed):
            out, n = _counted(lambda: fn(p))
            assert torch.equal(out, _eager(planner, dp.plan_rollout, p,
                                           norm, dev)), (seed, NA)
            calls.append((NA, n["replays"], planner._graph))
    # the first scene: eager, capture + replay, replay; the second (same
    # shapes) replays the same graph; the third (NA 6) starts again
    assert [r for _, r, _ in calls] == [0, 1, 1, 1, 1, 1, 0, 1, 1]
    graphs = [g for _, _, g in calls]
    assert all(g is graphs[1] for g in graphs[2:6])
    assert graphs[8] is graphs[7] is not graphs[1]


def test_faulted_planner_replays_the_fault(lg, norm, dev):
    scene = _scenes(6, 4, 8)
    with fault("ignore_others"):
        planner = _planner(lg, dev)
        _reset(planner, scene)
        fn = planner.make_fn(norm, DT, FT)
        preds = _preds(scene, norm, 3, dev, seed=6)
        got, n = _counted(lambda: [fn(p) for p in preds])
        want = [_eager(planner, dp.plan_rollout, p, norm, dev)
                for p in preds]
    assert n["replays"] == 2
    sound = [_eager(planner, dp.plan_rollout, p, norm, dev) for p in preds]
    for g, w, s in zip(got, want, sound):
        assert torch.equal(g, w)
        assert not torch.equal(g, s)  # the stopped car ahead is ignored
