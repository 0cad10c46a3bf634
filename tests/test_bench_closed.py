"""The closed-loop cell (``benchmark/drivers/closed.py``) at a tiny size on
the CPU: the tiny widths of ``benchmark/tests/tiny.py`` on the four maps
at an eighth of their extents, lanes every 64 m.

- A sound run reads ``correct``; the control (the reference in TF32 and
  the reference planner with ``final_tuned_val_1``) and the planner's
  faults (``benchmark/planner_faults.py``: the others ignored, a plan held
  from the batch's first call) do not.
- The planner's spans (``planner.rollout`` under ``adv.grad``,
  ``planner.others`` and ``planner.ego`` inside it) are recorded while a
  profiler records and not otherwise, and the closed loop's outputs are
  bit-identical with and without the profiler.
- ``device_planner.COUNTS``: a call a refresh and one for the final
  decode, and the pose-edge pairs of the lane match: every agent's pose
  at every one of a call's 31 plan steps against every stacked edge; on
  the CPU every pose is matched by the plain functions, none by the
  kernel, and no call replays a CUDA graph. On a card the planner counts
  each scene's poses against its own map's edges: 186,484,096 pairs a
  call at the cell's shapes. A replay (a stand-in for the CUDA graph on
  the CPU) counts the work its capture counted.
- ``plan_rollout`` can be captured in a CUDA graph: one call at the
  cell's scene layout runs no operation that reads a value to the host,
  and makes every tensor on its inputs' device (on the CPU and on
  ``meta``, where no value exists to read).
- The reader ``planner_replay_share.closed`` reads ``replays`` over
  ``calls``, and ``planner_match_kernel_share.closed`` ``kernel_matches``
  over ``matches``; each nothing without its counters.
"""

import contextlib
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from benchmark.drivers import closed
from benchmark.harness import BENCH, Run, load_json
from benchmark.inputs import lanes
from benchmark.run import load_metric
from benchmark.planner_faults import FAULTS, fault
from benchmark.tests import tiny
from strive_tpu_torch.planners import device_planner as dp
from strive_tpu_torch.planners import lane_match
from strive_tpu_torch.utils import spans

CELL = "adv_closed_b4"


def _cfg():
    cfg = tiny.config("strive_adv_rule_nusc")
    st = cfg["store"]
    st["extents_m"] = {k: [v[0] / 8, v[1] / 8]
                       for k, v in st["extents_m"].items()}
    st["spacing_m"] = 64.0
    return cfg


def _run():
    return Run(CELL, _cfg(), tiny.traffic(CELL), 2 ** 31 + 5, 0.0, False,
               torch.device("cpu"))


def correct(run):
    return all(math.isfinite(v) and v <= lim for _, v, lim in run.checks)


def _checked(check=True):
    run = _run()
    closed.setup(run)
    closed.window(run)
    closed.release(run)
    if check:
        closed.check(run)
    return run


@pytest.fixture(scope="module")
def sound():
    return _checked()


def test_sound_run_is_correct(sound):
    names = [n for n, _, _ in sound.checks]
    assert "planner_gap_m" in names and "planner_far_share" in names
    assert correct(sound)


def test_control_is_not_correct(sound):
    got = closed.reference_numbers(sound, "tf32")
    limits = sound.traffic["check"]["limits"]
    assert got["planner_far_share"] > limits["planner_far_share"]
    assert any(got[n] > limits[n] for n in limits
               if not n.startswith("planner"))


@pytest.mark.parametrize("name", FAULTS)
def test_planner_fault_is_not_correct(name):
    with fault(name):
        run = _checked(check=False)
    closed.check(run)
    assert not correct(run)


@pytest.fixture(scope="module")
def program():
    run = _run()
    closed.setup(run)
    return run


def _one_batch(run, iters=2):
    out = closed._optimize(run, run.state["batches"][0], iters)
    return out


def _profiled(run):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = _one_batch(run)
    rec = spans.records()
    spans.clear()
    return out, rec


def test_planner_spans_under_the_profiler_only(program):
    spans.clear()
    plain = _one_batch(program)
    assert spans.records() == []
    out, rec = _profiled(program)
    names = [r.name for r in rec]
    assert names.count("planner.rollout") == 2   # a refresh an iteration
    assert names.count("planner.others") == names.count("planner.ego") == 3
    for i, r in enumerate(rec):
        if r.name == "planner.rollout":
            assert rec[r.parent].name == "adv.grad"
        if r.name in ("planner.others", "planner.ego"):
            up = [rec[j].name for j in _chain(rec, i)]
            assert up[0] in ("planner.rollout", "adv.final")
    for k in ("z", "result", "losses"):
        assert torch.equal(plain[k], out[k]), k
    for (p0, o0), (p1, o1) in zip(plain["calls"], out["calls"]):
        assert torch.equal(p0, p1) and torch.equal(o0, o1)


def _chain(rec, i):
    out, p = [], rec[i].parent
    while p is not None:
        out.append(p)
        p = rec[p].parent
    return out


def test_match_pair_counts(program):
    st = program.state
    before = dict(dp.COUNTS)
    _one_batch(program, iters=3)
    got = {k: v - before[k] for k, v in dp.COUNTS.items()}
    B, NA = program.cfg["batch_size"], program.cfg["max_agents"]
    steps = 31  # 6 s of future at dt 0.2, the first action included
    calls = 3 + 1
    E = {m: len(st["lanes"][m]["edges"]) for m in st["lanes"]}
    assert got["calls"] == calls
    assert got["match_pairs"] == calls * steps * B * NA * sum(E.values())


def test_cpu_poses_matched_by_the_plain_functions(program):
    before = dict(dp.COUNTS)
    _one_batch(program, iters=3)
    got = {k: v - before[k] for k, v in dp.COUNTS.items()}
    B, NA = program.cfg["batch_size"], program.cfg["max_agents"]
    assert got["matches"] == 4 * 31 * B * NA  # 4 calls of 31 plan steps
    assert got["kernel_matches"] == 0


def test_own_map_pairs_at_the_cell_shapes():
    """The pairs the kernel computes a call in ``adv_closed_b4``: scene j
    on map j (of 4), each scene's 16 agents at 31 plan steps (the others
    batched, the ego step by step) against its map's edges."""
    cfg = load_json(BENCH / "configs" / "strive_adv_rule_nusc.json")
    st = cfg["store"]
    edges = [lanes.edge_count(min(st["extents_m"][m]), st["spacing_m"],
                              cfg["lane_graph"]["res_m"]) for m in st["maps"]]
    assert sum(edges) == 375_976
    B, NA = cfg["batch_size"], cfg["max_agents"]
    mids = [j % len(edges) for j in range(B)]
    assert dp.own_map_pairs(edges, mids, 31 * NA) == 186_484_096
    # a map id outside the tables has no edges to scan
    assert dp.own_map_pairs(edges, [0, 4, -1], 10) == 10 * edges[0]


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: capture runs the call once,
    a replay runs nothing."""

    def replay(self):
        pass


def test_replay_counts_what_its_capture_counted(monkeypatch):
    monkeypatch.setitem(lane_match.LAUNCHES, "lane_match", 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())

    def rollout(tab, cfg, init_state, *a):
        dp.COUNTS["calls"] += 1
        dp.COUNTS["match_pairs"] += 5
        dp.COUNTS["matches"] += 7
        dp.COUNTS["kernel_matches"] += 3
        lane_match.LAUNCHES["lane_match"] += 2
        return init_state * 2

    args = [torch.ones(2, 3, 4)] + [torch.zeros(1)] * 5
    before = dict(dp.COUNTS)
    launched = lane_match.LAUNCHES["lane_match"]
    graph = dp._CapturedRollout(rollout, None, None, args, 30)
    # a capture is not a rollout, and launches nothing
    assert dp.COUNTS == before
    assert lane_match.LAUNCHES["lane_match"] == launched
    for _ in range(3):
        out = graph([a + 1 for a in args])
    got = {k: v - before[k] for k, v in dp.COUNTS.items()}
    assert got == {"calls": 3, "match_pairs": 15, "matches": 21,
                   "kernel_matches": 9, "replays": 3}
    # each replay runs the captured launches
    assert lane_match.LAUNCHES["lane_match"] - launched == 6
    assert torch.equal(out, torch.full((2, 3, 4), 2.0))  # the capture's


def test_cpu_planner_takes_no_graph(program):
    before = dict(dp.COUNTS)
    _one_batch(program, iters=3)
    got = {k: v - before[k] for k, v in dp.COUNTS.items()}
    assert got["calls"] == 4 and got["replays"] == 0
    assert program.state["planner"]._graph is None


# operations that read a tensor's value to the host: a CUDA graph cannot
# capture them (the host would read the capture's, not the replay's)
HOST_READS = {"_local_scalar_dense", "item", "nonzero", "masked_select",
              "unique", "_unique", "_unique2", "unique_consecutive",
              "unique_dim", "equal", "is_nonzero", "allclose"}


class _Watched(TorchDispatchMode):
    """The operations dispatched inside, by name, and the devices of the
    tensors they make."""

    def __init__(self):
        super().__init__()
        self.ops, self.devices = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(func.overloadpacket.__name__)
        self.devices.update(t.device for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
        return out


def _rollout_args(program, monkeypatch):
    """``plan_rollout``'s arguments at a batch's first planner call, as
    ``closed._planner_fn`` makes it."""
    got, orig = [], dp.plan_rollout

    def kept(*a):
        got.append(a)
        return orig(*a)

    monkeypatch.setattr(dp, "plan_rollout", kept)
    scene = program.state["batches"][0]
    closed._planner_fn(program, scene)(scene.future_gt[..., :4])
    monkeypatch.undo()
    return got[0]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plan_rollout_is_capture_safe(program, monkeypatch, device):
    tab, cfg, *args = _rollout_args(program, monkeypatch)
    to = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x
    tab, args = dp.DeviceTables(*map(to, tab)), [to(a) for a in args]
    with _Watched() as w:
        out = dp.plan_rollout(tab, cfg, *args)
    assert out.shape == (program.cfg["batch_size"], 31, 4)
    assert not w.ops & HOST_READS, w.ops & HOST_READS
    assert w.devices == {torch.device(device)}


def test_replay_share_reader(monkeypatch):
    read = load_metric("planner_replay_share.closed").read
    traced = SimpleNamespace(profile={})
    monkeypatch.setattr(dp, "COUNTS", {"calls": 21, "match_pairs": 7})
    assert read(traced) is None
    monkeypatch.setattr(dp, "COUNTS", {"calls": 21, "match_pairs": 7,
                                       "replays": 20})
    assert read(traced) == 20 / 21
    assert read(SimpleNamespace(profile=None)) is None
    monkeypatch.setattr(dp, "COUNTS", {"calls": 0, "match_pairs": 0,
                                       "replays": 0})
    assert read(traced) is None


def test_match_kernel_share_reader(monkeypatch):
    read = load_metric("planner_match_kernel_share.closed").read
    traced = SimpleNamespace(profile={})
    monkeypatch.setattr(dp, "COUNTS", {"calls": 21, "match_pairs": 7,
                                       "replays": 20})
    assert read(traced) is None
    monkeypatch.setattr(dp, "COUNTS", {"calls": 21, "match_pairs": 7,
                                       "matches": 40, "kernel_matches": 30,
                                       "replays": 20})
    assert read(traced) == 0.75
    assert read(SimpleNamespace(profile=None)) is None
    monkeypatch.setattr(dp, "COUNTS", {"calls": 0, "match_pairs": 0,
                                       "matches": 0, "kernel_matches": 0,
                                       "replays": 0})
    assert read(traced) is None
