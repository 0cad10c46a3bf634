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
  the CPU no call replays a CUDA graph.
- ``plan_rollout`` can be captured in a CUDA graph: one call at the
  cell's scene layout runs no operation that reads a value to the host,
  and makes every tensor on its inputs' device (on the CPU and on
  ``meta``, where no value exists to read).
- The reader ``planner_replay_share.closed`` reads ``replays`` over
  ``calls``, and nothing without the counter.
"""

import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from benchmark.drivers import closed
from benchmark.harness import Run
from benchmark.run import load_metric
from benchmark.planner_faults import FAULTS, fault
from benchmark.tests import tiny
from strive_tpu_torch.planners import device_planner as dp
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
