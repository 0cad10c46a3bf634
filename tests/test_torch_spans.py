"""The port's spans (``strive_tpu_torch.utils.spans``) and the benchmark's
reduction of them (``benchmark/metrics/_spans.py``), on the CPU.

- With no profiler a span builds no ``record_function`` and records
  nothing.
- Under a CPU ``torch.profiler``, one adversarial iteration and one
  training step at the tests' tiny widths record the spans' vocabulary
  with the right parents, FT ``decode.gnn`` spans a decode, and records
  that match the profiler's own user annotations (name, order, starts on
  the same clock: within 1 ms at the median); a span cut by the
  profiler's start or stop is not kept.
- The outputs are bit-identical with and without the profiler.
- The reduction counts the units, leaves out phases outside a recorded
  unit and reads nothing without a unit; the device-time reduction
  places a kernel by its launch.
"""

import importlib.util
import statistics
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strive_tpu_torch.data.synthetic import synthetic_scene_list
from strive_tpu_torch.maps.store import synthetic_map_store
from strive_tpu_torch.model.traffic_model import NormConfig, TrafficModel
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.optim.adv import run_adv_gen_optim
from strive_tpu_torch.scene import pad_scene_arrays
from strive_tpu_torch.scripts.bench import WEIGHTS
from strive_tpu_torch.scripts.common import init_params
from strive_tpu_torch.train import Trainer
from strive_tpu_torch.utils import spans

torch.set_num_threads(2)  # tier-1 runs several workers
ROOT = Path(__file__).resolve().parents[1]
FT = 6
CATS = ("car", "truck")
TRAIN_WEIGHTS = {"recon": 1.0, "kl": 0.004, "coll_veh_prior": 0.05,
                 "coll_env_prior": 0.1}


def _reduction():
    spec = importlib.util.spec_from_file_location(
        "bench_spans", ROOT / "benchmark" / "metrics" / "_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    sn, an = state_normalizer_for(CATS), att_normalizer_for(CATS)
    model = TrafficModel(npast=4, nfuture=FT, map_obs_size_pix=64,
                         nclasses=2,
                         norm=NormConfig.from_normalizers(sn, an),
                         map_bounds=(-4.0, -8.0, 12.0, 8.0),
                         conv_kernels=(5, 3, 3), conv_strides=(2, 2, 2),
                         conv_filters=(8, 8, 16), map_channels=3,
                         device="cpu")
    init_params(model)
    store = synthetic_map_store(num_maps=2, size_px=512, channels=3,
                                device="cpu")
    scenes = synthetic_scene_list(num_scenes=2, num_maps=2, map_size_px=512,
                                  PT=4, FT=FT, min_agents=4, max_agents=4)
    scene = pad_scene_arrays(scenes, 4, 2, device="cpu")
    return {"model": model, "store": store, "scene": scene, "sn": sn,
            "an": an}


def _adv(w, iters=1):
    with torch.no_grad():
        emb = w["model"].embed(w["scene"], w["store"])
    prior = emb["prior_out"]
    return run_adv_gen_optim(
        w["model"], prior[0], 0.05, WEIGHTS, w["scene"], w["store"], iters,
        emb, "ego", (prior[0][:, 0], prior[1][:, 0]), prior, 2, None)


def _train(w):
    tr = Trainer(w["model"], TRAIN_WEIGHTS, w["sn"], w["an"], lr=1e-3)
    before = [p.detach().clone() for p in tr.params]
    try:
        metrics = tr.train_step(w["scene"], w["store"], 0.004,
                                *tr.draw_noise(w["scene"]))
        after = [p.detach().clone() for p in tr.params]
    finally:
        with torch.no_grad():
            for p, q in zip(tr.params, before):
                p.copy_(q)
    return metrics, after


def _epoch(w):
    """One ``run_epoch`` of one step, the parameters restored after."""
    tr = Trainer(w["model"], TRAIN_WEIGHTS, w["sn"], w["an"], lr=1e-3)
    before = [p.detach().clone() for p in tr.params]
    try:
        out, _ = tr.run_epoch(iter([w["scene"]]), w["store"], 0.004)
    finally:
        with torch.no_grad():
            for p, q in zip(tr.params, before):
                p.copy_(q)
    return out


def _profiled(fn):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    rec = spans.records()
    spans.clear()
    return out, rec, prof


def _names(rec):
    return [r.name for r in rec]


def _chain(rec, i):
    """Names of record i and its recorded ancestors, innermost first."""
    out = []
    while i is not None:
        out.append(rec[i].name)
        i = rec[i].parent
    return out


def test_no_profiler_no_record_function(monkeypatch, tiny):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans.clear()
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        pass
    _adv(tiny)
    _epoch(tiny)
    assert spans.records() == []


def test_adversarial_iteration_spans(tiny):
    _, rec, _ = _profiled(lambda: _adv(tiny, iters=2))
    names = _names(rec)
    for name in ("model.embed", "adv.grad", "model.decode", "decode.gnn",
                 "decode.bicycle", "decode.gru", "map.crop", "map.cnn",
                 "loss.tgt", "loss.adv", "pull.adv", "adv.adam",
                 "adv.final"):
        assert name in names, name
    grad = names.index("adv.grad")
    assert rec[grad].parent is None
    # one backward pass an iteration: a single pull under each unit
    units = [i for i, r in enumerate(rec) if r.name == "adv.grad"]
    pulls = [r for r in rec if r.name.startswith("pull.")]
    assert len(units) == 2
    assert [r.name for r in pulls] == ["pull.adv"] * 2
    assert [r.parent for r in pulls] == units
    decodes = [i for i, r in enumerate(rec) if r.name == "model.decode"]
    assert len(decodes) == 3  # the iterations' and the final one
    inner = decodes[0]
    assert rec[inner].parent == grad
    gnn = [i for i, r in enumerate(rec) if r.name == "decode.gnn"
           and r.parent == inner]
    assert len(gnn) == FT
    assert _chain(rec, gnn[0]) == ["decode.gnn", "model.decode", "adv.grad"]
    assert _chain(rec, decodes[1]) == ["model.decode", "adv.grad"]
    assert _chain(rec, decodes[2])[-1] == "adv.final"
    crops = [i for i, r in enumerate(rec) if r.name == "map.crop"]
    assert _chain(rec, crops[0]) == ["map.crop", "model.embed"]
    assert _chain(rec, crops[1])[1:] == ["model.decode", "adv.grad"]
    for name in ("loss.tgt", "loss.adv", "pull.adv"):
        assert _chain(rec, names.index(name)) == [name, "adv.grad"]
    for r in rec:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = rec[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_training_step_spans(tiny):
    _, rec, _ = _profiled(lambda: _epoch(tiny))
    step = _names(rec).index("train.step")
    kids = [r.name for r in rec if r.parent == step]
    assert kids == ["train.noise", "train.forward", "train.loss",
                    "train.backward", "train.adam", "train.read",
                    "train.read"]
    decodes = [i for i, r in enumerate(rec) if r.name == "model.decode"]
    assert len(decodes) == 2  # posterior and prior sample
    assert all(_chain(rec, i) == ["model.decode", "train.forward",
                                  "train.step"] for i in decodes)
    assert sum(r.name == "decode.gnn" for r in rec) == 2 * FT


def test_records_match_the_profilers_annotations(tiny):
    def both():
        _adv(tiny)
        return _epoch(tiny)

    _, rec, prof = _profiled(both)
    ann = sorted((e.start_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation()
                 and e.device_type() == torch.autograd.DeviceType.CPU)
    assert [n for _, n in ann] == _names(rec)
    # the record's clock read and the profiler's are a few us apart, on
    # the same clock; a loaded host can preempt the process between them
    # (one scheduler tick, ~4 ms), so single records get that much slack
    gaps = [abs(s - r.start_ns) for (s, _), r in zip(ann, rec)]
    assert statistics.median(gaps) < 1_000_000
    assert max(gaps) < 50_000_000


def test_outputs_bit_identical_under_the_profiler(tiny):
    plain = _adv(tiny, iters=2)
    traced, _, _ = _profiled(lambda: _adv(tiny, iters=2))
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    (m0, p0), ((m1, p1), _, _) = _train(tiny), _profiled(lambda: _train(tiny))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_spans_cut_by_the_profiler_are_not_kept():
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    with spans.span("before"):     # entered with no profiler
        prof.start()
        with spans.span("whole"):
            with spans.span("inner"):
                pass
        cut = spans.span("cut")
        cut.__enter__()
        with spans.span("kept_in_cut"):
            pass
    outer = spans.span("outer")   # entered while recording, ends after stop
    outer.__enter__()
    with spans.span("child"):
        pass
    prof.stop()
    outer.__exit__(None, None, None)
    cut.__exit__(None, None, None)
    rec = spans.records()
    spans.clear()
    assert _names(rec) == ["whole", "inner", "kept_in_cut", "child"]
    assert [r.parent for r in rec] == [None, 0, None, None]


def test_reduction_on_hand_made_records():
    red = _reduction()
    R = spans.Record
    ms = 1_000_000
    rec = [R("adv.grad", 0, 100 * ms, None, 1),
           R("model.decode", 1 * ms, 41 * ms, 0, 1),
           R("pull.tgt", 50 * ms, 60 * ms, 0, 1),
           R("adv.grad", 200 * ms, 300 * ms, None, 1),
           R("model.decode", 201 * ms, 221 * ms, 3, 1),
           R("pull.adv", 230 * ms, 250 * ms, 3, 1),
           # a phase of a unit cut by the profiler's start: no unit above it
           R("model.decode", 400 * ms, 900 * ms, None, 1),
           R("pull.tgt", 910 * ms, 990 * ms, None, 1)]
    assert red.units(rec, "adv.grad") == 2
    assert red.per_unit_ms(rec, "adv.grad", ("model.decode",)) == \
        pytest.approx(30.0)
    assert red.per_unit_ms(rec, "adv.grad", ("pull.tgt", "pull.adv")) == \
        pytest.approx(15.0)
    # a phase nested deeper under its unit counts too
    deep = rec + [R("pull.tgt", 2 * ms, 4 * ms, 1, 1)]
    assert red.per_unit_ms(deep, "adv.grad", ("pull.tgt",)) == \
        pytest.approx(6.0)
    assert red.per_unit_ms(rec[6:], "adv.grad", ("model.decode",)) is None
    assert red.per_unit_ms([], "train.step", ("train.adam",)) is None
    assert red.units(rec, "train.step") == 0


def test_reduction_reads_the_programs_records(tiny):
    red = _reduction()

    class Run:
        profile = None  # an untraced run

    spans.clear()
    assert red.read_ms(Run(), "adv.grad", ("model.decode",)) is None
    Run.profile = {"units": 1}
    assert red.read_ms(Run(), "adv.grad", ("model.decode",)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        _adv(tiny)
    try:
        got = red.read_ms(Run(), "adv.grad", ("model.decode",))
    finally:
        spans.clear()
    assert got is not None and got > 0


def test_device_time_goes_to_the_launching_span():
    ms = 1_000_000
    sp = [(0, 100 * ms, 7, "adv.grad"), (10 * ms, 40 * ms, 7, "model.decode"),
          (20 * ms, 30 * ms, 7, "decode.gnn"),
          (50 * ms, 90 * ms, 7, "pull.tgt")]
    ops = [(5 * ms, 6 * ms, 7, "aten::empty", 5, 0, 1),  # before node 5
           (21 * ms, 22 * ms, 7, "aten::mm", 5, 0, 1),    # made node 5
           (23 * ms, 24 * ms, 7, "aten::add", 6, 0, 1),
           (95 * ms, 96 * ms, 7, "MmBackward0", 5, 1, 1),  # node 5 itself
           # autograd's engine on thread 9: MmBackward0 of op 5 of thread 1
           (60 * ms, 70 * ms, 9, "autograd::engine::evaluate_function: "
            "MmBackward0", 5, 1, 2),
           (71 * ms, 72 * ms, 9, "autograd::engine::evaluate_function: "
            "XBackward0", 99, 1, 2)]
    launches = {1: (21 * ms, 7), 2: (61 * ms, 9), 3: (35 * ms, 7),
                4: (71 * ms, 9), 5: (120 * ms, 7)}
    dev = [(2000, 1), (3000, 2), (500, 3), (700, 4), (900, 5), (100, 77)]
    got = spans.attribute(sp, ops, launches, dev)
    assert got == pytest.approx({
        "decode.gnn": 2e-6, "decode.gnn (backward)": 3e-6,
        "model.decode": 5e-7, spans.OUTSIDE: 1.7e-6})


def test_record_function_only_in_the_span_module():
    """The port names its phases through ``utils.spans`` alone; the two
    profiling scripts may open the profiler's own."""
    pkg = ROOT / "strive_tpu_torch"
    found = {str(f.relative_to(pkg)) for f in pkg.rglob("*.py")
             if "record_function" in f.read_text()}
    assert "utils/spans.py" in found
    assert found <= {"utils/spans.py", "scripts/train_traffic.py",
                     "scripts/profile_breakdown.py"}
