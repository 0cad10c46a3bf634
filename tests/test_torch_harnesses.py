"""The port's timing harnesses on the CPU at a tiny size: ``bench`` (one
JSON line with bench.py's keys), ``bench_closed_loop`` in both modes,
``profile_breakdown`` and ``ablate_hotpath`` (their lines), each at
``STRIVE_BENCH_B=1``, ``_NA=2``, ``_ITERS=2`` with bench.py's model widths.
The times they print here are the host's; only their shape is checked.
``ablate_hotpath``'s frozen and gather-only variants are held to the
rollout of a model that never refreshes its map within the 12 steps.
"""

import json
from pathlib import Path

import pytest
import torch

from strive_tpu_torch.scripts import (ablate_hotpath, bench,
                                      bench_closed_loop, profile_breakdown)

torch.set_num_threads(2)  # tier-1 runs several workers
ROOT = Path(__file__).resolve().parents[1]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "vs_estimated_baseline", "baseline_note")


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setenv("STRIVE_BENCH_B", "1")
    monkeypatch.setenv("STRIVE_BENCH_NA", "2")
    monkeypatch.setenv("STRIVE_BENCH_ITERS", "2")


def lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_bench_prints_one_json_line(tiny, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    out = lines(capsys)
    assert len(out) == 1
    res = json.loads(out[0])
    source = (ROOT / "bench.py").read_text()
    assert all(f'"{k}":' in source for k in BENCH_KEYS)
    assert tuple(res) == BENCH_KEYS
    assert res["metric"] == "adv_latent_optim_iters_per_sec"
    assert res["unit"] == "iters/sec (B=1 scenes x NA=2, FT=12, 256px crops)"
    assert res["value"] > 0


@pytest.mark.parametrize("modes", [None, "fused", "host,tpu-chunked"])
def test_bench_closed_loop_prints_each_mode(tiny, monkeypatch, capsys,
                                            modes):
    if modes:
        monkeypatch.setenv("STRIVE_BENCH_MODES", modes)
    assert bench_closed_loop.main(["--device", "cpu"]) == 0
    out = lines(capsys)
    want = {None: ["host ", "device", "device-planner speedup vs host: "],
            "fused": ["device"], "host,tpu-chunked": ["host ", "device"]}
    assert [ln[:len(p)] for ln, p in zip(out, want[modes])] == want[modes]
    assert len(out) == len(want[modes])
    assert all("2 closed-loop iters in" in ln for ln in out[:2]
               if not ln.startswith("device-planner"))


def test_profile_breakdown_prints_each_layer(tiny, capsys):
    assert profile_breakdown.main(["--device", "cpu"]) == 0
    out = lines(capsys)
    assert [ln.split(":")[0] for ln in out] == [
        "crop 2 agents 256x256x4", "map CNN 2 crops", "interaction net",
        "decode rollout (FT=12)", "decode + grad"]
    assert "plain path" in out[0] and "plain (CPU) path" in out[0]
    # the rollouts by the program's spans (on the CPU: each span's own
    # host ms under the profiler)
    for line in out[3:]:
        assert "host ms under the profiler; own host ms by span: " in line
        assert all(f"{name} " in line for name in (
            "map.crop", "map.cnn", "decode.gnn", "decode.bicycle",
            "decode.gru", "model.decode"))


def test_ablate_hotpath_prints_each_variant(tiny, capsys):
    assert ablate_hotpath.main(["--device", "cpu"]) == 0
    out = lines(capsys)
    assert [ln.split(":")[0] for ln in out] == [
        "full (map re-encode in loop)", "ablated (frozen map feature)",
        "crop gather, no CNN", "in-loop map encode share", "  gather"]


def test_ablated_rollouts_keep_the_initial_map_feature():
    """Frozen and gather-only decode as a model whose map is re-encoded
    only after the last of its 12 steps; the full rollout differs."""
    w = bench.workload("cpu", 1, 2)
    model, emb = w["model"], w["emb"]
    z = emb["prior_out"][0]

    def rollout():
        with torch.no_grad():
            return model.decode_embedding(z, emb, w["scene"],
                                          w["store"])["future_pred"]
    full = rollout()
    with ablate_hotpath.frozen_map(model, emb["map_feat"]):
        frozen = rollout()
    with ablate_hotpath.gather_only(model, emb["map_feat"]):
        gathered = rollout()
    model.map_refresh_every = bench.FT
    try:
        never = rollout()
    finally:
        model.map_refresh_every = 1
    assert torch.equal(frozen, never) and torch.equal(gathered, never)
    assert not torch.allclose(full, never)
    assert "encode_map" not in vars(model)  # the model's own is back
