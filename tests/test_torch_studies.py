"""The port's study scripts against strive_tpu's, on the CPU.

``scripts/study_yield.py`` and ``scripts/study_refresh_quality.py`` are
imported by path (their module level is numpy and the standard library)
and run beside ``strive_tpu_torch.scripts.study_yield`` and
``study_refresh_quality`` on the same inputs: ``subprocess.run`` answers
every pipeline call with a canned summary, and the refresh study reads
scenario folders prepared here (a scene missing from one k, an ``fut_adv``
of another N at another). Their JSONs and printed lines must be equal.
``study_nll_floor``'s JSON line must equal the JAX script's at a small
size. One run of the port's ``study_yield`` goes through its entry point
for real: two points on ``configs/adv_gen_synthetic.cfg`` on the CPU.
"""

import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from strive_tpu_torch.scripts import study_nll_floor as nll_port
from strive_tpu_torch.scripts import study_refresh_quality as refresh_port
from strive_tpu_torch.scripts import study_yield as yield_port

ROOT = Path(__file__).resolve().parents[1]


def script(name):
    """A JAX-package script imported by path (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# canned pipeline summaries by point: one without a feasible scene, one
# whose log lacks the total-time line and the planner's count
SUMMARIES = {
    "closed_it200": "candidates = 24\nfeasible = 14\nadv_success = 2\n"
                    "sol_success = 0\nplanner_precollide = 2\n"
                    "total time: 470.3 sec (15.31 scenarios/hour)\n",
    "open_it200": "candidates = 24\nfeasible = 14\nadv_success = 7\n"
                  "sol_success = 3\ntotal time: 301.9 sec\n",
    "none_feasible": "candidates = 3\nfeasible = 0\nadv_success = 0\n"
                     "sol_success = 0\nplanner_precollide = 0\n",
    "no_total": "candidates = 5\nfeasible = 4\nadv_success = 1\n",
}


def fake_run(calls, perf_line=""):
    """A ``subprocess.run`` that answers a pipeline with its point's canned
    summary (by its ``--out``) and a closed-loop bench with ``perf_line``."""
    def run(cmd, **kw):
        calls.append(cmd)
        out = perf_line
        if "--out" in cmd:
            out = SUMMARIES.get(Path(cmd[cmd.index("--out") + 1]).name, "")
        return types.SimpleNamespace(returncode=0, stdout=out, stderr="")
    return run


def no_clock(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 0.0))


def test_yield_study_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    jax_mod = script("study_yield")
    no_clock(monkeypatch, jax_mod, yield_port)
    calls = []
    monkeypatch.setattr(subprocess, "run", fake_run(calls))
    argv = ["--out", str(tmp_path), "--max_scenes", "24", "--points",
            "closed_it200:", "open_it200:--planner ego",
            "none_feasible:--lr 0.1", "no_total:--num_iters 400"]
    monkeypatch.setattr(sys, "argv", ["study_yield.py"] + argv)
    jax_mod.main()
    want_out = capsys.readouterr().out
    want = json.loads((tmp_path / "yield_study.json").read_text())
    assert yield_port.main(argv + ["--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert json.loads((tmp_path / "yield_study.json").read_text()) == want
    assert got_out == want_out
    assert want["none_feasible"]["yield_pct"] == 0.0
    assert "| no_total | 5 | 4 | 1 | ? | 25.0 | ? |" in got_out
    md = (tmp_path / "yield_study.md").read_text()
    assert md.strip() in got_out
    # the port's calls: its entry point, the point's flags, then --device
    # and the converted prior
    port_calls = calls[len(calls) // 2:]
    assert port_calls[1][1:3] == ["-m",
                                  "strive_tpu_torch.scripts.adv_scenario_gen"]
    assert port_calls[1][-8:] == ["--planner", "ego", "--max_scenes", "24",
                                  "--device", "cpu", "--ckpt",
                                  yield_port.CKPT]


def write_scene(root, folder, name, fut_adv):
    d = root / "scenario_results" / folder
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps({"fut_adv": fut_adv.tolist()}))


def refresh_folders(out):
    """k = 1, 2, 5 runs: scene 3 missing at k = 2, scene 2 with one agent
    fewer at k = 5."""
    rng = np.random.default_rng(0)
    base = {s: rng.normal(size=(n, 12, 4)) * 10
            for s, n in (("scene_0001.json", 3), ("scene_0002.json", 4),
                         ("scene_0003.json", 2))}
    folders = {"scene_0001.json": "adv_sol_success",
               "scene_0002.json": "adv_failed",
               "scene_0003.json": "sol_failed"}
    for k, shift in ((1, 0.0), (2, 0.5), (5, 1.5)):
        for name, fut in base.items():
            if k == 2 and name == "scene_0003.json":
                continue
            fut = fut + shift * rng.normal(size=fut.shape)
            if k == 5 and name == "scene_0002.json":
                fut = fut[:3]
            folder = "adv_failed" if k == 5 else folders[name]
            write_scene(out / f"k{k}", folder, name, fut)


def test_refresh_study_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    jax_mod = script("study_refresh_quality")
    refresh_folders(tmp_path)
    calls = []
    monkeypatch.setattr(subprocess, "run", fake_run(calls))
    argv = ["--out", str(tmp_path), "--skip_perf", "--ks", "1", "2", "5",
            "--cfg", "configs/adv_gen_synth_hc_prod.cfg"]
    monkeypatch.setattr(sys, "argv", ["study_refresh_quality.py"] + argv)
    jax_mod.main()
    want_out = capsys.readouterr().out
    want = json.loads((tmp_path / "refresh_study.json").read_text())
    assert refresh_port.main(argv + ["--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert json.loads((tmp_path / "refresh_study.json").read_text()) == want
    assert got_out == want_out
    assert want["divergence_m"]["1"]["max"] == 0.0
    assert want["divergence_m"]["2"]["scenes"] == 2
    assert want["taxonomy"]["5"] == {"adv_sol_success": 0, "sol_failed": 0,
                                     "adv_failed": 3}
    assert [c[c.index("--planner_refresh_every") + 1]
            for c in calls[3:]] == ["1", "2", "5"]


def test_refresh_divergence_over_the_common_agents():
    base = {"a": np.zeros((3, 2, 4)), "b": np.zeros((1, 2, 4))}
    futs = {"a": np.full((2, 2, 4), 3.0), "c": np.ones((1, 2, 4))}
    got = refresh_port.divergence_m(base, futs)
    assert got == {"mean": pytest.approx(18 ** 0.5), "p95":
                   pytest.approx(18 ** 0.5), "max": pytest.approx(18 ** 0.5),
                   "scenes": 1}
    assert refresh_port.divergence_m(base, {"c": futs["c"]}) is None


def test_refresh_perf_reads_the_device_mode(tmp_path, monkeypatch, capsys):
    """The perf part runs the port's bench_closed_loop with
    STRIVE_BENCH_MODES=fused (its device mode) and keeps its line."""
    refresh_folders(tmp_path)
    line = "device: 20 closed-loop iters in 4.00s (5.00 it/s; first call " \
           "incl. warm-up 6.0s)"
    calls = []
    envs = []
    run = fake_run(calls, "host : x\n" + line + "\n")

    def spy(cmd, **kw):
        envs.append(kw.get("env", {}))
        return run(cmd, **kw)
    monkeypatch.setattr(subprocess, "run", spy)
    assert refresh_port.main(["--out", str(tmp_path), "--ks", "1", "2",
                              "--device", "cpu"]) == 0
    res = json.loads((tmp_path / "refresh_study.json").read_text())
    assert res["perf"] == {"1": line, "2": line}
    assert calls[0][1:] == ["-m", "strive_tpu_torch.scripts.bench_closed_loop",
                            "--device", "cpu"]
    assert envs[1]["STRIVE_BENCH_MODES"] == "fused"
    assert envs[1]["STRIVE_BENCH_REFRESH"] == "2"


def test_nll_floor_matches_the_jax_script(capsys):
    argv = ["--synth_scenes", "8", "--K", "16"]
    script("study_nll_floor").main(argv)
    want = json.loads(capsys.readouterr().out)
    nll_port.main(argv)
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k


def test_yield_study_runs_the_entry_point(tmp_path, monkeypatch, capsys):
    """Two points of the tiny synthetic config through the port's entry
    point on the CPU (random weights), read back from its log lines."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = tmp_path / "ys"
    assert yield_port.main([
        "--cfg", str(ROOT / "configs/adv_gen_synthetic.cfg"), "--out",
        str(out), "--max_scenes", "2", "--device", "cpu", "--ckpt", "",
        "--points", "it2:--num_iters 2", "lr010:--num_iters 2 --lr 0.1"]) == 0
    res = json.loads((out / "yield_study.json").read_text())
    assert list(res) == ["it2", "lr010"]
    for s in res.values():
        assert s["candidates"] == 2
        assert 0 <= s["adv_success"] <= s["feasible"] <= s["candidates"]
        assert s["pipeline_sec"] > 0
    for p in ("it2", "lr010"):
        log = (out / p / "adv_gen_log.txt").read_text()
        assert "'num_iters': 2" in log and "'device': 'cpu'" in log
    assert "| it2 | 2 |" in capsys.readouterr().out


def test_studies_run_a_point_at_a_time(tmp_path, monkeypatch, capsys):
    """``--keep``: a study run a point (a k) at a time ends where one run
    of all its points ends."""
    no_clock(monkeypatch, yield_port)
    monkeypatch.setattr(subprocess, "run", fake_run([]))
    points = ["closed_it200:", "open_it200:--planner ego"]
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    yield_port.main(["--out", str(whole), "--points", *points])
    for p in points:
        yield_port.main(["--out", str(parts), "--keep", "--points", p])
    for f in ("yield_study.json", "yield_study.md"):
        assert (parts / f).read_text() == (whole / f).read_text()

    refresh_folders(whole)
    refresh_folders(parts)
    refresh_port.main(["--out", str(whole), "--skip_perf", "--ks", "1", "2",
                       "5"])
    for k in ("2", "5", "1"):
        refresh_port.main(["--out", str(parts), "--skip_perf", "--keep",
                           "--ks", k])
    capsys.readouterr()
    assert (json.loads((parts / "refresh_study.json").read_text())
            == json.loads((whole / "refresh_study.json").read_text()))
