"""The harness rehearsed on the CPU: BENCHMARK.json keeps to the format
the benchmark's checker reads (its keys, names, units and limits), every
file is found by name, the drivers run at a tiny size, the result line
has exactly its keys, and a new cell, configuration and metric come in
as new files and entries alone."""

import hashlib
import json
import re
import shutil

import pytest
import torch

from benchmark import run as runner
from benchmark.drivers import optim, train
from benchmark.harness import BENCH, ROOT, load_json
from benchmark.tests import tiny

BENCHMARK = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def metrics():
    return BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert all(LINE.match(w) for w in BENCHMARK["command"])
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


def test_names_units_and_lines():
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])
    names = [m["name"] for m in metrics()]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_file_is_found_by_name(cell):
    wl, ce, cfg, traffic = runner.resolve(BENCHMARK, cell)
    assert (ROOT / ce["file"]).parent == BENCH / "configs"
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
    for trace in (0, 1):
        for name in runner.cell_metrics(BENCHMARK, cell, trace):
            assert callable(runner.load_metric(name).read)
    e2e = runner.cell_metrics(BENCHMARK, cell, 0)
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = runner.cell_metrics(BENCHMARK, cell, 1)
    assert per_layer
    moves = {m["name"]: m["moves"] for m in BENCHMARK["per_layer"]}
    for name in per_layer:
        assert moves[name] in e2e
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg["assumed"]
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False


def test_without_a_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", "adv_open_b4", "--seed", "5",
                      "--seconds", "1"])
    assert rc == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell,driver", [("adv_open_b4", optim),
                                         ("train_b4", train)])
def test_drivers_at_a_tiny_size_and_the_result_line(cell, driver):
    cfg = next(w["config"] for w in BENCHMARK["workloads"]
               if w["name"] == cell)
    run = tiny.run(cfg, cell, seconds=0.5)
    driver.setup(run)
    driver.window(run)
    driver.release(run)
    run.setup_s = 1.0
    assert run.attempted >= 1 and run.failed == 0 and run.window_s > 0
    run.checks = [("x", 0.0, 1.0)]
    out = runner.result(run, BENCHMARK, 1, "cpu", 0)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["metrics"]) == set(runner.cell_metrics(BENCHMARK, cell,
                                                          0))
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    run.trace = True
    out = runner.result(run, BENCHMARK, 1, "cpu", 0)
    # no profile on the CPU: the device readers find nothing to read
    assert set(out["metrics"]) <= set(runner.cell_metrics(BENCHMARK, cell,
                                                          1))
    assert "breakdown" not in out


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_comes_in_as_files_and_entries(tmp_path):
    """A throw-away configuration, traffic mix and per-layer metric, added
    to a copy of the benchmark: found by name, no file that is there
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root / "benchmark")
    cfg = load_json(BENCH / "configs" / "strive_adv_nusc.json")
    cfg["max_agents"] = 32
    (root / "benchmark/configs/strive_adv_wide.json").write_text(
        json.dumps(cfg))
    tr = load_json(BENCH / "traffic" / "adv_open_b4.json")
    tr["pool_batches"] = 4
    (root / "benchmark/traffic/adv_open_b4_na32.json").write_text(
        json.dumps(tr))
    (root / "benchmark/metrics/scene_count.optim.py").write_text(
        "def read(run):\n    return run.work.get('scenes')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "strive_adv_wide", "source": "x",
                             "file": "benchmark/configs/strive_adv_wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "adv_open_na32",
                               "config": "strive_adv_wide",
                               "traffic": "adv_open_b4_na32", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("adv_open_na32")
    bench["per_layer"].append({"name": "scene_count.optim", "unit": "scenes",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver",
                               "moves": "optim_scene_iters_per_s",
                               "workloads": ["adv_open_na32"]})
    _, _, c, t = runner.resolve(bench, "adv_open_na32", root)
    assert c["max_agents"] == 32 and t["pool_batches"] == 4
    assert "scene_count.optim" in runner.cell_metrics(bench,
                                                      "adv_open_na32", 1)
    reader = runner.load_metric("scene_count.optim", root / "benchmark")

    class R:
        work = {"scenes": 12}
    assert reader.read(R()) == 12
    after = _digest(root / "benchmark")
    assert all(after[p] == h for p, h in before.items())


def test_trace_interval_arithmetic():
    from benchmark.trace import _gaps, _union

    iv = [(0, 10), (5, 15), (20, 30), (29, 31)]
    assert _union(iv) == 15 + 11
    assert _gaps(iv, 0, 40) == [(15, 20), (31, 40)]
    assert _gaps([], 3, 7) == [(3, 7)]


@pytest.mark.cuda
def test_tiny_cells_on_the_card(cuda_device):
    """The tiny cells with the program's CUDA kernels, checked against the
    reference."""
    for cfg, cell, driver in (("strive_adv_nusc", "adv_open_b4", optim),
                              ("strive_train_nusc", "train_b4", train)):
        run = tiny.run(cfg, cell)
        run.device = cuda_device
        driver.setup(run)
        driver.window(run)
        driver.release(run)
        got = driver.reference_numbers(run)
        assert all(v == v for v in got.values() if isinstance(v, float))


class FakeTracer:
    """Counts the boundaries a driver reports once armed."""

    skip, units = 2, 2
    needed = 4

    def __init__(self):
        self.armed = self.done = False
        self.count = 0

    def boundary(self):
        if self.armed:
            self.count += 1


@pytest.mark.parametrize("cell,driver", [("adv_open_b4", optim),
                                         ("train_b4", train)])
def test_traced_units_come_after_the_window(cell, driver):
    cfg = next(w["config"] for w in BENCHMARK["workloads"]
               if w["name"] == cell)
    run = tiny.run(cfg, cell, seconds=0.5)
    run.tracer = FakeTracer()
    driver.setup(run)
    driver.window(run)
    assert run.tracer.armed and run.tracer.count >= FakeTracer.needed
    done = run.work.get("steps", run.work.get("batches"))
    assert run.attempted == done  # the traced units are not counted
