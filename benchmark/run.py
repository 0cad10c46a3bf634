"""Run one cell of the benchmark of ``strive_tpu_torch`` on one card.

    python3 -m benchmark.run --workload adv_open_b4 --seed 7 --seconds 30 --trace 0

From the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell's configuration file, its traffic file
``benchmark/traffic/<traffic>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``, and one reader a metric,
``benchmark/metrics/<metric>.py``. The run makes its inputs from the
seed, sets up the program and warms it up (``setup_s``), measures for
``--seconds``, then checks the program's outputs against the plain
reference of ``benchmark/reference/`` and prints one JSON line last on
standard output; the numbers compared, each with its limit, are the last
lines of standard error and the last key of that line. ``--trace 1``
profiles a bounded span of a few more units of work after the window
and reports the cell's per-layer metrics in place of its end-to-end
ones.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result; likewise (exit 3) if JAX or the JAX package was
loaded into the process.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "strive_tpu")


def process_start_age():
    """Seconds since this process started (from /proc, 10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - process_start_age()


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_metric(name, bench_dir=None):
    """The reader ``metrics/<name>.py`` of the benchmark's folder."""
    from .harness import BENCH

    path = (bench_dir or BENCH) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, trace):
    """Names of the end-to-end metrics (``trace`` 0) or per-layer metrics
    (``trace`` 1) that ``cell`` reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def resolve(bench, cell, root=None):
    """(workload entry, config entry, config dict, traffic dict) of
    ``cell``, from the checkout at ``root``."""
    from .harness import ROOT, load_json

    root = root or ROOT
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    ce = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return (wl, ce, load_json(root / ce["file"]),
            load_json(root / "benchmark" / "traffic"
                      / f"{wl['traffic']}.json"))


def result(run, bench, chips, kind, peak, bench_dir=None):
    """The run's result line (a dict), the checks' key last."""
    names = cell_metrics(bench, run.cell, run.trace)
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    for name in names:
        v = load_metric(name, bench_dir).read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    checks = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    correct = bool(run.checks) and all(
        math.isfinite(v) and lim is not None and v <= lim
        for _, v, lim in run.checks) and run.attempted > run.failed
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": {"platform": "gpu", "kind": kind, "count": chips,
                      "memory_peak_bytes": int(peak)}}
    if run.trace and run.profile is not None:
        out["device"]["busy_s"] = run.profile["busy_s"]
        out["device"]["window_s"] = run.profile["span_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["checks"] = checks
    return out


def set_environment():
    """Every cache inside the checkout, at fixed paths; nothing that the
    program might load may pull in JAX."""
    from .harness import ROOT

    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .clocks import Clocks
    from .harness import ROOT, Run, load_json

    bench = load_json(ROOT / "BENCHMARK.json")
    wl, _, cfg, traffic = resolve(bench, args.workload)
    set_environment()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        log(f"needs {wl['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = Run(args.workload, cfg, traffic, args.seed, args.seconds,
              bool(args.trace), device)
    if run.trace:
        from .trace import Tracer

        tp = traffic["profile"]
        run.tracer = Tracer(tp["skip"], tp["units"], device)
    drv.setup(run)
    torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - T0
    with Clocks() as clocks:
        drv.window(run)
    if run.tracer is not None:
        run.tracer.close()
    peak = torch.cuda.max_memory_allocated(device)
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {', '.join(bad)}")
        return 3
    if run.tracer is not None:
        from .trace import summarize

        run.profile = summarize(run.tracer)
        run.tracer = None
    drv.release(run)
    drv.check(run)

    out = result(run, bench, wl["chips"], torch.cuda.get_device_name(device),
                 peak)
    bad = forbidden_modules()
    if bad:
        log(f"loaded: {', '.join(bad)}")
        return 3
    u = sorted(run.unit_s) or [0.0]
    log(f"card: {power_limit()}; setup {run.setup_s:.3f} s, window "
        f"{run.window_s:.3f} s, work {run.work}; a unit of work "
        f"{u[0]:.3f} / {u[len(u) // 2]:.3f} / {u[-1]:.3f} s (min / median "
        f"/ max); {clocks.summary()}")
    for n, c in out["checks"].items():
        log(f"check {n}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
