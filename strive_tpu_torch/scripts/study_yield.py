"""Adversarial-yield study, on the port's pipeline.

    python -m strive_tpu_torch.scripts.study_yield --max_scenes 24
    python -m strive_tpu_torch.scripts.study_yield -h

Port of ``scripts/study_yield.py``: the same candidate scenes (the
synthetic dataset is seeded) through the flagship pipeline while the
optimization budget (``--num_iters``), the learning rate (``--lr``) and
open or closed loop (``--planner ego`` replay against the config's
``hardcode``) are swept, one point at a time; yield = adversarial
successes / feasible scenes. Each point runs the port's entry point,
``python -m strive_tpu_torch.scripts.adv_scenario_gen``, in a subprocess
and is read from its ``key = N`` and ``total time:`` lines. Writes
``yield_study.json`` under ``--out`` after each point, prints the JAX
script's lines and markdown table, and writes the table to
``yield_study.md`` there too. ``--keep`` starts from the points already
in that JSON (a point re-run replaces its entry), so a study can run a
point at a time.

Flags as the JAX script's (``--cfg``, ``--out``, ``--max_scenes``,
``--points name:flags``), plus ``--device`` (``cuda``, forwarded; the entry
point raises without a card) and ``--ckpt``: the converted trained prior
``out/train_synth_prod_torch/checkpoints/latest_model`` by default, the
port's counterpart of the config's orbax checkpoint; ``--ckpt ''`` passes
none (the config's own, or random weights). ``--out`` defaults to
``out/yield_study_torch``, beside the JAX results in ``out/yield_study``.
The module level uses the standard library alone.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "out/train_synth_prod_torch/checkpoints/"
                    "latest_model")
SUMMARY_KEYS = ("candidates", "feasible", "adv_success", "sol_success",
                "planner_precollide")


def entry_point_env():
    """The environment for ``python -m strive_tpu_torch...`` from any
    directory: the repo on PYTHONPATH."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path
                                               if path else ""))


def earlier(path, keep):
    """The results ``path`` holds where ``keep`` (``--keep``: a study run a
    point or a k at a time), else {}."""
    if not (keep and os.path.exists(path)):
        return {}
    with open(path) as fh:
        return json.load(fh)


def run_point(name, out_dir, cfg, flags):
    cmd = [sys.executable, "-m", "strive_tpu_torch.scripts.adv_scenario_gen",
           "-c", cfg, "--out", out_dir] + flags
    t0 = time.time()
    r = subprocess.run(cmd, env=entry_point_env(), capture_output=True,
                       text=True)
    wall = time.time() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
        raise RuntimeError(f"pipeline point {name} failed")
    return parse_summary(r.stdout), wall


def parse_summary(stdout):
    out = {}
    for k in SUMMARY_KEYS:
        m = re.search(rf"^{k} = (\d+)", stdout, re.M)
        if m:
            out[k] = int(m.group(1))
    m = re.search(r"total time: ([\d.]+) sec", stdout)
    if m:
        out["pipeline_sec"] = float(m.group(1))
    return out


def table(results):
    """The markdown table of ``results`` ({point: summary}), as lines."""
    lines = ["| point | candidates | feasible | adv | sol | yield % | "
             "pipeline s |", "|---|---|---|---|---|---|---|"]
    for name, s in results.items():
        lines.append(f"| {name} | {s.get('candidates', '?')} | "
                     f"{s.get('feasible', '?')} | {s.get('adv_success', '?')} | "
                     f"{s.get('sol_success', '?')} | {s.get('yield_pct', '?')} | "
                     f"{s.get('pipeline_sec', '?')} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=os.path.join(
        REPO, "configs/adv_gen_synth_hc_prod.cfg"))
    ap.add_argument("--out", default="out/yield_study_torch")
    ap.add_argument("--max_scenes", type=int, default=None,
                    help="bound candidate count per point (fixed seed keeps "
                         "the scene set identical across points)")
    ap.add_argument("--points", nargs="+", default=[
        "closed_it200:",
        "closed_it400:--num_iters 400",
        "closed_it800:--num_iters 800",
        "closed_lr010:--lr 0.1",
        "open_it200:--planner ego",
        "open_it400:--planner ego --num_iters 400",
    ], help="name:space-separated-extra-flags")
    ap.add_argument("--device", default="cuda",
                    help="the entry point's --device")
    ap.add_argument("--ckpt", default=CKPT,
                    help="the entry point's --ckpt ('' for none)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the points already in --out's "
                         "yield_study.json (a study run a point at a time)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    forwarded = ["--device", args.device] + (["--ckpt", args.ckpt]
                                             if args.ckpt else [])
    path = os.path.join(args.out, "yield_study.json")

    results = earlier(path, args.keep)
    for spec in args.points:
        name, _, flagstr = spec.partition(":")
        flags = flagstr.split() if flagstr else []
        if args.max_scenes:
            flags += ["--max_scenes", str(args.max_scenes)]
        od = os.path.join(args.out, name)
        summary, wall = run_point(name, od, args.cfg, flags + forwarded)
        feas = summary.get("feasible", 0)
        summary["yield_pct"] = round(
            100.0 * summary.get("adv_success", 0) / feas, 1) if feas else 0.0
        summary["wall_sec"] = round(wall, 1)
        results[name] = summary
        print(f"[{name}] {summary}")
        with open(path, "w") as fh:
            json.dump(results, fh, indent=2)

    lines = table(results)
    print("\n" + "\n".join(lines))
    with open(os.path.join(args.out, "yield_study.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
