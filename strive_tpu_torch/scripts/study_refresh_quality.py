"""Planner-refresh perf/quality study, on the port's pipeline.

    python -m strive_tpu_torch.scripts.study_refresh_quality --cfg configs/adv_gen_synth_hc_prod.cfg --ckpt out/train_synth_prod_torch/checkpoints/latest_model --extra --max_scenes 24

Port of ``scripts/study_refresh_quality.py``. The closed-loop adversarial
optimization re-rolls the rule-based planner every Adam iteration;
``--planner_refresh_every k`` holds its future for k iterations. Per k:

- perf: the closed loop's it/s in the device planner's mode of the port's
  ``bench_closed_loop`` (B=4 x NA=8, median of 3), which takes
  ``STRIVE_BENCH_MODES=fused`` as its ``device`` mode;
- quality: the pipeline's outcomes (the taxonomy folders' scene counts)
  and the mean / p95 / max divergence of the final positions of
  ``fut_adv`` from the k = 1 run's on the same scenes
  (:func:`divergence_m`).

Flags as the JAX script's, plus ``--device`` (``cuda``, forwarded to both
subprocesses; they raise without a card) and ``--ckpt`` (forwarded to the
pipeline when given). ``--out`` defaults to ``out/refresh_study_torch``;
``--keep`` keeps the ks of an earlier run there (its JSON entries and
``k*`` folders) that ``--ks`` does not re-run, so a study can run a k at
a time.
The default ``--cfg`` is the JAX script's,
``configs/adv_gen_synth_hc_full.cfg``, whose checkpoint
(``out/train_synth_full/``) is not in the repo; the JAX package's tracked
runs (``out/refresh_study/k*/adv_gen_log.txt``, their ``Args`` lines) used
``configs/adv_gen_synth_hc_prod.cfg``, and so do the port's, with the
converted trained prior as ``--ckpt`` (the command above). Writes
``refresh_study.json`` under ``--out``. The module level uses numpy and
the standard library alone.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from .study_yield import REPO, earlier, entry_point_env

FOLDERS = ("adv_sol_success", "sol_failed", "adv_failed")


def run_pipeline(k, out_dir, cfg, extra):
    cmd = [sys.executable, "-m", "strive_tpu_torch.scripts.adv_scenario_gen",
           "-c", cfg, "--planner_refresh_every", str(k),
           "--out", out_dir] + extra
    r = subprocess.run(cmd, env=entry_point_env(), capture_output=True,
                       text=True)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-2000:])
        raise RuntimeError(f"pipeline k={k} failed")
    return r.stdout


def taxonomy_counts(out_dir):
    root = os.path.join(out_dir, "scenario_results")
    out = {}
    for d in FOLDERS:
        p = os.path.join(root, d)
        out[d] = len([f for f in os.listdir(p) if f.endswith(".json")]) \
            if os.path.isdir(p) else 0
    return out


def load_adv_futs(out_dir):
    """scenario name -> (N, FT, 4) fut_adv array, across all taxonomy dirs."""
    root = os.path.join(out_dir, "scenario_results")
    futs = {}
    for d in FOLDERS:
        p = os.path.join(root, d)
        if not os.path.isdir(p):
            continue
        for f in sorted(os.listdir(p)):
            if f.endswith(".json"):
                with open(os.path.join(p, f)) as fh:
                    sc = json.load(fh)
                futs[f] = np.asarray(sc["fut_adv"], dtype=np.float64)
    return futs


def divergence_m(base, futs):
    """Distances (m) between the (x, y) of ``futs`` and ``base`` ({scene:
    (N, FT, 4)}) at every agent and step of the scenes both hold, over the
    first min(N) agents of each: {mean, p95, max, scenes}, or None where
    they share no scene."""
    common = sorted(set(base) & set(futs))
    divs = []
    for name in common:
        a, b = base[name], futs[name]
        n = min(a.shape[0], b.shape[0])
        divs.append(np.linalg.norm(a[:n, :, :2] - b[:n, :, :2], axis=-1))
    if not divs:
        return None
    d = np.concatenate([x.ravel() for x in divs])
    return {"mean": float(d.mean()), "p95": float(np.percentile(d, 95)),
            "max": float(d.max()), "scenes": len(common)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=os.path.join(
        REPO, "configs/adv_gen_synth_hc_full.cfg"))
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 2, 5])
    ap.add_argument("--out", default="out/refresh_study_torch")
    ap.add_argument("--skip_perf", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the subprocesses' --device")
    ap.add_argument("--ckpt", default=None,
                    help="the pipeline's --ckpt (default: the config's)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the ks already in --out's refresh_study.json "
                         "(and their k* folders) that --ks does not re-run")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="extra flags forwarded to adv_scenario_gen")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    forwarded = ["--device", args.device] + (["--ckpt", args.ckpt]
                                             if args.ckpt else [])
    path = os.path.join(args.out, "refresh_study.json")

    # the ks of an earlier run that this one does not re-run
    results = {}
    for part, kept in earlier(path, args.keep).items():
        kept = {int(k): v for k, v in kept.items() if int(k) not in args.ks}
        if part in ("perf", "taxonomy") and kept:
            results[part] = kept
    futs_by_k = {k: load_adv_futs(os.path.join(args.out, f"k{k}"))
                 for k in results.get("taxonomy", {})}

    # --- perf: the device planner's closed-loop it/s per k ---
    if not args.skip_perf:
        for k in args.ks:
            env = dict(entry_point_env(), STRIVE_BENCH_REFRESH=str(k),
                       STRIVE_BENCH_MODES="fused")
            r = subprocess.run(
                [sys.executable, "-m",
                 "strive_tpu_torch.scripts.bench_closed_loop",
                 "--device", args.device],
                env=env, capture_output=True, text=True)
            line = [ln for ln in r.stdout.splitlines()
                    if ln.startswith("device")]
            print(f"[perf k={k}] " + (line[-1] if line else r.stdout[-200:]))
            results.setdefault("perf", {})[k] = \
                line[-1] if line else r.stdout[-200:]

    # --- quality: pipeline outcomes + divergence vs k=1 ---
    for k in args.ks:
        od = os.path.join(args.out, f"k{k}")
        run_pipeline(k, od, args.cfg, args.extra + forwarded)
        counts = taxonomy_counts(od)
        futs_by_k[k] = load_adv_futs(od)
        results.setdefault("taxonomy", {})[k] = counts
        print(f"[quality k={k}] {counts}")

    if args.keep:  # the kept ks and the new ones in order of k
        futs_by_k = dict(sorted(futs_by_k.items()))
        for part in ("perf", "taxonomy"):
            if part in results:
                results[part] = dict(sorted(results[part].items()))
    base = futs_by_k.get(1) or futs_by_k[min(futs_by_k)]
    for k, futs in futs_by_k.items():
        div = divergence_m(base, futs)
        if div:
            results.setdefault("divergence_m", {})[k] = div
            print(f"[divergence k={k} vs 1] mean {div['mean']:.3f} m, "
                  f"p95 {div['p95']:.3f}, max {div['max']:.3f} "
                  f"({div['scenes']} scenes)")

    with open(path, "w") as fh:
        json.dump(results, fh, indent=2, default=str)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
