"""Per-scene agreement of two runs of the scenario-generation pipeline: how
many of the first N candidates each files alike.

    python -m tools.study_agreement --scenes 24 \
        --pair closed_it200 out/yield_study_torch/closed_it200 out/adv_gen_synth_hc_prod \
        --pair k2 out/refresh_study_torch/k2 out/refresh_study/k2

Each run is an ``--out`` directory of ``adv_scenario_gen`` (either
package's): its ``adv_gen_log.txt`` and ``scenario_results/``. A candidate
is filed under the folder that holds its ``scene_%04d.json``
(``adv_sol_success``, ``sol_failed``, ``adv_failed``); a candidate the log
screened as feasible and that has no file was dropped before the
optimization (``pre_collision``: the planner's own rollout already
collides) or lies in a batch the run never finished (``unfinished``, where
the log ends before its batch's successes); else it is ``infeasible``, or
``unscreened`` where the log ends before it. Prints one JSON line: for
each pair, the first ``--scenes`` candidates' classes in both runs (in
scene order), the count filed alike, and each run's counts.

The studies' ``scenario_results/`` folders are not committed (only their
logs are), so the command runs where the studies ran; its output for the
port's studies is kept as ``agreement.json`` in ``out/yield_study_torch/``
and ``out/refresh_study_torch/``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import Counter

FOLDERS = ("adv_sol_success", "sol_failed", "adv_failed")


def classes(run_dir, scenes):
    """{scene index: class} of the first ``scenes`` candidates of a run."""
    filed = {}
    for folder in FOLDERS:
        d = os.path.join(run_dir, "scenario_results", folder)
        if os.path.isdir(d):
            for f in os.listdir(d):
                m = re.fullmatch(r"scene_(\d+)\.json", f)
                if m:
                    filed[int(m.group(1))] = folder
    with open(os.path.join(run_dir, "adv_gen_log.txt")) as fh:
        log = fh.read()
    screened = {int(i): v for i, v in re.findall(
        r"^scene (\d+): (feasible|infeasible)", log, re.M)}
    # the scenes of every batch whose successes the log reports
    finished = set()
    for batch, rest in re.findall(
            r"^Optimizing batch of \d+ scenes \[([\d, ]*)\]\n(.*?)"
            r"(?=^Optimizing batch|\Z)", log, re.M | re.S):
        if re.search(r"^adv successes:", rest, re.M):
            finished |= {int(i) for i in batch.split(",") if i.strip()}
    out = {}
    for i in range(scenes):
        if i in filed:
            out[i] = filed[i]
        elif i not in screened:
            out[i] = "unscreened"
        elif screened[i] == "infeasible":
            out[i] = "infeasible"
        else:
            out[i] = "pre_collision" if i in finished else "unfinished"
    return out


def agreement(port_dir, jax_dir, scenes):
    """Both runs' classes of the first ``scenes`` candidates, and the count
    filed alike."""
    a, b = classes(port_dir, scenes), classes(jax_dir, scenes)
    return {"alike": sum(a[i] == b[i] for i in range(scenes)),
            "scenes": scenes,
            "differ": {i: [a[i], b[i]] for i in range(scenes) if a[i] != b[i]},
            "port": dict(Counter(a.values())), "jax": dict(Counter(b.values())),
            "port_classes": [a[i] for i in range(scenes)],
            "jax_classes": [b[i] for i in range(scenes)],
            "port_adv_success": sorted(
                i for i, c in a.items() if c in FOLDERS[:2]),
            "jax_adv_success": sorted(
                i for i, c in b.items() if c in FOLDERS[:2])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--pair", nargs=3, action="append", required=True,
                    metavar=("NAME", "PORT_DIR", "JAX_DIR"))
    args = ap.parse_args(argv)
    print(json.dumps({name: agreement(p, j, args.scenes)
                      for name, p, j in args.pair}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
