"""Readings that the check's limits are set from, and its control.

    python3 -m benchmark.calibrate --workload adv_open_b4 --seeds 11 12 13 --seconds 0

For each seed, in one process (the raster is made once): the cell's
set-up, a short window (``--seconds 0`` runs one batch or the set-up's
steps alone), and the numbers the check compares, twice: the program
against the float32 reference (the lower readings) and, as the control,
the reference computed in TF32 in the program's place (the upper readings:
TF32 is the precision below the configuration's float32 with TF32 off).
``--fault`` plants one of ``benchmark.faults`` in the program and reads
its numbers alone; ``--plain-k2`` runs the program with its footprint
kernel replaced by the plain version, to tell that kernel's share of the
lower readings. One JSON line a seed on standard output. Not run by
the benchmark's runs; it needs a card (``--device cpu`` runs the same at
the cell's size on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of benchmark.faults in the program "
                         "(its readings alone; no control)")
    ap.add_argument("--plain-k2", action="store_true",
                    help="diagnosis: the program's K2 replaced by its plain "
                         "version (crop_kernel.coll_point_plain)")
    args = ap.parse_args(argv)

    from .faults import fault
    from .harness import ROOT, Run, load_json
    from .run import resolve, set_environment

    bench = load_json(ROOT / "BENCHMARK.json")
    _, _, cfg, traffic = resolve(bench, args.workload)
    set_environment()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    if args.plain_k2:
        from strive_tpu_torch.maps import crop_kernel, queries

        crop_kernel.footprint_coll_point = queries.coll_point_plain
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(args.workload, cfg, traffic, seed, args.seconds, False,
                  device)
        with (fault(args.fault, traffic["driver"]) if args.fault
              else contextlib.nullcontext()):
            drv.setup(run)
            drv.window(run)
        drv.release(run)
        t1 = time.perf_counter()
        out = {"seed": seed, "work": run.work, "program_s": t1 - t0,
               "fault": args.fault,
               "float32": drv.reference_numbers(run, "float32")}
        out["reference_s"] = time.perf_counter() - t1
        if not args.fault:
            out["tf32"] = drv.reference_numbers(run, "tf32")
        print(json.dumps(out), flush=True)
        run.state.clear()
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
