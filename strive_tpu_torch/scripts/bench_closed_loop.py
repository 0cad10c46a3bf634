"""Closed-loop planner benchmark: the numpy planner on the host against the
device planner.

    python -m strive_tpu_torch.scripts.bench_closed_loop
    STRIVE_BENCH_MODES=device STRIVE_BENCH_REFRESH=2 python -m strive_tpu_torch.scripts.bench_closed_loop

Port of ``scripts/bench_closed_loop.py``: the closed-loop adversarial
optimization ('hardcode' planner) at bench.py's workload (``bench.workload``:
B=4 x NA=8, FT=12, 256 px crops, TF32 off), with
``synthetic_lanegraph(512 m, spacing 64 m)`` on both maps and the 'default'
planner config, in two modes:

- ``host``: the numpy ``RulePlanner`` through the host bridge (one copy of
  the prediction to the host a call);
- ``device``: ``DeviceRulePlanner``, batched torch ops on ``--device``.

strive_tpu split its device planner into a chunked and a fused loop; the
port runs one eager loop, so ``tpu-chunked``, ``tpu-fused`` and
``fused`` in ``STRIVE_BENCH_MODES`` all run ``device``, and
``STRIVE_BENCH_FUSED`` and ``STRIVE_BENCH_CHUNK`` change nothing. Each mode
prints its median of 3 runs of ``STRIVE_BENCH_ITERS`` iterations (20) after
a warm-up run, each fenced by ``torch.cuda.synchronize()``; without
``STRIVE_BENCH_MODES`` both run, then the device planner's speed-up.
``STRIVE_BENCH_REFRESH=k`` re-rolls the planner every k iterations;
``STRIVE_BENCH_B`` and ``_NA`` set the batch. ``--device`` defaults to
``cuda`` and raises without a card.

:func:`lanegraph`, :func:`host_planner_fn` and :func:`device_planner` are
this workload's planner set-up, which ``chip_smoke.py`` phase 6b uses too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..maps.lanegraph import synthetic_lanegraph
from ..planners import PLANNER_CONFIGS, RulePlanner
from ..planners.device_planner import DeviceRulePlanner
from ..planners.host_bridge import make_planner_host_fn, reset_planner
from .bench import FT, adv_optim, env_int, timed_runs, workload
from .common import card_name, resolve_device

DT = 0.5  # the scenes' step (s): the planner's observation spacing
# STRIVE_BENCH_MODES' names, strive_tpu's and the port's, by port mode
MODES = {"host": "host", "device": "device", "tpu": "device",
         "tpu-chunked": "device", "tpu-fused": "device", "fused": "device"}


def lanegraph(extent_m=512.0, spacing_m=64.0):
    """The benchmark's lane graph, on every map of the store."""
    return synthetic_lanegraph(extent_m=extent_m, spacing_m=spacing_m)


def host_planner_fn(scene, lg, map_names, state_norm, att_norm, dt=DT):
    """The numpy planner's closed-loop function on ``scene`` (every map
    ``lg``)."""
    planner = RulePlanner({m: lg for m in map_names}, map_names,
                          PLANNER_CONFIGS["default"])
    reset_planner(planner, state_norm.unnormalize(scene.past_gt[:, :, -1]),
                  att_norm.unnormalize(scene.lw), scene.mask, scene.map_idx)
    return make_planner_host_fn(planner, scene.mask, state_norm, dt,
                                scene.future_gt.shape[2])


def device_planner(scene, lg, map_names, state_norm, att_norm, device):
    """The device planner on ``device``, reset on ``scene``."""
    planner = DeviceRulePlanner({m: lg for m in map_names}, map_names,
                                PLANNER_CONFIGS["default"], device=device)
    planner.reset(
        state_norm.unnormalize(scene.past_gt[:, :, -1]).to(device),
        att_norm.unnormalize(scene.lw).to(device), scene.mask.to(device),
        scene.map_idx.to(device))
    return planner


def run_mode(w, mode, iters, refresh, device):
    """Median it/s of 3 closed-loop runs of ``iters`` iterations after a
    warm-up run; prints the mode's line."""
    lg = lanegraph()
    names = w["store"].map_names
    sn, an = w["state_norm"], w["att_norm"]
    if mode == "host":
        fn = host_planner_fn(w["scene"], lg, names, sn, an)
    else:
        fn = device_planner(w["scene"], lg, names, sn, an,
                            device).make_fn(sn, DT, FT)
    first, times = timed_runs(lambda: adv_optim(
        w, iters, planner_rollout_fn=fn, planner_refresh_every=refresh),
        device, 3)
    med = float(np.median(times))
    print(f"{mode:5s}: {iters} closed-loop iters in {med:.2f}s "
          f"({iters / med:.2f} it/s; first call incl. warm-up "
          f"{first:.1f}s)", flush=True)
    return iters / med


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, NA = env_int("STRIVE_BENCH_B", 4), env_int("STRIVE_BENCH_NA", 8)
    iters = env_int("STRIVE_BENCH_ITERS", 20)
    refresh = env_int("STRIVE_BENCH_REFRESH", 1)
    w = workload(device, B, NA)
    print(f"device={card_name(device)}", file=sys.stderr)
    modes_env = os.environ.get("STRIVE_BENCH_MODES")
    if modes_env:
        for m in modes_env.split(","):
            run_mode(w, MODES[m.strip()], iters, refresh, device)
        return 0
    host = run_mode(w, "host", iters, refresh, device)
    dev = run_mode(w, "device", iters, refresh, device)
    print(f"device-planner speedup vs host: {dev / host:.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
