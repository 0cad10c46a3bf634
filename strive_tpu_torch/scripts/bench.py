"""Benchmark harness of the port: prints ONE JSON line with the headline
metric.

    python -m strive_tpu_torch.scripts.bench
    python -m strive_tpu_torch.scripts.bench --device cpu

Port of the repo's root ``bench.py``. Headline: adversarial
latent-optimization iterations a second, the inner loop of the flagship
pipeline (one decoder rollout, the adversarial losses, the gradient and
one Adam step an iteration). Workload: B=4 scenes x NA=8 agents, PT=4,
FT=12, 256 px map crops, the default model widths with Flax's initial
distributions (``init_model_params``, seed 0), on a synthetic store of 2
maps x 2048 px x 4 channels at 4 px/m; float32 with TF32 off for matmuls
and cuDNN convolutions.

Protocol: one warm-up run (cuDNN plans, the allocator's growth), then the
median of 5 runs of ``ITERS`` iterations, each fenced by
``torch.cuda.synchronize()``. The device's name and power limit go on
stderr; the JSON line has bench.py's keys. Its ``vs_baseline`` divides by
bench.py's documented estimate of the reference on a V100 (1.5 it/s,
BASELINE.md), not by a measurement.

- ``--device`` defaults to ``cuda`` and raises without a card.
- ``STRIVE_BENCH_B`` and ``STRIVE_BENCH_NA`` set the batch, as in
  bench.py; ``STRIVE_BENCH_ITERS`` the iterations a run (bench.py's 50);
  ``STRIVE_MAP_REFRESH=k`` re-encodes the map every k rollout steps.

:func:`workload` builds this model, store, batch and embedding, and is
shared by ``bench_closed_loop``, ``profile_breakdown`` and
``ablate_hotpath`` (with :func:`decode_grad`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data.synthetic import synthetic_scene_list
from ..maps.store import synthetic_map_store
from ..model.traffic_model import NormConfig, TrafficModel
from ..normalize import att_normalizer_for, state_normalizer_for
from ..optim.adv import run_adv_gen_optim
from ..scene import pad_scene_arrays
from .common import card_name, init_params, resolve_device, sync

EST_REFERENCE_ITERS_PER_SEC = 1.5  # bench.py's documented estimate
PT, FT = 4, 12
CATS = ("car", "truck")
WEIGHTS = {  # bench.py:67-72
    "adv_crash": 2.0, "motion_prior": 1.0, "motion_prior_atk": 0.005,
    "coll_veh": 20.0, "coll_veh_plan": 20.0, "coll_env": 20.0,
    "init_z": 0.5, "init_z_atk": 0.05, "match_ext": 10.0,
    "motion_prior_ext": 0.0001,
}


def env_int(name, default):
    return int(os.environ.get(name, str(default)))


def workload(device, B, NA, map_refresh=1):
    """bench.py's model, store, scene batch and embedding on ``device``,
    TF32 off.

    :return: dict of model, store, scene, emb (no-grad ``embed``),
        state_norm, att_norm
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state_norm, att_norm = state_normalizer_for(CATS), att_normalizer_for(CATS)
    norm = NormConfig.from_normalizers(state_norm, att_norm)
    model = TrafficModel(npast=PT, nfuture=FT, map_obs_size_pix=256,
                         nclasses=2, norm=norm, map_refresh_every=map_refresh,
                         device=device)
    init_params(model)
    store = synthetic_map_store(num_maps=2, size_px=2048, channels=4,
                                pix_per_m=4.0, device=device)
    scenes = synthetic_scene_list(num_scenes=B, num_maps=2, map_size_px=2048,
                                  PT=PT, FT=FT, min_agents=NA, max_agents=NA)
    scene = pad_scene_arrays(scenes, NA, 2, device=device)
    with torch.no_grad():
        emb = model.embed(scene, store)
    return {"model": model, "store": store, "scene": scene, "emb": emb,
            "state_norm": state_norm, "att_norm": att_norm}


def adv_optim(w, iters, **kw):
    """bench.py's ``run``: ``iters`` adversarial iterations from the prior
    mean, lr 0.05, feasibility time 2; open loop unless ``kw`` names a
    planner function. :return: run_adv_gen_optim's result"""
    prior = w["emb"]["prior_out"]
    return run_adv_gen_optim(
        w["model"], prior[0], 0.05, WEIGHTS, w["scene"], w["store"], iters,
        w["emb"], "hardcode" if kw else "ego",
        (prior[0][:, 0], prior[1][:, 0]), prior, 2, None, **kw)


def decode_grad(w):
    """One decode of the prior mean and the gradient of ``sum(future **
    2)`` with respect to the latents alone, as ``jax.grad`` takes it (no
    parameter gradients): the hot path of ``profile_breakdown`` and
    ``ablate_hotpath``. :return: the latents' gradient"""
    z = w["emb"]["prior_out"][0].detach().requires_grad_(True)
    fp = w["model"].decode_embedding(z, w["emb"], w["scene"], w["store"])
    return torch.autograd.grad(torch.sum(fp["future_pred"] ** 2), z)[0]


def timed_runs(fn, device, runs):
    """Seconds of ``runs`` calls of ``fn`` after one warm-up call, each
    fenced by a synchronize: (warm-up s, [s, ...])."""
    def once():
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        return time.perf_counter() - t0
    first = once()
    return first, [once() for _ in range(runs)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, NA = env_int("STRIVE_BENCH_B", 4), env_int("STRIVE_BENCH_NA", 8)
    iters = env_int("STRIVE_BENCH_ITERS", 50)
    w = workload(device, B, NA, env_int("STRIVE_MAP_REFRESH", 1))
    first, times = timed_runs(lambda: adv_optim(w, iters), device, 5)
    print(f"warm-up: {first:.1f}s", file=sys.stderr)
    elapsed = float(np.median(times))
    iters_per_sec = iters / elapsed
    agent_steps_per_sec = iters_per_sec * B * NA * FT
    print(f"{iters} adv-optim iters: median {elapsed:.2f}s of "
          f"{[round(t, 2) for t in times]} -> {iters_per_sec:.2f} it/s, "
          f"rollout {agent_steps_per_sec:.0f} agent-steps/s, "
          f"device={card_name(device)}", file=sys.stderr)
    ratio = round(iters_per_sec / EST_REFERENCE_ITERS_PER_SEC, 2)
    print(json.dumps({
        "metric": "adv_latent_optim_iters_per_sec",
        "value": round(iters_per_sec, 3),
        "unit": f"iters/sec (B={B} scenes x NA={NA}, FT=12, 256px crops)",
        "vs_baseline": ratio,
        "vs_estimated_baseline": ratio,
        "baseline_note": "denominator is the BASELINE.md estimate, not a "
                         "measurement",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
