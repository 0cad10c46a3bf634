"""Driver ``closed``: a stream of closed-loop adversarial optimizations
against STRIVE's rule-based planner on the card.

As ``optim``'s stream, through the device backend of
``scripts/adv_scenario_gen.py``: one ``DeviceRulePlanner`` over the lane
graph of ``inputs/lanes.py``, made in set-up; on each batch ``reset`` with
the scenes' last past states, sizes, mask and maps, then
``run_adv_gen_optim(..., 'hardcode', planner_rollout_fn=make_fn(...),
planner_refresh_every=...)`` from the prior mean, and its result read to
the host. Each planner call's input (the detached decode) and output are
kept (the tensors themselves: no copy, no kernel).

The check: the decoder numbers of ``optim``'s check, the reference
following the program's latents, crops and planner futures
(``reference.closed``); then the plain reference planner
(``reference.planner``) on the program's own decode at some of the
checked batches' planner calls (each batch's final call, the one furthest
from its first, and calls drawn from the seed), against the program's
plan of each scene: ``planner_gap_m``, the median over those plans of the
largest distance between the two egos over the output steps, and
``planner_far_share``, the share of plans further apart than
``check.far_m`` somewhere.

Traffic keys: ``optim``'s, and ``check.refreshes`` (planner calls the
reference planner recomputes) and ``check.far_m``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import harness
from ..inputs import lanes, scenes, weights
from .optim import _Recorded, _scenes, compare


def _planner_fn(run, scene):
    """Reset the run's planner on ``scene``; its closed-loop function,
    recording each call."""
    st, m = run.state, run.cfg["model"]
    sn, an = harness.normalizers(m)
    planner = st["planner"]
    planner.reset(sn.unnormalize(scene.past_gt[:, :, -1]),
                  an.unnormalize(scene.lw), scene.mask, scene.map_idx)
    fn = planner.make_fn(sn, m["bike"]["dt"], m["future_len"])
    calls = st["calls"] = []

    def recorded(pred):
        out = fn(pred)
        calls.append((pred, out))
        return out

    return recorded


def _optimize(run, scene, iters):
    """One batch through the program (``optim._optimize``'s, closed)."""
    from strive_tpu_torch.optim.adv import run_adv_gen_optim

    st = run.state
    o = run.cfg["optim"]
    fn = _planner_fn(run, scene)
    with torch.no_grad():
        emb = st["model"].embed(scene, st["store"])
    mu, var = emb["prior_out"]
    st["steps"] = []
    with harness.CropPoses() as rec:
        z, res, agt, t, losses, _ = run_adv_gen_optim(
            st["model"], mu, o["lr"], o["weights"], scene, st["store"],
            iters, emb, o["planner"], (mu[:, 0], var[:, 0]), (mu, var),
            o["feasibility_time"], None, planner_rollout_fn=fn,
            planner_refresh_every=o["refresh_every"])
    FT = run.cfg["model"]["future_len"]
    crops = [rec.poses[k:k + FT] for k in range(0, len(rec.poses), FT)]
    return {"z": z.cpu(), "result": res.cpu(), "losses": losses.cpu(),
            "min_agt": agt.cpu(), "min_t": t.cpu(), "steps": st["steps"],
            "crops": crops, "calls": st["calls"],
            "emb": {"map": emb["map_feat"], "past": emb["past_feat"],
                    "prior": (mu, var)}}


def setup(run):
    from strive_tpu_torch.planners.device_planner import DeviceRulePlanner
    from strive_tpu_torch.scene import pad_scene_arrays

    cfg, dev = run.cfg, run.device
    st = run.state
    st["weights"] = weights.draw(cfg["model"], run.seed, dev)
    st["store"] = harness.program_store(cfg["store"], dev)
    st["model"] = harness.program_model(cfg["model"], st["weights"], dev)
    st["lanes"] = lanes.graphs(cfg["store"], cfg["lane_graph"]["res_m"])
    st["planner"] = DeviceRulePlanner(st["lanes"], cfg["store"]["maps"],
                                      cfg["optim"]["planner_cfg"], device=dev)
    nc = len(cfg["model"]["agent_types"])
    n = run.traffic["pool_batches"]
    st["pool"] = [_scenes(run, i) for i in range(n + 1)]
    st["batches"] = [pad_scene_arrays(s, cfg["max_agents"], nc, device=dev)
                     for s in st["pool"]]
    _optimize(run, st["batches"][n], run.traffic["warmup_iters"])
    st["results"] = {}


def window(run):
    from strive_tpu_torch.optim import adv

    st = run.state
    iters = run.cfg["optim"]["num_iters"]
    B = run.cfg["batch_size"]
    n = run.traffic["pool_batches"]
    orig = adv.Adam
    adv.Adam = _Recorded(orig, run)
    done, times = 0, []
    try:
        t0 = harness.now()
        deadline = t0 + run.seconds
        i = 0
        while i == 0 or harness.now() < deadline:
            run.attempted += 1
            t = harness.now()
            try:
                st["results"][i] = _optimize(run, st["batches"][i % n],
                                             iters)
                times.append(harness.now() - t)
                st["results"][i]["last"] = st["last"]
                done += 1
            except RuntimeError as e:
                run.failed += 1
                print(f"batch {i} failed: {e}", file=sys.stderr, flush=True)
            i += 1
        run.window_s = harness.now() - t0
        if run.tracer is not None:  # more batches, not counted
            run.tracer.armed = True
            while not run.tracer.done and \
                    run.tracer.count < run.tracer.needed:
                _optimize(run, st["batches"][i % n], iters)
    finally:
        adv.Adam = orig
    run.work = {"batches": done, "iters": done * iters,
                "scene_iters": done * iters * B, "scenes": done * B}
    run.unit_s = times


def release(run):
    """Free the program's state; keep its results (on the host), the
    inputs and the lane graph."""
    st = run.state
    for k in ("model", "store", "batches", "steps", "last", "planner",
              "calls"):
        st.pop(k, None)
    for r in st["results"].values():
        r["steps"] = [tuple(t.cpu() for t in s) for s in r["steps"]]
        r["last"] = tuple(t.cpu() for t in r["last"])
        r["crops"] = [[t.cpu() for t in c] for c in r["crops"]]
        r["calls"] = [(p.cpu(), o.cpu()) for p, o in r["calls"]]
        r["emb"] = {"map": r["emb"]["map"].cpu(),
                    "past": r["emb"]["past"].cpu(),
                    "prior": tuple(t.cpu() for t in r["emb"]["prior"])}
    harness.free_cuda()


def targets(run, got):
    """The planner future each iteration of a batch trained toward, then
    the final one (normalized, (B, FT, 4) each)."""
    k = max(1, int(run.cfg["optim"]["refresh_every"]))
    calls = got["calls"]
    return [calls[it // k][1] for it in range(len(got["steps"]))] + \
        [calls[-1][1]]


def _picked(run):
    done = sorted(run.state["results"])
    k = min(run.traffic["check"]["batches"], len(done))
    rng = np.random.default_rng([run.seed, 1])
    return sorted(rng.choice(done, size=k, replace=False).tolist()), rng


def decoder_numbers(run, pick, precision):
    """``optim.reference_numbers``' numbers of the batches ``pick``: the
    program's (or with ``precision`` 'tf32' the control's, the reference
    in TF32 run from the inputs along the program's planner futures)
    against the float32 reference along their path."""
    from ..reference.closed import closed_follow, closed_optimize

    st, dev = run.state, run.device
    n = run.traffic["pool_batches"]
    model = harness.reference_model(run.cfg, st["weights"], dev)
    control = harness.reference_model(run.cfg, st["weights"], dev,
                                      precision)
    opt = run.cfg["optim"]
    scale = run.cfg["model"]["norm"]["state"]["std"][0]
    worst = {}
    for i in pick:
        sc = scenes.pad(st["pool"][i % n], dev)
        with torch.no_grad():
            own = model.embed(sc)
        tg = [t.to(dev) for t in targets(run, st["results"][i])]
        got = st["results"][i]
        if precision != "float32":
            got = closed_optimize(control, sc, opt, tg)
        start = {"map": got["emb"]["map"].to(dev),
                 "past": got["emb"]["past"].to(dev),
                 "prior": tuple(t.to(dev) for t in got["emb"]["prior"])}
        steps = [tuple(t.to(dev) for t in s) for s in got["steps"]]
        crops = [[t.to(dev) for t in c] for c in got["crops"]]
        want = closed_follow(model, sc, opt, start, steps,
                             tuple(t.to(dev) for t in got["last"]), crops,
                             tg)
        for name, v in compare(got, want, own, scale,
                               run.traffic["check"]["min_scale"]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def planner_numbers(run, pick, rng, planner_cfg):
    """The reference planner (configuration ``planner_cfg``) on the
    program's own decode at the checked planner calls of the batches
    ``pick``, against the program's plan of each scene (module doc)."""
    from ..reference.planner import Planner

    st, cfg = run.state, run.cfg
    m = cfg["model"]
    ck = run.traffic["check"]
    n = run.traffic["pool_batches"]
    calls = [(i, c) for i in pick
             for c in range(len(st["results"][i]["calls"]) - 1)]
    rest = max(0, min(ck["refreshes"] - len(pick), len(calls)))
    chosen = [(i, len(st["results"][i]["calls"]) - 1) for i in pick] + [
        calls[j] for j in sorted(rng.choice(len(calls), size=rest,
                                            replace=False).tolist())]
    ref = Planner(st["lanes"], cfg["store"]["maps"], planner_cfg)
    f64 = torch.float64
    sm = torch.tensor(m["norm"]["state"]["mean"], dtype=f64)
    ss = torch.tensor(m["norm"]["state"]["std"], dtype=f64)
    am = torch.tensor(m["norm"]["att"]["mean"], dtype=f64)
    as_ = torch.tensor(m["norm"]["att"]["std"], dtype=f64)
    FT, dt = m["future_len"], m["bike"]["dt"]
    obs_t = torch.linspace(dt, dt * FT, FT, dtype=f64)
    gaps = []
    for i, c in chosen:
        sc = scenes.pad(st["pool"][i % n], "cpu")
        pred, out = st["results"][i]["calls"][c]
        obs = pred.to(f64) * ss[:4] + sm[:4]
        obs[:, 0] = float("nan")
        want = ref.rollout(sc["past_gt"][:, :, -1].to(f64) * ss + sm,
                           sc["lw"].to(f64) * as_ + am, sc["mask"], obs,
                           obs_t, obs_t, sc["map_idx"].tolist())
        got = out.to(f64) * ss[:4] + sm[:4]
        gaps += (got[..., :2] - want[..., :2]).norm(dim=-1).amax(1).tolist()
    g = np.array(gaps)
    return {"planner_gap_m": float(np.median(g)),
            "planner_far_share": float(np.mean(g > ck["far_m"])),
            "planner_gap_max_m": float(g.max())}


def reference_numbers(run, precision="float32"):
    """The checked numbers: the program's against the reference, or with
    ``precision`` 'tf32' the control's: the decoder numbers of the
    reference in TF32, and the planner numbers of the reference planner
    with the other published configuration, ``final_tuned_val_1``."""
    from ..reference.planner import CONFIGS

    pick, rng = _picked(run)
    out = decoder_numbers(run, pick, precision)
    out.update(planner_numbers(
        run, pick, rng, run.cfg["optim"]["planner_cfg"]
        if precision == "float32" else CONFIGS["final_tuned_val_1"]))
    return out


def check(run):
    limits = run.traffic["check"]["limits"]
    got = reference_numbers(run)
    run.checks = [(n, got[n], limits.get(n)) for n in limits]
