"""Driver ``optim``: a stream of adversarial latent optimizations.

Each batch is ``TrafficModel.embed`` of B scenes, then
``optim.adv.run_adv_gen_optim`` from the prior mean, open loop (the ego's
recorded future is the planner), and its result read to the host. Batches
start until ``--seconds`` have passed; the one running at the deadline
finishes; the window ends with it. A batch counts as attempted when it
starts and as failed if it raises. A traced run then runs more batches for
the profiled span.

Traffic keys: ``pool_batches`` (distinct batches made in set-up; the
stream cycles through them), ``warmup_iters`` (iterations of the set-up
batch, which runs every shape of the window), ``check.batches`` (batches
the check recomputes, drawn from the seed among those finished),
``check.limits``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import harness
from ..inputs import scenes, weights


def _scenes(run, index):
    cfg = run.cfg
    m = cfg["model"]
    return scenes.batch(run.seed, index, cfg["store"], cfg["batch_size"],
                        cfg["max_agents"], m["past_len"], m["future_len"],
                        m["norm"], sorted(m["agent_types"]))


def _optimize(run, scene, iters):
    """One batch through the program: :return: its result, the result
    read to the host (the embedding and the iterations' latents and
    gradients stay on the card until :func:`release`)."""
    from strive_tpu_torch.optim.adv import run_adv_gen_optim

    st = run.state
    o = run.cfg["optim"]
    with torch.no_grad():
        emb = st["model"].embed(scene, st["store"])
    mu, var = emb["prior_out"]
    st["steps"] = []
    with harness.CropPoses() as rec:
        z, res, agt, t, losses, _ = run_adv_gen_optim(
            st["model"], mu, o["lr"], o["weights"], scene, st["store"],
            iters, emb, o["planner"], (mu[:, 0], var[:, 0]), (mu, var),
            o["feasibility_time"], None)
    FT = run.cfg["model"]["future_len"]
    crops = [rec.poses[k:k + FT] for k in range(0, len(rec.poses), FT)]
    return {"z": z.cpu(), "result": res.cpu(), "losses": losses.cpu(),
            "min_agt": agt.cpu(), "min_t": t.cpu(), "steps": st["steps"],
            "crops": crops,
            "emb": {"map": emb["map_feat"], "past": emb["past_feat"],
                    "prior": (mu, var)}}


def setup(run):
    from strive_tpu_torch.scene import pad_scene_arrays

    cfg, dev = run.cfg, run.device
    st = run.state
    st["weights"] = weights.draw(cfg["model"], run.seed, dev)
    st["store"] = harness.program_store(cfg["store"], dev)
    st["model"] = harness.program_model(cfg["model"], st["weights"], dev)
    nc = len(cfg["model"]["agent_types"])
    n = run.traffic["pool_batches"]
    st["pool"] = [_scenes(run, i) for i in range(n + 1)]
    st["batches"] = [pad_scene_arrays(s, cfg["max_agents"], nc, device=dev)
                     for s in st["pool"]]
    _optimize(run, st["batches"][n], run.traffic["warmup_iters"])
    st["results"] = {}


class _Recorded:
    """The program's Adam, keeping each step's latents and gradients (the
    tensors themselves: no copy, no kernel) and calling the tracer, if
    any, after each step."""

    def __init__(self, adam_cls, run):
        self.cls, self.run = adam_cls, run

    def __call__(self, *a, **k):
        opt = self.cls(*a, **k)
        step, run = opt.step, self.run

        def recorded(params, grads):
            out = step(params, grads)
            run.state["steps"].append((*params, *grads))
            run.state["last"] = tuple(out)
            if run.tracer is not None:
                run.tracer.boundary()
            return out

        opt.step = recorded
        return opt


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
    """Free the program's state; keep its results (on the host) and the
    inputs."""
    st = run.state
    for k in ("model", "store", "batches", "steps", "last"):
        st.pop(k, None)
    for r in st["results"].values():
        r["steps"] = [tuple(t.cpu() for t in s) for s in r["steps"]]
        r["last"] = tuple(t.cpu() for t in r["last"])
        r["crops"] = [[t.cpu() for t in c] for c in r["crops"]]
        r["emb"] = {"map": r["emb"]["map"].cpu(),
                    "past": r["emb"]["past"].cpu(),
                    "prior": tuple(t.cpu() for t in r["emb"]["prior"])}
    harness.free_cuda()


def _flat(*ts):
    return torch.cat([t.reshape(-1).cpu() for t in ts])


def compare(got, want, own, scale, min_scale):
    """The numbers compared of one batch: ``got`` (the program's, or the
    control's) against the reference's ``own`` embedding of the inputs
    and ``want``, the reference along ``got``'s path
    (``reference.optim.adv_follow``)."""
    (mp, vp), (mr, vr) = got["emb"]["prior"], [t.cpu() for t in own["prior"]]
    mp, vp = mp.cpu(), vp.cpu()
    steps = got["steps"]
    nxt = [s[:2] for s in steps[1:]] + [got["last"]]
    loss, grad, step = [], [], []
    for k, s in enumerate(steps):
        lp, lr = float(got["losses"][k]), want["losses"][k]
        loss.append(abs(lp - lr) / abs(lr))
        gp, gr = _flat(*s[2:]), _flat(*want["grads"][k])
        grad.append(float((gp - gr).norm() / gr.norm()))
        here = _flat(*s[:2])
        dp, dr = _flat(*nxt[k]) - here, _flat(*want["reach"][k]) - here
        # a latent whose gradients have all been nought to rounding moves
        # by Adam's g / (|g| + eps) of rounding noise: left out
        sc = _flat(*want["scale"][k])
        keep = sc >= min_scale * sc.median()
        step.append(float((dp - dr)[keep].norm() / dr[keep].norm()))
    dres = got["result"][..., :2].cpu() - want["result"][..., :2].cpu()
    # loss, gradient and step: the median iteration. One iteration's loss
    # and gradient can jump where a footprint sample of K2 or a message of
    # the GNN's masked max sits on a tie, one latent's step flip where its
    # gradient is nought to rounding (PERF.md)
    return {"prior_gap": float(torch.maximum(
                (mp - mr).abs().max(), ((vp - vr) / vr).abs().max())),
            "map_feat_gap": float((got["emb"]["map"].cpu()
                                   - own["map"].cpu()).abs().max()),
            "pose_gap_m": max(harness.pose_gap_m(a, b) for a, b in
                              zip(want["crops"], got["crops"])),
            "loss_gap": float(np.median(loss)),
            "grad_gap": float(np.median(grad)),
            "step_gap": float(np.median(step)),
            "result_gap_m": float(dres.abs().max()) * scale,
            "loss_gap_max": max(loss), "grad_gap_max": max(grad),
            "step_gap_max": max(step)}


def reference_numbers(run, precision="float32"):
    """The numbers of the sampled batches, the largest of each: the
    program's batches against the float32 reference, or with
    ``precision`` 'tf32' the control's (the reference computed in TF32,
    run from the inputs alone) against it. The reference computes the
    embedding from the inputs, and follows the iterations along the
    compared run's own path: its latents, and the poses its rollouts
    cropped the map at (PERF.md: an ulp of difference in a pose moves a
    crop sample across a rounding tie, and Adam carries such a jump
    through the later iterations, in float32 as in TF32); ``pose_gap_m``
    holds the reference's own rollouts to those poses."""
    from ..reference.optim import adv_follow, adv_optimize

    st = run.state
    done = sorted(st["results"])
    k = min(run.traffic["check"]["batches"], len(done))
    rng = np.random.default_rng([run.seed, 1])
    pick = sorted(rng.choice(done, size=k, replace=False).tolist())
    n = run.traffic["pool_batches"]
    model = harness.reference_model(run.cfg, st["weights"], run.device)
    control = harness.reference_model(run.cfg, st["weights"], run.device,
                                      precision)
    opt = run.cfg["optim"]
    scale = run.cfg["model"]["norm"]["state"]["std"][0]
    dev = run.device
    worst = {}
    for i in pick:
        sc = scenes.pad(st["pool"][i % n], dev)
        with torch.no_grad():
            own = model.embed(sc)
        if precision == "float32":
            got = st["results"][i]
        else:
            c = adv_optimize(control, sc, opt)
            got = {"losses": c["losses"], "result": c["result"],
                   "steps": c["steps"], "last": c["last"],
                   "emb": c["emb"], "crops": c["crops"]}
        start = {"map": got["emb"]["map"].to(dev),
                 "past": got["emb"]["past"].to(dev),
                 "prior": tuple(t.to(dev) for t in got["emb"]["prior"])}
        steps = [tuple(t.to(dev) for t in s) for s in got["steps"]]
        crops = [[t.to(dev) for t in c] for c in got["crops"]]
        want = adv_follow(model, sc, opt, start, steps,
                          tuple(t.to(dev) for t in got["last"]), crops)
        for name, v in compare(got, want, own, scale,
                               run.traffic["check"]["min_scale"]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def check(run):
    limits = run.traffic["check"]["limits"]
    got = reference_numbers(run)
    run.checks = [(n, got[n], limits.get(n)) for n in limits]
