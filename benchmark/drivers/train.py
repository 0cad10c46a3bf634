"""Driver ``train``: the prior's training, epoch after epoch.

Set-up builds one ``train.Trainer`` on the model and drives it through
its first ``check.steps`` steps, each a ``Trainer.run_epoch`` call over
the next batch of the window's own feed; the check reads the program's
state from those steps (each step's loss, its gradient from Adam's first
moment, the parameters before and after it, the poses its rollouts
cropped the map at) and the parameters' change after the last. The window then
calls ``run_epoch`` on the same trainer over
``data.dataset.batch_iterator(SceneDataset(pool), B, shuffle=True)``,
epoch after epoch (epoch e shuffled by the seed and e), with
``step_seconds``; the harness's wrapper of the iterator times each
``next`` (``data_wait_s``) and stops yielding once ``--seconds`` have
passed, which ends the window. A step counts as attempted when drawn and
as failed when ``run_epoch`` skips it. A traced run then runs a few more
steps for the profiled span.

Traffic keys: ``pool_scenes`` (a multiple of the batch size, so no step
is padded), ``check.steps``, ``check.limits``, ``check.min_grad``
(leaves whose reference gradient norm is under this share of the median
leaf's are left out of the change).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import harness
from ..inputs import scenes, weights


def _feed(run, epoch):
    from strive_tpu_torch.data.dataset import batch_iterator

    return batch_iterator(run.state["ds"], run.cfg["batch_size"],
                          shuffle=True, seed=[run.seed, epoch])


def order(seed, epoch, n):
    """The scenes of epoch ``epoch``, in the feed's order (worked out
    again for the reference)."""
    o = np.arange(n)
    np.random.default_rng([seed, epoch]).shuffle(o)
    return o


def setup(run):
    from strive_tpu_torch.data.dataset import SceneDataset
    from strive_tpu_torch.train import Trainer

    cfg, dev = run.cfg, run.device
    st = run.state
    m = cfg["model"]
    st["weights"] = weights.draw(m, run.seed, dev)
    st["store"] = harness.program_store(cfg["store"], dev)
    model = harness.program_model(m, st["weights"], dev)
    st["pool"] = scenes.batch(run.seed, 0, cfg["store"],
                              run.traffic["pool_scenes"], cfg["max_agents"],
                              m["past_len"], m["future_len"], m["norm"],
                              sorted(m["agent_types"]))
    st["ds"] = SceneDataset(st["pool"], cfg["max_agents"],
                            len(m["agent_types"]), device=dev)
    sn, an = harness.normalizers(m)
    o = cfg["optim"]
    tr = Trainer(model, o["weights"], sn, an, lr=o["lr"])
    st["trainer"], st["kl"] = tr, o["weights"]["kl"]
    st["epoch"], st["it"] = 0, _feed(run, 0)
    st["names"] = [n for n, _ in model.named_parameters()]
    names, b1 = st["names"], tr.opt.b1
    steps, mu = [], [torch.zeros_like(p) for p in tr.params]
    for k in range(run.traffic["check"]["steps"]):
        before = [p.detach().clone() for p in tr.params]
        with harness.CropPoses() as rec:
            out, _ = tr.run_epoch(iter([next(st["it"])]), st["store"],
                                  st["kl"])
        # the step's gradient as Adam got it, from its first moment
        grads = [(u - b1 * u0) / (1.0 - b1) for u, u0 in zip(tr.opt.mu, mu)]
        mu = [u.clone() for u in tr.opt.mu]
        steps.append({"loss": out["loss"],
                      "grads": dict(zip(names, grads)),
                      "before": dict(zip(names, before)),
                      "after": {n: p.detach().clone()
                                for n, p in zip(names, tr.params)},
                      "crops": [p.cpu() for p in rec.poses[1:]]})
    st["steps"] = steps


class _Deadline:
    """The feed, timed, stopping once the deadline has passed or, with
    ``limit``, after that many batches."""

    def __init__(self, it, deadline, run, limit=None):
        self.it, self.deadline, self.run = it, deadline, run
        self.limit = limit
        self.drawn = 0
        self.wait = 0.0
        self.ended = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.drawn and self.run.tracer is not None:
            self.run.tracer.boundary()
        if harness.now() >= self.deadline or self.drawn == self.limit:
            self.ended = True
            raise StopIteration
        t = harness.now()
        batch = next(self.it)  # StopIteration ends the epoch
        self.wait += harness.now() - t
        self.drawn += 1
        return batch


def window(run):
    st = run.state
    tr = st["trainer"]
    secs, drawn, wait = [], 0, 0.0
    t0 = harness.now()
    deadline = t0 + run.seconds
    while True:
        feed = _Deadline(st["it"], deadline, run)
        tr.run_epoch(feed, st["store"], st["kl"], step_seconds=secs)
        drawn += feed.drawn
        wait += feed.wait
        if feed.ended:
            break
        st["epoch"] += 1
        st["it"] = _feed(run, st["epoch"])
    run.window_s = harness.now() - t0
    if run.tracer is not None:  # a few more steps, not counted
        run.tracer.armed = True
        left = run.tracer.needed + 1
        while left > 0:
            feed = _Deadline(st["it"], float("inf"), run, limit=left)
            tr.run_epoch(feed, st["store"], st["kl"])
            left -= feed.drawn
            if not feed.ended:
                st["epoch"] += 1
                st["it"] = _feed(run, st["epoch"])
    run.attempted, run.failed = drawn, drawn - len(secs)
    B = run.cfg["batch_size"]
    run.work = {"steps": len(secs), "scenes": len(secs) * B}
    run.data_wait_s = wait
    run.unit_s = secs


def release(run):
    for k in ("trainer", "store", "ds", "it"):
        run.state.pop(k, None)
    harness.free_cuda()


def _leaf_gap(got, want, names, keep=None):
    """Worst leaf's |norm of got - norm of want| over the larger of want's
    norm and the median leaf's; leaves outside ``keep`` left out."""
    g = np.array([float(got[n].norm()) for n in names])
    w = np.array([float(want[n].norm()) for n in names])
    keep = np.ones(len(names), bool) if keep is None else keep
    floor = np.maximum(w, np.median(w[keep]))
    return float(np.max((np.abs(g - w) / floor)[keep]))


def reference_numbers(run, precision="float32"):
    """The program's first steps against the float32 reference's from the
    same weights, batches and noise, or with ``precision`` 'tf32' the
    control's (the reference computed in TF32, from the inputs alone)
    against it. The reference follows the compared run step by step: each
    step from that run's parameters before it, cropping the map where its
    rollouts cropped it (PERF.md: an ulp of difference in a pose moves a
    crop sample across a rounding tie, and Adam's steps carry small
    differences of one step into the next), with its own Adam moments;
    ``pose_gap_m`` holds its own rollouts to those poses.
    :return: {name: value}"""
    from ..reference.optim import train_steps

    st, cfg, dev = run.state, run.cfg, run.device
    steps = run.traffic["check"]["steps"]
    B, n = cfg["batch_size"], len(st["pool"])
    o = order(run.seed, 0, n)
    batches = [scenes.pad([st["pool"][j] for j in o[k * B:(k + 1) * B]],
                          dev) for k in range(steps)]
    gen = torch.Generator().manual_seed(0)
    shape = (B, cfg["max_agents"], cfg["model"]["latent_size"])
    noise = []
    for _ in range(steps):
        eps = torch.randn(shape, generator=gen)
        noise.append((eps.to(dev),
                      torch.randn(shape, generator=gen).to(dev)))
    names = st["names"]

    def steps_of(precision, follow=None):
        model = harness.reference_model(cfg, st["weights"], dev, precision)
        out = train_steps(model, batches, noise, cfg["optim"], follow)
        return [{"loss": out["losses"][k], "grads": out["grads"][k],
                 "before": out["before"][k], "after": out["after"][k],
                 "crops": out["crops"][k]} for k in range(steps)]

    if precision == "float32":
        got = st["steps"]
    else:  # the control: the reference in TF32 in the program's place
        got = steps_of(precision)
    want = steps_of("float32", [
        ({k: v.to(dev) for k, v in s["before"].items()},
         [p.to(dev) for p in s["crops"]]) for s in got])
    g1 = np.array([float(want[0]["grads"][k].norm()) for k in names])
    moved = g1 >= run.traffic["check"]["min_grad"] * np.median(g1)
    change_got = {k: got[-1]["after"][k] - st["weights"][k] for k in names}
    change_want = {k: sum(s["after"][k] - s["before"][k] for s in want)
                   for k in names}
    return {"pose_gap_m": max(harness.pose_gap_m(w["crops"], g["crops"])
                              for g, w in zip(got, want)),
            "loss_gap": harness.rel_gap([s["loss"] for s in got],
                                        [s["loss"] for s in want]),
            "grad_gap": _leaf_gap(got[0]["grads"], want[0]["grads"], names),
            "left_out": [n for n, k in zip(names, moved) if not k],
            "change_gap": _leaf_gap(change_got, change_want, names, moved),
            "by_step": [{"pose_gap_m": harness.pose_gap_m(w["crops"],
                                                          g["crops"]),
                         "loss_gap": harness.rel_gap([g["loss"]],
                                                     [w["loss"]]),
                         "grad_gap": _leaf_gap(g["grads"], w["grads"],
                                               names)}
                        for g, w in zip(got, want)]}


def check(run):
    limits = run.traffic["check"]["limits"]
    got = reference_numbers(run)
    run.checks = [(n, got[n], limits.get(n)) for n in limits]
