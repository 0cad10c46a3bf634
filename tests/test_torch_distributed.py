"""Multi-process runs of the port (``strive_tpu_torch/parallel/mesh.py``)
against its one-process runs, with gloo on the CPU at 2 and 4 ranks (the
process groups meet through a file under ``tmp_path``, not a TCP port).

- The ``Trainer``'s step: the gradients within 1e-5 of each leaf's norm,
  or within the one-process step's own float noise on that leaf where
  that is larger: the difference between its gradient and the gradient
  of the same batch with its rows reversed, mathematically equal. That
  noise exceeds 1e-5 of the norm on ``map_encoder.conv0.bias`` alone,
  a bias in front of a GroupNorm, whose gradient is what is left after
  its terms cancel (measured: 4.0e-5 of its norm reversed, 1.98e-5 at 4
  ranks, 3.2e-6 at 2). The train and eval losses within 1e-6 (relative),
  ``compute_err``'s metrics at tests/test_torch_train.py's tolerances
  (rtol 1e-4 / atol 1e-5, ang_err atol 1e-3 deg), the parameters after
  the Adam step the same on every rank and within 1e-6 of the
  one-process step's where the gradient is not within float noise of 0
  (|g| >= 1e-6; elsewhere within 2 lr, as tests/test_torch_train.py
  holds its step). A batch that does not split over the ranks raises,
  as strive_tpu's sharding does. The batch (B=4 x NA=4, the tiny model of
  tests/helpers.py) has 4, 3, 2 and 0 valid agents, the last scene masked
  out as ``batch_iterator`` pads a tail: the ranks' rows hold different
  numbers of agents, so a plain DDP average of the ranks' own losses is
  another loss, which the test shows (its loss and its gradient more
  than 100 times this test's tolerances off), and the step must sum the
  losses' numerators and denominators over the ranks.
- The coupled reductions of the pipeline's objectives, one at a time:
  ``adv_gen_loss`` (the "every candidate is behind" test over the batch,
  the weighted means and the mean of adv_crash), ``avoid_coll_loss``
  (the solution), ``tgt_matching_loss`` with frame weights (the fits) and
  as a mean over the batch (the adversarial loop's ego term), on 3 scenes
  padded to 4 with a masked copy of scene 0. In scenes 0 and 1 every
  candidate is behind the target, in scene 2 one is ahead: the batch's
  filter is on, and a shard of scenes 0-1 alone would switch it off,
  which the test shows. The loss summed over the ranks within 1e-6
  (relative), its gradients within 1e-5 of their norm, ``min_agt`` and
  ``min_t`` exactly.
- ``adv_scenario_gen`` on ``configs/adv_gen_synthetic.cfg`` with
  ``--batch_size 3`` (not a multiple of 2 or 4) at 2 and 4 ranks, and so
  again with every scene an adversarial success, so that the solution
  optimization runs on a padded sub-batch too; and the closed loop of
  ``configs/adv_gen_synthetic_hardcode.cfg`` with the device planner
  through ``main(... --mesh_devices 2)``. The stats, the feasible-scene
  log lines, the folders, the JSON names and ``attack_agt`` /
  ``attack_t`` equal the one-process run's, and the trajectories and
  latents are held at chip_smoke.py's ``PARITY_TRAJ_M`` 0.2 m /
  ``PARITY_LATENT`` 0.6, with the weights those were measured with
  (torch's default initializers, phase 9b), the bounds its phase 14b
  holds two ranks on one card to: the 75-iteration fit amplifies float
  noise (ROADMAP §3), and a rank's smaller batch rounds some GEMMs
  otherwise (the BLAS's blocking depends on the rows). Measured here: 0.0
  in the closed loop, at most 0.065 m and 0.204 over 2 and 4 ranks (the
  largest differences are printed); two gloo ranks on one H100 against
  one process, 0.185 m and 0.206.
- ``train_traffic --mesh_devices`` 2 and 4 on the CPU against one
  process: the same checkpoints, and each epoch's losses within 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets the torch thread count)
import torch_dist_ranks as ranks
from helpers import make_scene
from torch_helpers import scene_to_torch

from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.model.traffic_model import init_model_params
from strive_tpu_torch.parallel import mesh
from strive_tpu_torch.scripts import adv_scenario_gen as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL, LOSS_REL = 1e-5, 1e-6
# compute_err's metrics, at tests/test_torch_train.py's tolerances (arccos
# near 1 turns 1e-7 into 1e-3 deg)
ERR_TOL = {"pos_err": dict(rtol=1e-4, atol=1e-5),
           "ang_err": dict(rtol=1e-4, atol=1e-3),
           "z_logprob": dict(rtol=1e-4, atol=1e-5),
           "z_mdist": dict(rtol=1e-4, atol=1e-5)}
# chip_smoke.py's PARITY_TRAJ_M / PARITY_LATENT (module doc)
TRAJ_TOL_M, LATENT_TOL = 0.2, 0.6
FOLDERS = ("adv_sol_success", "sol_failed", "adv_failed")


def _launch(fn, args, n, tmp_path):
    return mesh.launch(fn, args, ["cpu"] * n, "gloo",
                       init_method=f"file://{tmp_path}/pg{n}")


def _close(got, want, rel, what):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    err = float((got - want).abs().max())
    assert err <= rel * max(float(want.abs().max()), 1e-30), (what, err)


# ---- the train and eval steps ------------------------------------------------

@pytest.fixture(scope="module")
def train_case():
    rng = np.random.default_rng(0)
    scene = scene_to_torch(make_scene(rng, B=4, NA=4, PT=4, FT=6,
                                      na_per_scene=[4, 3, 2, 1]))
    scene.mask[3] = False
    model = ranks.tiny_model()
    init_model_params(model, seed=0)
    store = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    eps = torch.randn((4, 4, model.latent_size), generator=gen)
    eps_samp = torch.randn((4, 4, model.latent_size), generator=gen)
    args = (model.state_dict(), scene, store, eps, eps_samp)
    rev = [3, 2, 1, 0]
    reversed_grads = ranks.train_step(args[0], scene.take(rev), store,
                                      eps[rev], eps_samp[rev])[0]
    one = ranks.train_step(*args)
    noise = [(a - b).abs().max() for a, b in zip(reversed_grads, one[0])]
    return args, one, noise


def test_plain_ddp_average_is_another_loss(train_case):
    """The case the step must get right: the mean of each half's own loss
    and gradient is not the batch's."""
    (state, scene, store, eps, eps_samp), (grads, whole, _, _, _), _ = \
        train_case
    own = [ranks.train_step(state, scene.take(r), store, eps[r],
                            eps_samp[r])[:2] for r in ([0, 1], [2, 3])]
    loss = (own[0][1]["loss"] + own[1][1]["loss"]) / 2
    assert abs(float(loss - whole["loss"])) > \
        100 * LOSS_REL * abs(float(whole["loss"]))
    worst = max(float((a + b - 2 * g).abs().max() / (2 * g.norm()))
                for a, b, g in zip(own[0][0], own[1][0], grads))
    assert worst > 100 * GRAD_REL, worst


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_is_the_one_process_step(train_case, tmp_path, n):
    args, (g1, m1, e1, p1, _), noise = train_case
    gn, mn, en, pn, same = _launch(ranks.train_step, args, n, tmp_path)
    assert same, "the ranks' parameters differ after the step"
    for i, (a, b) in enumerate(zip(gn, g1)):
        err = float((a - b).abs().max())
        bound = max(GRAD_REL * float(b.norm()), float(noise[i]))
        assert err <= bound, (i, err, float(b.norm()), float(noise[i]))
    assert sorted(mn) == sorted(m1) and sorted(en) == sorted(e1)
    for got, want in ((mn, m1), (en, e1)):
        for k in want:
            if k in ERR_TOL:
                torch.testing.assert_close(got[k], want[k], **ERR_TOL[k])
            else:
                _close(got[k], want[k], LOSS_REL, k)
    # Adam's first step is lr * g / (|g| + 1e-8): where |g| is within
    # float noise of 0 the step itself is noise, held within 2 lr
    # (tests/test_torch_train.py's rule)
    steady = torch.cat([g.reshape(-1) for g in g1]).abs() >= 1e-6
    diff = (pn - p1).abs()
    assert float(diff[steady].max()) <= 1e-6
    assert float(diff.max()) <= 2 * ranks.LR


def test_sharded_step_raises_on_a_batch_that_does_not_split(train_case,
                                                            tmp_path):
    """3 scenes over 2 ranks: a ValueError, as strive_tpu's ``device_put``
    of a batch its mesh does not divide raises one, and the launcher
    raises once every rank has stopped."""
    (state, scene, store, eps, eps_samp), _, _ = train_case
    rows = [0, 1, 2]
    with pytest.raises(Exception, match="does not split over 2 ranks"):
        _launch(ranks.train_step, (state, scene.take(rows), store, eps[rows],
                                   eps_samp[rows]), 2, tmp_path)


# ---- the pipeline's objectives -----------------------------------------------

def _objective_batch():
    """3 scenes x 4 agents (ego + 3 candidates) over T = 6 steps, padded to
    4 with a masked copy of scene 0 (module doc)."""
    gen = torch.Generator().manual_seed(1)
    B, NA, T, D = 3, 4, 6, 8
    t = torch.arange(T, dtype=torch.float32)
    tgt = torch.zeros((B, T, 4))
    tgt[..., 0] = 60.0 + 2.0 * t
    tgt[..., 1] = 64.0
    tgt[..., 2] = 1.0
    fp = tgt[:, None].repeat(1, NA, 1, 1)
    fp[:, 1:, :, 0] -= torch.tensor([4.0, 7.0, 11.0])[None, :, None]
    fp[:, 1:, :, 1] += torch.tensor([0.5, -1.0, 1.5])[None, :, None]
    fp[2, 2, :, 0] += 16.0  # scene 2: one candidate ahead of the target
    fp = fp + 0.1 * torch.randn(fp.shape, generator=gen)
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 1, 1]],
                        dtype=torch.bool)
    x = {"future_pred": fp, "tgt": tgt,
         "match": fp + torch.randn(fp.shape, generator=gen),
         "z": torch.randn((B, NA, D), generator=gen),
         "init_z": torch.randn((B, NA, D), generator=gen),
         "prior_mean": torch.randn((B, NA, D), generator=gen),
         "prior_var": 0.5 + torch.rand((B, NA, D), generator=gen),
         "lw": torch.tensor([4.5, 2.0]).repeat(B, NA, 1),
         "mask": mask, "map_idx": torch.tensor([0, 1, 0])}
    store = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    x.update(packed=store.packed, dx=store.dx)
    padded = {k: (torch.cat([v, v[:1]]) if k not in ("packed", "dx") else v)
              for k, v in x.items()}
    padded["mask"][3] = False
    return x, padded


@pytest.fixture(scope="module")
def objective_runs(tmp_path_factory):
    x, padded = _objective_batch()
    one = ranks.objectives(x, torch.ones(3, dtype=torch.bool))
    real = torch.tensor([True, True, True, False])
    tmp = tmp_path_factory.mktemp("objectives")
    return x, one, {n: _launch(ranks.objectives, (padded, real), n, tmp)
                    for n in (2, 4)}


def test_one_shard_all_behind_switches_its_own_filter_off(objective_runs):
    """Scenes 0 and 1 alone (rank 0's shard at 2 ranks): every candidate
    is behind, so their own filter is off and their attackers change."""
    x, one, _ = objective_runs
    alone = ranks.objectives({k: (v[:2] if k not in ("packed", "dx") else v)
                              for k, v in x.items()},
                             torch.ones(2, dtype=torch.bool))
    assert not torch.equal(alone["adv_gen"][2], one["adv_gen"][2][:2])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ranks.OBJECTIVES)
def test_sharded_objective_is_the_batch_objective(objective_runs, n, name):
    _, one, sharded = objective_runs
    loss1, grads1, rows1 = one[name]
    loss, grads, rows = sharded[n][name]
    _close(loss, loss1, LOSS_REL, "loss")
    for what, g, g1 in zip(("future_pred", "z"), grads, grads1):
        err = float((g[:3] - g1).abs().max())
        assert err <= GRAD_REL * float(g1.norm()), (what, err)
        assert not g[3:].any(), "the padding row has a gradient"
    if rows1 is not None:  # min_agt, min_t
        assert torch.equal(rows[:3], rows1)


# ---- the pipeline, whole -------------------------------------------------------

COMMON = ["--device", "cpu", "--num_iters", "2", "--num_samples", "4",
          "--synth_scenes", "6", "--max_scenes", "6", "--batch_size", "3"]
OPEN = "configs/adv_gen_synthetic.cfg"
CLOSED = "configs/adv_gen_synthetic_hardcode.cfg"


def _scenes(out):
    """{folder: {name: json dict}} of one run's scenario folders."""
    res = {}
    for d in FOLDERS:
        path = os.path.join(out, "scenario_results", d)
        res[d] = {}
        for name in sorted(os.listdir(path)) if os.path.isdir(path) else []:
            with open(os.path.join(path, name)) as f:
                res[d][name] = json.load(f)
    return res


def _feasible_lines(out):
    with open(os.path.join(out, "adv_gen_log.txt")) as f:
        return [l for l in f.read().splitlines() if ": feasible (" in l]


def _pipeline(tmp, name, cfg, extra, n, how):
    out = str(tmp / f"{name}{n}")
    argv = ["-c", os.path.join(REPO, cfg), "--out", out] + COMMON + extra
    if how == "main":  # the entry point, its own weights
        flags = ["--mesh_devices", str(n)] if n > 1 else []
        return tgen.main(argv + flags,
                         init_method=f"file://{tmp}/pg_{name}{n}"), out
    args = (argv, how == "all_succeed")
    if n == 1:
        return ranks.pipeline(*args), out
    return _launch(ranks.pipeline, args, n, tmp), out


# name: (config, flags, how it runs, rank counts besides 1)
PIPELINES = {"open": (OPEN, [], "torch_init", (2, 4)),
             "solution": (OPEN, [], "all_succeed", (2, 4)),
             "closed": (CLOSED, ["--planner_backend", "tpu"], "main", (2,))}


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def pipeline_runs(request, tmp_path_factory):
    cfg, extra, how, counts = PIPELINES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    return request.param, {n: _pipeline(tmp, request.param, cfg, extra, n,
                                        how)
                           for n in (1,) + counts}


def test_sharded_pipeline_is_the_one_process_pipeline(pipeline_runs):
    name, runs = pipeline_runs
    want_stats, want_out = runs[1]
    want = _scenes(want_out)
    assert want_stats["feasible"] > 0
    if name == "solution":
        assert want["adv_sol_success"] or want["sol_failed"]
    worst = {}
    for n, (stats, out) in runs.items():
        assert stats == want_stats, n
        assert _feasible_lines(out) == _feasible_lines(want_out), n
        got = _scenes(out)
        for d in FOLDERS:
            assert sorted(got[d]) == sorted(want[d]), (n, d)
            for fname, w in want[d].items():
                g = got[d][fname]
                assert sorted(g) == sorted(w), (n, d, fname)
                assert (g["attack_agt"], g["attack_t"]) == \
                    (w["attack_agt"], w["attack_t"]), (n, d, fname)
                for k in ("fut_init", "fut_adv", "fut_internal_ego",
                          "fut_sol", "z_adv", "z_sol"):
                    if k in w:
                        err = float(np.abs(np.asarray(g[k])
                                           - np.asarray(w[k])).max())
                        worst[k] = max(worst.get(k, 0.0), err)
    print(name, "largest differences, sharded against one process:", worst)
    for k, v in worst.items():
        tol = LATENT_TOL if k.startswith("z_") else TRAJ_TOL_M
        assert v <= tol, f"{k}: largest difference {v:.3g} > {tol}"


# ---- train_traffic, data-parallel ----------------------------------------------

TRAIN_CFG = os.path.join(REPO, "configs", "train_traffic_synthetic.cfg")


@pytest.mark.parametrize("n", [2, 4])
def test_train_traffic_data_parallel(tmp_path, n):
    """``train_traffic --device cpu --mesh_devices n`` on the synthetic
    config (2 epochs of 2 batches of 4, validation and checkpoints every
    epoch) against one process: the same checkpoints, written once, and
    every epoch's train and validation losses within 1e-5 (relative: four
    Adam steps carry the float noise of |g| ~ 0 elements, module doc)."""
    from strive_tpu_torch.scripts import train_traffic
    from strive_tpu_torch.utils.checkpoint import load_state

    runs = {}
    for k, flags in ((1, []), (n, ["--mesh_devices", str(n)])):
        timings = {}
        out = tmp_path / f"r{k}"
        train_traffic.main(["-c", TRAIN_CFG, "--out", str(out), "--device",
                            "cpu"] + flags, timings,
                           init_method=f"file://{tmp_path}/pg")
        runs[k] = out, timings
    (one, t1), (dp, tn) = runs[1], runs[n]
    assert sorted(os.listdir(dp / "checkpoints")) == \
        sorted(os.listdir(one / "checkpoints"))
    for split in ("train", "val"):
        assert len(tn[split]) == len(t1[split]) == 2
        for got, want in zip(tn[split], t1[split]):
            for k in ("loss", "recon_loss", "kl_loss"):
                _close(got[k], want[k], 1e-5, (split, k))
    a = load_state(str(dp / "checkpoints" / "latest_model"))
    b = load_state(str(one / "checkpoints" / "latest_model"))
    assert a[2] == b[2] and sorted(a[0]) == sorted(b[0])
    _close(a[3], b[3], 1e-5, "min val loss")
