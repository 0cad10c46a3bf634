"""Adversarial scenario generation — the flagship pipeline, on PyTorch.

    python -m strive_tpu_torch.scripts.adv_scenario_gen -c configs/adv_gen_synthetic.cfg
    python -m strive_tpu_torch.scripts.adv_scenario_gen -c configs/adv_gen_synthetic.cfg --device cpu

Port of ``scripts/adv_scenario_gen.py`` with the same flags, defaults,
stages, log lines, stats and output folders: sample prior futures ->
feasibility filter -> batch feasible scenes -> init optimization (75
iterations on the recorded scene, then for the rule planner 100 on its
rollout) -> adversarial latent optimization (open or closed loop) ->
success check -> solution optimization -> scenario JSONs in the
{adv_sol_success, sol_failed, adv_failed} folders.

- ``--device`` defaults to ``cuda`` and raises without a card; the CPU
  runs only when asked for (``--device cpu``).
- ``--planner_backend host`` is the numpy rule planner through the host
  bridge, ``tpu`` the device planner (``DeviceRulePlanner``; the name
  stays so the configs parse). ``--closed_loop_mode`` is accepted; both
  values run the one eager closed loop of ``optim/adv.py``.
- ``--ckpt`` names a checkpoint written by the port's ``train_traffic``;
  without it the weights are random, from ``init_params`` (Flax's
  distributions, a CPU generator seeded 0). The prior noise of each
  candidate comes from ``prior_noise``, drawn from one CPU generator
  seeded 0. Both are drawn on the CPU, so the card and the CPU see the
  same numbers.
- ``--data_version mini``/``trainval`` reads the ETL output of
  ``strive_tpu_torch.scripts.preprocess_nuscenes``; ``--viz`` renders each
  scene before, after and (when solved) with its solution under
  ``<out>/viz_results/<folder>/`` (``viz.py``, needs matplotlib).
- ``--bf16`` computes the map encoder and the decoder's GNN in bfloat16
  and ``--no_output_bicycle`` has the decoder emit poses directly, as in
  ``scripts/train_traffic.py``'s ``build_model``.
- ``--mesh_devices N`` > 1 splits each batch over N processes, one a
  device (``parallel/mesh.py``): cards 0 .. N-1 with NCCL (it raises when
  fewer are visible), or with ``--device cpu`` N CPU processes with gloo.
  Each batch is padded to a multiple of N with fully masked copies of its
  first scene, each rank optimizes its rows, and rank 0 screens the
  candidates and writes the log, stats and files, which are the
  one-process run's (``run``). strive_tpu's guard on the fused closed
  loop's memory (``scripts/adv_scenario_gen.py:215-229``) has no
  counterpart: the port has no fused mode.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.loading import load_environment
from ..data.scenario_json import prepare_output_dict, save_scenario
from ..losses.common import WHOLE_BATCH
from ..losses.metrics import check_single_veh_coll
from ..normalize import REDUCED_CAT, effective_categories
from ..optim.adv import compute_adv_gen_success, run_adv_gen_optim
from ..optim.feasibility import (determine_feasibility,
                                 restrict_attackers_to_category)
from ..optim.init_optim import run_init_optim
from ..optim.sol import compute_sol_success, run_find_solution_optim
from ..parallel.mesh import (ShardedBatch, default_backend, entry_devices,
                             from_rank0, gather_rows, launch, rank,
                             rank_device, shard_rows, world)
from ..planners import PLANNER_CONFIGS, PlannerConfig, RulePlanner
from ..planners.device_planner import DeviceRulePlanner
from ..planners.host_bridge import make_planner_host_fn, reset_planner
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from ..viz import get_adv_coloring, render_scene
from .common import (build_model, init_params, load_checkpoint, prior_noise,
                     resolve_device)

INIT_FIT_ITERS = 75      # scripts/adv_scenario_gen.py:323
PLANNER_REFIT_ITERS = 100  # scripts/adv_scenario_gen.py:370


def parse_cfg(argv=None):
    parser = get_parser("Adversarial scenario generation (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--split", type=str, default="val",
                        choices=["test", "val", "train"])
    parser.add_argument("--val_size", type=int, default=400)
    parser.add_argument("--seq_interval", type=int, default=10)
    parser.add_argument("--shuffle", action="store_true", default=False)
    parser.add_argument("--random_val", action="store_true", default=True)
    parser.add_argument("--adv_attack_with", type=str, default=None)
    parser.add_argument("--planner", type=str, default="ego",
                        choices=["ego", "hardcode"])
    parser.add_argument("--planner_cfg", type=str, default="default")
    parser.add_argument("--planner_backend", type=str, default="host",
                        choices=["host", "tpu"],
                        help="'host': the numpy rule planner through the "
                             "host bridge; 'tpu': the rule planner as "
                             "batched torch ops on --device")
    parser.add_argument("--closed_loop_mode", type=str, default="fused",
                        choices=["chunked", "fused"],
                        help="accepted for the configs; both values run "
                             "the one eager closed loop")
    parser.add_argument("--planner_refresh_every", type=int, default=1,
                        help="re-roll the closed-loop planner every k-th "
                             "Adam iteration (1 = reference-exact)")
    parser.add_argument("--feasibility_thresh", type=float, default=10.0)
    parser.add_argument("--feasibility_time", type=int, default=4)
    parser.add_argument("--feasibility_vel", type=float, default=0.5)
    parser.add_argument("--feasibility_infront_min", type=float, default=0.0)
    parser.add_argument("--feasibility_check_sep", action="store_true",
                        default=False)
    parser.add_argument("--init_loss_match_ext", type=float, default=10.0)
    parser.add_argument("--init_loss_motion_prior_ext", type=float, default=0.1)
    parser.add_argument("--loss_coll_veh", type=float, default=20.0)
    parser.add_argument("--loss_coll_veh_plan", type=float, default=20.0)
    parser.add_argument("--loss_coll_env", type=float, default=20.0)
    parser.add_argument("--loss_init_z", type=float, default=0.5)
    parser.add_argument("--loss_init_z_atk", type=float, default=0.05)
    parser.add_argument("--loss_motion_prior", type=float, default=1.0)
    parser.add_argument("--loss_motion_prior_atk", type=float, default=0.005)
    parser.add_argument("--loss_motion_prior_ext", type=float, default=0.0001)
    parser.add_argument("--loss_match_ext", type=float, default=10.0)
    parser.add_argument("--loss_adv_crash", type=float, default=2.0)
    parser.add_argument("--sol_future_len", type=int, default=16)
    parser.add_argument("--sol_loss_coll_veh", type=float, default=10.0)
    parser.add_argument("--sol_loss_coll_env", type=float, default=10.0)
    parser.add_argument("--sol_loss_motion_prior", type=float, default=0.005)
    parser.add_argument("--sol_loss_init_z", type=float, default=0.0)
    parser.add_argument("--sol_loss_motion_prior_ext", type=float,
                        default=0.001)
    parser.add_argument("--sol_loss_match_ext", type=float, default=10.0)
    parser.add_argument("--num_iters", type=int, default=300)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--num_samples", type=int, default=20)
    parser.add_argument("--viz", action="store_true", default=False)
    parser.add_argument("--save", action="store_true", default=False)
    parser.add_argument("--synth_scenes", type=int, default=24)
    parser.add_argument("--max_scenes", type=int, default=None,
                        help="cap on candidate scenes (for smoke runs)")
    parser.add_argument("--mesh_devices", type=int, default=1,
                        help="split each scene batch over this many "
                             "processes, one a device: cards 0..N-1 (NCCL), "
                             "or N CPU processes with --device cpu (gloo)")
    parser.add_argument("--no_ref_compat", dest="ref_compat",
                        action="store_false", default=True,
                        help="fix the reference TgtMatchingLoss prior-weight "
                             "bug instead of replicating it (PARITY.md)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def _take_embed(emb, ids):
    """The scenes ``ids`` of an ``embed()`` output."""
    ids = torch.as_tensor(ids, dtype=torch.int64,
                          device=emb["map_feat"].device)
    return {k: (tuple(x[ids] for x in v) if isinstance(v, tuple) else v[ids])
            for k, v in emb.items()}


def _np(x):
    return x.detach().cpu().numpy()


def render_views(out_dir, scene_id, store, map_idx, past, lw, mask, colors,
                 views, state_norm):
    """One image a view, ``scene_%04d_<tag>.jpg`` under ``out_dir``
    (``scripts/adv_scenario_gen.py:508-541``).

    :param past, lw: the scene's UNNORMALIZED past and sizes (numpy)
    :param views: [(NORMALIZED future (NA, FT, 4), tag, title)]
    """
    for fut, tag, title in views:
        fut = _np(fut) if isinstance(fut, torch.Tensor) else fut
        render_scene(os.path.join(out_dir, "scene_%04d_%s.jpg"
                                  % (scene_id, tag)),
                     store, map_idx, past, state_norm.unnormalize(fut), lw,
                     mask, car_colors=colors, title=title)


def main(argv=None, timings=None, max_batches=None, init_method=None):
    """Run the pipeline; returns the stats dict.

    ``--mesh_devices N`` > 1 runs it in N processes (``run`` in each, one
    a device): cards 0 .. N-1 with NCCL, or with ``--device cpu`` N CPU
    processes with gloo.

    :param timings: optional dict, filled with each stage's wall seconds
        (``seconds``) and number of runs (``calls``): 'sample' (one a
        candidate), 'init_fit', 'planner_refit', 'adversarial', 'solution'
        and 'save' (one a batch each); the last loss of each optimization
        (``final_loss``); and ``batches`` [(secs, scenes, adv
        successes)]. Stages end in a device synchronize. Rank 0's, in a
        run of several processes.
    :param max_batches: stop after this many optimized batches (default:
        screen every candidate)
    :param init_method: the process group's rendezvous with
        ``--mesh_devices`` (``launch``'s default: a free
        ``tcp://localhost`` port)
    """
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    if cfg.mesh_devices <= 1:
        return run(cfg, device, timings, max_batches)
    devices = entry_devices(cfg.device, cfg.mesh_devices)
    stats, rank_timings = launch(
        _run_rank, (argv, timings is not None, max_batches), devices,
        default_backend(device), init_method)
    if timings is not None:
        timings.update(rank_timings)
    return stats


def _run_rank(argv, want_timings, max_batches):
    """A rank of ``main``'s processes: :return: (stats, timings or None)."""
    timings = {} if want_timings else None
    stats = run(parse_cfg(argv), rank_device(), timings, max_batches)
    return stats, timings


def pad_scenes(scene, ranks):
    """``scene`` padded to a multiple of ``ranks`` scenes with fully masked
    copies of scene 0 (``scripts/adv_scenario_gen.py:300-313``)."""
    n, pad = scene.B, (-scene.B) % ranks
    if not pad:
        return scene
    scene = scene.take(list(range(n)) + [0] * pad)
    scene.mask[n:] = False
    return scene


def run(cfg, device, timings=None, max_batches=None):
    """The pipeline on ``device`` (``main``'s arguments). Inside a process
    group (``parallel.mesh``) rank 0 screens the candidates and every rank
    acts on its verdicts; each batch is padded to a multiple of the ranks
    and each rank optimizes its rows of it; rank 0 alone logs and writes
    the scenario files, from the gathered rows. The losses' batch means
    divide by totals over every rank, and padding rows add to no sum, so
    the stats, folders and files are the one-process run's."""
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "adv_gen_log.txt"))
    Logger.log("Args: " + str(vars(cfg)))
    sec, calls = {}, {}  # each stage's wall seconds and runs
    if timings is not None:
        timings.update(seconds=sec, calls=calls, final_loss={}, batches=[])
    sharded = dist.is_initialized()
    ranks, lead = world(), rank() == 0
    if sharded:
        Logger.log(f"Sharding scene batches over {ranks} ranks "
                   f"({device.type})")

    def record_loss(name, losses):
        if timings is not None and len(losses):
            timings["final_loss"][name] = float(losses[-1])

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sec[name] = sec.get(name, 0.0) + time.perf_counter() - t0
        calls[name] = calls.get(name, 0) + 1

    def reductions(rows, n_real):
        """The batch reductions of this rank's ``rows`` of a batch whose
        first ``n_real`` rows are real (``losses.common``)."""
        if not sharded:
            return WHOLE_BATCH
        return ShardedBatch(torch.as_tensor([r < n_real for r in rows],
                                            device=device))

    need_lanes = cfg.planner == "hardcode"
    ds, store, lane_graphs, state_norm, att_norm = load_environment(
        cfg, cfg.split, load_lanegraph=need_lanes, device=device)
    eff_cats = effective_categories(cfg.agent_types, cfg.reduce_cats)
    nc = len(eff_cats)
    if cfg.adv_attack_with is not None and \
            cfg.adv_attack_with not in eff_cats and \
            not (cfg.reduce_cats and
                 REDUCED_CAT.get(cfg.adv_attack_with) in eff_cats):
        # fail fast on a typo'd category: a silent all-False restriction
        # would just produce zero scenarios with no explanation
        raise SystemExit(
            f"--adv_attack_with {cfg.adv_attack_with!r} is not in the "
            f"effective category set {eff_cats} (nor reduces into it)")
    model = build_model(cfg, state_norm, att_norm, nc, "cpu")
    if model.map_channels != store.C:
        raise ValueError(f"--map_layers give {model.map_channels} crop "
                         f"channels, the store has {store.C}")
    init_params(model)
    if cfg.ckpt is not None:
        load_checkpoint(model, cfg.ckpt)
        Logger.log("Loaded checkpoint %s" % cfg.ckpt)
    model.to(device)
    dt = 0.5

    loss_weights = {
        "coll_veh": cfg.loss_coll_veh, "coll_veh_plan": cfg.loss_coll_veh_plan,
        "coll_env": cfg.loss_coll_env, "init_z": cfg.loss_init_z,
        "init_z_atk": cfg.loss_init_z_atk,
        "motion_prior": cfg.loss_motion_prior,
        "motion_prior_atk": cfg.loss_motion_prior_atk,
        "motion_prior_ext": cfg.loss_motion_prior_ext,
        "match_ext": cfg.loss_match_ext, "adv_crash": cfg.loss_adv_crash,
    }
    init_weights = {"match_ext": cfg.init_loss_match_ext,
                    "motion_prior_ext": cfg.init_loss_motion_prior_ext}
    sol_weights = {"coll_veh": cfg.sol_loss_coll_veh,
                   "coll_env": cfg.sol_loss_coll_env,
                   "motion_prior": cfg.sol_loss_motion_prior,
                   "init_z": cfg.sol_loss_init_z,
                   "motion_prior_ext": cfg.sol_loss_motion_prior_ext,
                   "match_ext": cfg.sol_loss_match_ext}

    viz_dir = os.path.join(cfg.out, "viz_results")
    scen_dir = os.path.join(cfg.out, "scenario_results")
    if cfg.viz:
        mkdir(viz_dir)
    if cfg.save:
        mkdir(scen_dir)

    planner = None
    if cfg.planner == "hardcode":
        pc = PlannerConfig(**PLANNER_CONFIGS[cfg.planner_cfg])
        if cfg.planner_backend == "tpu":
            planner = DeviceRulePlanner(lane_graphs, store.map_names, pc,
                                        device=device)
        else:
            planner = RulePlanner(lane_graphs, store.map_names, pc)

    stats = {"candidates": 0, "feasible": 0, "adv_success": 0,
             "sol_success": 0, "planner_precollide": 0}
    pending = []  # feasible scene indices awaiting a batch
    n_total = len(ds) if cfg.max_scenes is None else min(len(ds),
                                                         cfg.max_scenes)
    order = list(range(n_total))
    t_start = time.time()
    batch_times = []  # (secs, n_scenes, n_adv_success) per optimized batch
    noise_gen = torch.Generator().manual_seed(0)
    noise_shape = (1, cfg.num_samples, ds.na_max, cfg.latent_size)

    def screen(scene):
        """Sample the candidate's futures and screen them (reference
        :176-219); :return: the number of candidate attackers, -1 when the
        ego is below the velocity threshold."""
        with stage("sample"), torch.no_grad():
            samp = model.sample_batched(
                scene, store, cfg.num_samples, include_mean=True,
                eps=prior_noise(noise_gen, noise_shape).to(device))

            # ego velocity screens (reference :176-195)
            if cfg.planner == "ego":
                ego_gt = state_norm.unnormalize(_np(scene.future_gt[0, 0]))
                vmax = np.linalg.norm(np.diff(ego_gt[:, :2], axis=0),
                                      axis=-1).max()
            else:
                ego_s = state_norm.unnormalize(_np(samp["future_pred"][0, :, 0]))
                vmax = np.linalg.norm(np.diff(ego_s[:, :, :2], axis=1),
                                      axis=-1).max()
            if vmax < cfg.feasibility_vel:
                return -1
            feas, _, _ = determine_feasibility(
                samp["future_pred"][0], scene.mask[0], state_norm,
                cfg.feasibility_thresh, cfg.feasibility_time, 0.0,
                feasibility_infront_min=cfg.feasibility_infront_min,
                check_non_drivable_separation=cfg.feasibility_check_sep,
                drivable=store.drivable(), dx=store.dx,
                map_idx=scene.map_idx[0],
            )
            if cfg.adv_attack_with is not None:
                # restrict candidate attackers to one category
                # (reference adv_scenario_gen.py:209-219)
                feas = restrict_attackers_to_category(
                    feas, scene.sem[0], eff_cats, cfg.adv_attack_with,
                    reduced=cfg.reduce_cats)
            return int(feas.sum())

    for pos, di in enumerate(order):
        is_last = pos == len(order) - 1
        scene = ds.get_batch([di])
        stats["candidates"] += 1
        # rank 0 screens; every rank acts on its verdict
        n_feas = from_rank0(screen(scene) if lead else 0, device)
        if n_feas < 0:
            Logger.log(f"scene {di}: ego below velocity threshold, skip")
            if not (is_last and pending):
                continue
        elif int(scene.num_agents()[0]) <= 1 or n_feas == 0:
            Logger.log(f"scene {di}: infeasible, skip")
            if not (is_last and pending):
                continue
        else:
            stats["feasible"] += 1
            pending.append(di)
            Logger.log(f"scene {di}: feasible "
                       f"({n_feas} candidate attackers)")

        if len(pending) < cfg.batch_size and not is_last:
            continue
        if not pending:
            continue

        batch_ids = pending
        pending = []

        def shard(ids):
            """The batch of ``ids`` padded to a multiple of the ranks
            (``pad_scenes``), this rank's rows of it, and their batch
            reductions."""
            sc = pad_scenes(ds.get_batch(ids), ranks)
            rows = shard_rows(sc.B)
            return sc, sc.take(rows), reductions(rows, len(ids))

        def stage1_fit(sc, red):
            """Embed + fit the recorded scene (reference :283-290)."""
            with stage("init_fit"):
                with torch.no_grad():
                    emb = model.embed(sc, store)
                prior = emb["prior_out"]
                init_traj = sc.future_gt
                z0, fit, losses = run_init_optim(
                    model, emb["posterior_out"][0], init_traj, sc.future_vis,
                    0.1, init_weights, sc, store, INIT_FIT_ITERS, emb, prior,
                    ref_compat=cfg.ref_compat, batch=red)
                record_loss("init_fit", losses)
            return emb, prior, z0, init_traj, fit

        def make_pfn(sc):
            """Reset the planner on the batch; its closed-loop function."""
            init_state = state_norm.unnormalize(sc.past_gt[:, :, -1])
            lw_un = att_norm.unnormalize(sc.lw)
            if cfg.planner_backend == "tpu":
                planner.reset(init_state, lw_un, sc.mask, sc.map_idx)
                return planner.make_fn(state_norm, dt, cfg.future_len)
            reset_planner(planner, init_state, lw_un, sc.mask, sc.map_idx)
            return make_planner_host_fn(planner, sc.mask, state_norm, dt,
                                        cfg.future_len)

        def planner_refit(sc, emb, prior, z0, fit, red):
            """Roll the planner on the fitted scene, make it the ego
            target, and re-fit (reference :292-310)."""
            with stage("planner_refit"):
                pfn = make_pfn(sc)
                init_traj = sc.future_gt.clone()
                init_traj[:, 0, :, :4] = pfn(fit)
                z0, fit, losses = run_init_optim(
                    model, z0, init_traj, sc.future_vis, cfg.lr, init_weights,
                    sc, store, PLANNER_REFIT_ITERS, emb, prior,
                    ref_compat=cfg.ref_compat, batch=red)
                record_loss("planner_refit", losses)
            return pfn, init_traj, z0, fit

        scene, local, red = shard(batch_ids)
        Logger.log(f"Optimizing batch of {len(batch_ids)} scenes "
                   f"{batch_ids}" + (f" (padded to {scene.B})" if scene.B
                                     != len(batch_ids) else ""))
        t0 = time.time()

        emb, prior, z_init, init_traj, init_fit = stage1_fit(local, red)

        planner_fn = None
        if cfg.planner == "hardcode":
            planner_fn, init_traj, z_init, init_fit = planner_refit(
                local, emb, prior, z_init, init_fit, red)
            # drop scenes where the planner already collides (reference :312-328)
            fit_all = gather_rows(init_fit)
            lw_un = att_norm.unnormalize(_np(scene.lw))
            mask_np = _np(scene.mask)
            keep = []
            for b in range(len(batch_ids)):
                n = int(mask_np[b].sum())
                fut = state_norm.unnormalize(_np(fit_all[b, :n]))
                lw_b = lw_un[b, :n]
                coll, _ = check_single_veh_coll(fut[0], lw_b[0], fut[1:],
                                                lw_b[1:])
                keep.append(coll.sum() == 0)
            if not all(keep):
                stats["planner_precollide"] += int(len(keep) - sum(keep))
                Logger.log("Planner pre-collision: dropping "
                           f"{len(keep) - sum(keep)}/{len(keep)} scenes")
                if not any(keep):
                    continue
                batch_ids = [bi for bi, k in zip(batch_ids, keep) if k]
                scene, local, red = shard(batch_ids)
                emb, prior, z_init, init_traj, init_fit = stage1_fit(local,
                                                                     red)
                planner_fn, init_traj, z_init, init_fit = planner_refit(
                    local, emb, prior, z_init, init_fit, red)
        B = len(batch_ids)

        # record the init scenario (ego = data / planner, reference :358-366)
        init_future_pred = gather_rows(init_fit).clone()
        init_future_pred[:, 0] = gather_rows(init_traj)[:, 0, :, :4]

        # adversarial optimization
        with stage("adversarial"):
            tgt_prior = (prior[0][:, 0], prior[1][:, 0])
            z_adv, final_traj, min_agt, min_t, losses, internal_pred = \
                run_adv_gen_optim(
                    model, z_init, cfg.lr, loss_weights, local, store,
                    cfg.num_iters, emb, cfg.planner, tgt_prior, prior,
                    cfg.feasibility_time, cfg.feasibility_infront_min,
                    planner_rollout_fn=planner_fn, ref_compat=cfg.ref_compat,
                    planner_refresh_every=cfg.planner_refresh_every,
                    batch=red)
            record_loss("adversarial", losses)
            z_adv, final_traj, min_agt, min_t, internal_pred, emb = \
                gather_rows((z_adv, final_traj, min_agt, min_t,
                             internal_pred, emb))
            prior = emb["prior_out"]
            min_agt, min_t = _np(min_agt), _np(min_t)
            adv_ok = [compute_adv_gen_success(
                final_traj[b], state_norm, att_norm, scene.lw[b],
                scene.mask[b], int(min_agt[b]))[0] for b in range(B)]
        stats["adv_success"] += sum(adv_ok)
        Logger.log(f"adv successes: {adv_ok}")

        # solution optimization on successful scenes, padded and split
        # over the ranks as the batch is (scripts/adv_scenario_gen.py:444-465)
        sol_ok = [False] * B
        sol_traj_store = {}
        sol_z_store = {}
        sol_ids = [b for b in range(B) if adv_ok[b]]
        if sol_ids:
            with stage("solution"):
                sub_all = pad_scenes(scene.take(sol_ids), ranks)
                sel = sol_ids + sol_ids[:1] * (sub_all.B - len(sol_ids))
                rows = shard_rows(sub_all.B)
                mine = [sel[r] for r in rows]
                sub = sub_all.take(rows)
                sub_emb = _take_embed(emb, mine)
                sub_prior = sub_emb["prior_out"]
                idx = torch.as_tensor(mine, device=device)
                z_sol, sol_traj, losses = run_find_solution_optim(
                    model, z_adv[idx], final_traj[idx], cfg.sol_future_len,
                    cfg.lr, sol_weights, sub, store, cfg.num_iters, sub_emb,
                    sub_prior, sub_prior, ref_compat=cfg.ref_compat,
                    batch=reductions(rows, len(sol_ids)))
                record_loss("solution", losses)
                z_sol, sol_traj = gather_rows((z_sol, sol_traj))
                for k, b in enumerate(sol_ids):
                    sol_ok[b] = compute_sol_success(
                        sol_traj[k], sub_all.take([k]), store, state_norm,
                        att_norm)
                    sol_traj_store[b] = _np(sol_traj[k])
                    sol_z_store[b] = _np(z_sol[k])
            stats["sol_success"] += sum(sol_ok)
        Logger.log(f"sol successes: {sol_ok}")
        batch_secs = time.time() - t0
        batch_times.append((batch_secs, B, int(sum(adv_ok))))
        Logger.log("Optimized batch in %.1f sec" % batch_secs)

        # save + viz per scene, from rank 0 alone
        with stage("save"):
            mask_np = _np(scene.mask)
            for b in range(B if lead else 0):
                n = int(mask_np[b].sum())
                result_dir = ("adv_failed" if not adv_ok[b]
                              else ("adv_sol_success" if sol_ok[b]
                                    else "sol_failed"))
                if cfg.save:
                    sc = {"past_gt": _np(scene.past_gt[b, :n]),
                          "lw": _np(scene.lw[b, :n]),
                          "sem": _np(scene.sem[b, :n])}
                    out_dict = prepare_output_dict(
                        sc, int(scene.map_idx[b]), store.map_names, dt,
                        state_norm, att_norm, _np(init_future_pred[b, :n]),
                        _np(final_traj[b, :n]),
                        sol_fut_traj=(sol_traj_store[b][:n] if adv_ok[b]
                                      else None),
                        attack_agt=int(min_agt[b]), attack_t=int(min_t[b]),
                        adv_z=_np(z_adv[b, :n]),
                        sol_z=(sol_z_store[b][:n] if adv_ok[b] else None),
                        prior_distrib=(_np(prior[0][b, :n]),
                                       _np(prior[1][b, :n])),
                        internal_ego_traj=_np(internal_pred[b, 0]),
                    )
                    save_scenario(os.path.join(scen_dir, result_dir),
                                  "scene_%04d" % batch_ids[b], out_dict)
                if cfg.viz:
                    render_views(os.path.join(viz_dir, result_dir),
                                 batch_ids[b], store, int(scene.map_idx[b]),
                                 state_norm.unnormalize(_np(
                                     scene.past_gt[b, :n])),
                                 att_norm.unnormalize(_np(scene.lw[b, :n])),
                                 mask_np[b, :n],
                                 get_adv_coloring(n, int(min_agt[b]), 0),
                                 [(init_future_pred[b, :n], "before",
                                   "before (init)"),
                                  (final_traj[b, :n], "after",
                                   "after (adversarial)")]
                                 + ([(sol_traj_store[b][:n], "sol",
                                      "solution")] if adv_ok[b] else []),
                                 state_norm)
        if timings is not None:
            timings["batches"].append(batch_times[-1])
        if max_batches is not None and len(batch_times) >= max_batches:
            break

    elapsed = time.time() - t_start
    Logger.log("==== adv scenario generation done ====")
    for k, v in stats.items():
        Logger.log(f"{k} = {v}")
    Logger.log("total time: %.1f sec (%.2f scenarios/hour)" % (
        elapsed, stats["adv_success"] * 3600.0 / max(elapsed, 1e-9)))
    Logger.log("stage seconds: " + ", ".join(
        "%s %.1f (%d runs)" % (k, v, calls[k]) for k, v in sec.items()))
    if len(batch_times) > 1:
        # steady-state throughput: drop the first batch (it pays the
        # one-time set-up: cuDNN plans, the allocator's first growth)
        warm = batch_times[1:]
        secs = sum(t for t, _, _ in warm)
        scn = sum(b for _, b, _ in warm)
        adv = sum(a for _, _, a in warm)
        Logger.log(
            "steady state (excl. first batch): %.1f sec for %d scenes -> "
            "%.1f candidate scenarios/hour, %.1f adv-success/hour" % (
                secs, scn, scn * 3600.0 / max(secs, 1e-9),
                adv * 3600.0 / max(secs, 1e-9)))
    return stats


if __name__ == "__main__":
    main()
