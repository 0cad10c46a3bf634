"""Refine sampled futures to remove collisions while staying likely under
the prior, on PyTorch.

    python -m strive_tpu_torch.scripts.refine_traffic_optim -c configs/refine_traffic_optim.cfg
    python -m strive_tpu_torch.scripts.refine_traffic_optim -c CFG --device cpu

Port of ``scripts/refine_traffic_optim.py`` with the same flags, defaults,
log lines and stats: scenes with fewer than ``--feasibility_num`` agents
are skipped; the rest are batched ``--batch_size`` at a time, one prior
sample a scene is drawn at ``--samp_future_len``, its latents are refined
by Adam (or L-BFGS with ``--optim_use_lbfgs``, ``optim/refine.py``), and
the refined future (at ``--save_future_len``) counts as a success when no
vehicle and no map collision remains (``count_collisions``). With
``--save`` each scene's JSON goes to ``<out>/scenario_results/{success,
failed}/scene_%04d.json``.

- ``--device`` defaults to ``cuda`` and raises without a card; the CPU
  runs only when asked for (``--device cpu``).
- ``--ckpt`` names a checkpoint of the port's ``train_traffic``; without
  it the weights are Flax's distributions from a generator seeded 0. The
  sample noise of each batch comes from ``prior_noise`` (a CPU generator
  seeded 0).
- ``--data_version mini``/``trainval`` reads the ETL output of
  ``strive_tpu_torch.scripts.preprocess_nuscenes``; ``--viz`` renders each
  refined scene to ``<out>/viz_results/{success,failed}/scene_%04d.jpg``
  (``viz.py``, needs matplotlib).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.loading import load_environment
from ..data.scenario_json import prepare_output_dict, save_scenario
from ..losses.metrics import compute_coll_rate_veh_dense
from ..losses.training import compute_coll_rate_env
from ..normalize import effective_categories
from ..optim.refine import run_refine_optim
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from ..viz import render_scene
from .common import (build_model, init_params, load_checkpoint, prior_noise,
                     resolve_device)


def parse_cfg(argv=None):
    parser = get_parser("Refine sampled traffic (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--val_size", type=int, default=400)
    parser.add_argument("--random_val", action="store_true", default=True)
    parser.add_argument("--seq_interval", type=int, default=10)
    parser.add_argument("--shuffle", action="store_true", default=False)
    parser.add_argument("--feasibility_num", type=int, default=10,
                        help="min num agents in scene")
    parser.add_argument("--samp_future_len", type=int, default=16)
    parser.add_argument("--save_future_len", type=int, default=12)
    parser.add_argument("--num_iters", type=int, default=200)
    parser.add_argument("--optim_use_lbfgs", dest="optim_use_adam",
                        action="store_false", default=True,
                        help="use L-BFGS instead of Adam (reference "
                             "refine_traffic_optim.py:53-55)")
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--loss_coll_veh", type=float, default=100.0)
    parser.add_argument("--loss_coll_env", type=float, default=100.0)
    parser.add_argument("--loss_init_z", type=float, default=0.01)
    parser.add_argument("--loss_motion_prior", type=float, default=1.0)
    parser.add_argument("--viz", action="store_true", default=False)
    parser.add_argument("--save", action="store_true", default=False)
    parser.add_argument("--max_scenes", type=int, default=None)
    parser.add_argument("--synth_scenes", type=int, default=24)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def count_collisions(scene, fut, store, state_norm, att_norm):
    """(vehicle-colliding agents, map-colliding agents) of a refined batch
    (reference refine success check :322-335).

    :param fut: (B, NA, T, 4) NORMALIZED
    """
    env = compute_coll_rate_env(scene, fut[:, None], store, state_norm,
                                att_norm)
    n_env = int(env["num_coll_map"])
    did = compute_coll_rate_veh_dense(
        _np(state_norm.unnormalize(fut[:, None])),
        _np(att_norm.unnormalize(scene.lw)), _np(scene.mask))
    return int(did.sum()), n_env


def _np(x):
    return x.detach().cpu().numpy()


def main(argv=None, timings=None):
    """Refine; returns the stats dict.

    :param timings: optional dict, filled with each batch's wall seconds
        (``batches``, from the sampling to the refined decode, ended by a
        device synchronize) and loss history (``losses``).
    """
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "refine_log.txt"))
    Logger.log("Args: " + str(vars(cfg)))
    if timings is not None:
        timings.update(batches=[], losses=[])
    dt = 0.5

    ds, store, _, state_norm, att_norm = load_environment(cfg, cfg.split,
                                                          device=device)
    nc = len(effective_categories(cfg.agent_types, cfg.reduce_cats))
    model = build_model(cfg, state_norm, att_norm, nc, "cpu")
    init_params(model)
    if cfg.ckpt is not None:
        load_checkpoint(model, cfg.ckpt)
    model.to(device)

    weights = {"coll_veh": cfg.loss_coll_veh, "coll_env": cfg.loss_coll_env,
               "init_z": cfg.loss_init_z,
               "motion_prior": cfg.loss_motion_prior}
    noise_gen = torch.Generator().manual_seed(0)

    n = len(ds) if cfg.max_scenes is None else min(len(ds), cfg.max_scenes)
    stats = {"scenes": 0, "success": 0, "failed": 0, "skipped": 0}
    pending = []
    for pos in range(n):
        if int(ds.get_batch([pos]).num_agents()[0]) < cfg.feasibility_num:
            stats["skipped"] += 1
            continue
        pending.append(pos)
        if len(pending) < cfg.batch_size and pos != n - 1:
            continue
        batch_ids, pending = pending, []
        scene = ds.get_batch(batch_ids)
        t0 = time.time()
        with torch.no_grad():
            eps = prior_noise(noise_gen, (scene.B, 1, scene.NA,
                                          model.latent_size))
            samp = model.sample_batched(scene, store, 1,
                                        nfuture=cfg.samp_future_len,
                                        eps=eps.to(device))
            z0 = samp["z_samp"][:, 0]
            emb = model.embed(scene, store)
        zf, fut, losses = run_refine_optim(
            model, z0, cfg.lr, weights, scene, store, cfg.num_iters, emb,
            emb["prior_out"], samp_future_len=cfg.samp_future_len,
            save_future_len=cfg.save_future_len,
            optimizer="adam" if cfg.optim_use_adam else "lbfgs")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if timings is not None:
            timings["batches"].append(time.time() - t0)
            timings["losses"].append(_np(losses))
        Logger.log("refined %d scenes in %.1fs" % (scene.B, time.time() - t0))
        mask_np = _np(scene.mask)
        for b in range(scene.B):
            n_veh, n_env = count_collisions(scene.take([b]), fut[b:b + 1],
                                            store, state_norm, att_norm)
            ok = (n_veh == 0) and (n_env == 0)
            stats["scenes"] += 1
            stats["success" if ok else "failed"] += 1
            result_dir = "success" if ok else "failed"
            na = int(mask_np[b].sum())
            if cfg.save:
                sc = {"past_gt": _np(scene.past_gt[b, :na]),
                      "lw": _np(scene.lw[b, :na]),
                      "sem": _np(scene.sem[b, :na])}
                out_dict = prepare_output_dict(
                    sc, int(scene.map_idx[b]), store.map_names, dt,
                    state_norm, att_norm,
                    _np(samp["future_pred"][b, 0, :na,
                                            :cfg.save_future_len]),
                    _np(fut[b, :na]), adv_z=_np(zf[b, :na]),
                    prior_distrib=(_np(emb["prior_out"][0][b, :na]),
                                   _np(emb["prior_out"][1][b, :na])))
                save_scenario(os.path.join(cfg.out, "scenario_results",
                                           result_dir),
                              "scene_%04d" % batch_ids[b], out_dict)
            if cfg.viz:
                render_scene(
                    os.path.join(cfg.out, "viz_results", result_dir,
                                 "scene_%04d.jpg" % batch_ids[b]),
                    store, int(scene.map_idx[b]),
                    state_norm.unnormalize(_np(scene.past_gt[b, :na])),
                    state_norm.unnormalize(_np(fut[b, :na])),
                    att_norm.unnormalize(_np(scene.lw[b, :na])),
                    mask_np[b, :na],
                )

    Logger.log("==== refine done ====")
    for k, v in stats.items():
        Logger.log(f"{k} = {v}")
    return stats


if __name__ == "__main__":
    main()
