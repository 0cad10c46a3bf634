"""Evaluate the traffic model, on PyTorch.

    python -m strive_tpu_torch.scripts.test_traffic -c configs/test_synth_prod.cfg
    python -m strive_tpu_torch.scripts.test_traffic -c configs/test_synth_prod.cfg --device cpu

Port of ``scripts/test_traffic.py`` with the same flags, defaults, log
lines and returned metrics: per batch the loss, reconstruction and KL terms
and the pos/ang errors and z NLL/Mahalanobis distance of the posterior-mean
decode; with ``--test_sample_disp_err`` the ego's minADE/minFDE (position
and angle) and APD over ``--test_sample_num`` prior samples; with
``--test_sample_coll_rate`` and ``--test_recon_coll_rate`` the map (ego)
and vehicle collision rates of the samples and of the reconstruction. Each
metric is the mean over batches of its batch mean.

- ``--device`` defaults to ``cuda`` and raises without a card; the CPU
  runs only when asked for (``--device cpu``).
- ``--ckpt`` names a checkpoint of the port's ``train_traffic``; without
  it the weights are Flax's distributions from a generator seeded 0. The
  sample noise comes from ``prior_noise`` (a CPU generator seeded 0).
- ``--data_version mini``/``trainval`` reads the ETL output of
  ``strive_tpu_torch.scripts.preprocess_nuscenes``.
- The visualizations of the first 3 batches, under ``<out>/viz``
  (``viz.py``, needs matplotlib): ``--test_sample_viz_multi`` every
  sample of the first scene overlaid (``sample_<i>.jpg``),
  ``--test_sample_viz_rollout`` the first sample's per-step frames
  (``rollout_<i>``, an mp4 where ffmpeg is present),
  ``--test_recon_viz_multi`` the reconstruction of the first two scenes
  beside the ground truth (``recon_multi_<i>_<b>.jpg``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.dataset import bucketed_batch_iterator as batch_iterator
from ..data.loading import load_environment
from ..losses.metrics import compute_coll_rate_veh_dense
from ..losses.training import (compute_coll_rate_env, compute_disp_err,
                               compute_err, traffic_model_loss)
from ..normalize import effective_categories
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from ..viz import render_rollout_video, render_scene
from .common import (build_model, init_params, load_checkpoint, prior_noise,
                     resolve_device)

EVAL_KEYS = ("loss", "recon_loss", "kl_loss", "pos_err", "ang_err",
             "z_logprob", "z_mdist")


def parse_cfg(argv=None):
    parser = get_parser("Test traffic model (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--shuffle_test", action="store_true", default=False)
    parser.add_argument("--test_sample_num", type=int, default=10)
    parser.add_argument("--test_sample_future_len", type=int, default=12)
    parser.add_argument("--test_sample_viz_multi", action="store_true",
                        default=False)
    parser.add_argument("--test_sample_viz_rollout", action="store_true",
                        default=False)
    parser.add_argument("--test_sample_disp_err", action="store_true",
                        default=False)
    parser.add_argument("--test_sample_coll_rate", action="store_true",
                        default=False)
    parser.add_argument("--test_recon_viz_multi", action="store_true",
                        default=False)
    parser.add_argument("--test_recon_coll_rate", action="store_true",
                        default=False)
    parser.add_argument("--loss_kl", type=float, default=0.004)
    parser.add_argument("--loss_recon", type=float, default=1.0)
    parser.add_argument("--synth_scenes", type=int, default=24)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def _np(x):
    return x.detach().cpu().numpy()


def main(argv=None):
    """Evaluate; returns {metric: mean over batches}."""
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "test_log.txt"))
    Logger.log("Args: " + str(vars(cfg)))

    ds, store, _, state_norm, att_norm = load_environment(cfg, cfg.split,
                                                          device=device)
    nc = len(effective_categories(cfg.agent_types, cfg.reduce_cats))
    model = build_model(cfg, state_norm, att_norm, nc, "cpu")
    init_params(model)
    if cfg.ckpt is not None:
        _, epoch, _ = load_checkpoint(model, cfg.ckpt)
        Logger.log(f"Loaded checkpoint from epoch {epoch}")
    model.to(device)

    weights = {"recon": cfg.loss_recon, "kl": cfg.loss_kl}
    do_samples = (cfg.test_sample_disp_err or cfg.test_sample_coll_rate
                  or cfg.test_sample_viz_multi or cfg.test_sample_viz_rollout)
    viz_dir = os.path.join(cfg.out, "viz")
    noise_gen = torch.Generator().manual_seed(0)
    metrics = {}

    def acc(k, v):
        v = _np(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        metrics.setdefault(k, []).append(float(np.mean(v)))

    def unnorm_state(x):
        return state_norm.unnormalize(_np(x))

    def coll_rates(prefix, scene, fut, n_traj):
        """Map (ego) and vehicle collision rates of (B, NS, NA, FT, 4)
        NORMALIZED futures."""
        env = compute_coll_rate_env(scene, fut, store, state_norm, att_norm,
                                    ego_only=True)
        acc(prefix + "coll_rate_env", float(env["num_coll_map"])
            / max(float(env["num_traj_map"]), 1))
        did = compute_coll_rate_veh_dense(
            _np(state_norm.unnormalize(fut)),
            _np(att_norm.unnormalize(scene.lw)), _np(scene.mask))
        acc(prefix + "coll_rate_veh", did.sum() / max(n_traj, 1))

    with torch.no_grad():
        for i, scene in enumerate(batch_iterator(ds, cfg.batch_size,
                                                 shuffle=cfg.shuffle_test)):
            pred = model(scene, store, use_post_mean=True)
            out = traffic_model_loss(scene, pred, weights, state_norm,
                                     att_norm, store)
            out.update(compute_err(scene, pred, state_norm))
            for k in EVAL_KEYS:
                acc(k, out[k])

            n_agents = float(_np(scene.mask).sum())
            if do_samples:
                eps = prior_noise(noise_gen, (scene.B, cfg.test_sample_num,
                                              scene.NA, model.latent_size))
                samp = model.sample_batched(
                    scene, store, cfg.test_sample_num,
                    nfuture=cfg.test_sample_future_len, eps=eps.to(device))
                fut = samp["future_pred"]
                if cfg.test_sample_disp_err:
                    for k, v in compute_disp_err(scene, fut,
                                                 state_norm).items():
                        acc(k, v)
                if cfg.test_sample_coll_rate:
                    coll_rates("", scene, fut, n_agents * fut.shape[1])
            # reconstruction-based evaluations (reference test_traffic.py:137-167)
            if cfg.test_recon_coll_rate or cfg.test_recon_viz_multi:
                recon = model.reconstruct(scene, store)
                if cfg.test_recon_coll_rate:
                    coll_rates("recon_", scene, recon["future_pred"][:, None],
                               n_agents)
                if cfg.test_recon_viz_multi and i < 3:
                    for b in range(min(scene.B, 2)):
                        render_scene(
                            os.path.join(viz_dir, f"recon_multi_{i}_{b}.jpg"),
                            store, int(scene.map_idx[b]),
                            unnorm_state(scene.past_gt[b]),
                            unnorm_state(recon["future_pred"][b]),
                            att_norm.unnormalize(_np(scene.lw[b])),
                            _np(scene.mask[b]),
                            title=f"recon batch {i} scene {b}",
                            gt_future=unnorm_state(
                                scene.future_gt[b, :, :, :4]))
            if cfg.test_sample_viz_rollout and i < 3:
                # per-step rollout video of the first sample (reference
                # test_traffic.py:195-208, viz_traj=False + make_video)
                render_rollout_video(
                    os.path.join(viz_dir, f"rollout_{i}"), store,
                    int(scene.map_idx[0]), unnorm_state(scene.past_gt[0]),
                    unnorm_state(fut[0, 0]),
                    att_norm.unnormalize(_np(scene.lw[0])),
                    _np(scene.mask[0]))
            if cfg.test_sample_viz_multi and i < 3:
                # ALL NS samples overlaid, one color per sample (reference
                # test_traffic.py:181-193 -> viz_scene_graph)
                fut_un = unnorm_state(fut[0])  # (NS, NA, FT, 4)
                render_scene(
                    os.path.join(viz_dir, f"sample_{i}.jpg"), store,
                    int(scene.map_idx[0]), unnorm_state(scene.past_gt[0]),
                    fut_un, att_norm.unnormalize(_np(scene.lw[0])),
                    _np(scene.mask[0]),
                    title=f"sample batch {i} ({fut_un.shape[0]} samples)")

    Logger.log("==== evaluation results ====")
    for k, v in sorted(metrics.items()):
        Logger.log("%s = %f" % (k, float(np.mean(v))))
    return {k: float(np.mean(v)) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
