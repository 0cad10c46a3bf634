"""Solution optimization: prove the adversarial scenario is avoidable.

Port of ``strive_tpu/optim/sol.py`` (reference ``utils/sol_optim.py:19-165``):
re-optimize the planner-node latent (re-initialized from the prior mean)
to avoid all collisions over an extended ``sol_future_len`` rollout, while
the other agents' latents match the adversarial scenario.

Each iteration decodes once at ``sol_future_len`` and takes two
``torch.autograd.grad`` pulls through that graph: the avoid loss's
cotangent reaches the ego latent (slot 0) only, the match loss's (on the
first FT steps, the prefix of the autoregressive rollout) every latent but
slot 0, plus each loss's direct latent term — the routing of the
reference's two detach-partitioned decodes (``sol_optim.py:49-63``).
"""

from __future__ import annotations

import torch

from ..losses.adv import avoid_coll_loss, tgt_matching_loss
from ..losses.common import WHOLE_BATCH
from ..losses.metrics import check_single_veh_coll
from ..losses.training import compute_coll_rate_env
from .adv import _combine_z, frozen_params
from .loop import Adam


def run_find_solution_optim(model, cur_z, final_result_traj, future_len, lr,
                            loss_weights, scene, map_store, num_iters,
                            embed_info, tgt_prior_distrib,
                            other_prior_distrib, ref_compat=True,
                            batch=WHOLE_BATCH):
    """
    :param cur_z: (B, NA, D) latents from the adversarial optimization
    :param final_result_traj: (B, NA, FT, 4) NORMALIZED adv scenario (slot 0
        = true planner reaction)
    :param future_len: extended rollout length (sol_future_len, default 16)
    :param loss_weights: the ``sol_*``-stripped weight dict
    :param batch: the losses' reductions over the batch (``losses.common``)
    :return: (final z, sol_result_traj (B, NA, FT, 4) NORMALIZED, losses)
    """
    B, NA, D = cur_z.shape
    FT = final_result_traj.shape[2]
    smean, sstd = model.smean[:4], model.sstd[:4]

    def unnorm(x):
        return x * sstd + smean

    lw_unnorm = model.att_unnorm(scene.lw)
    ego_mask = torch.zeros((B, NA), dtype=torch.bool, device=cur_z.device)
    ego_mask[:, 0] = True
    other_mask = scene.mask & ~ego_mask
    other_match_unnorm = unnorm(final_result_traj)
    # the ego latent restarts from the prior mean (reference :38-39)
    tgt_z0 = tgt_prior_distrib[0][:, 0].detach()
    tgt_init_z = torch.zeros_like(cur_z)
    tgt_init_z[:, 0] = tgt_z0

    def avoid_loss(pred_ext, tgt_z):
        z_full = torch.cat([tgt_z[:, None], torch.zeros_like(cur_z[:, 1:])], 1)
        return avoid_coll_loss(
            unnorm(pred_ext), z_full, tgt_prior_distrib, lw=lw_unnorm,
            mask=scene.mask, mapixes=scene.map_idx, packed=map_store.packed,
            dx=map_store.dx, init_z=tgt_init_z, weights=loss_weights,
            veh_coll_buffer=0.5, single_veh_idx=0, z_mask=ego_mask,
            batch=batch)["loss"]

    def match_loss(pred_ft, other_z):
        return tgt_matching_loss(
            unnorm(pred_ft), other_match_unnorm, other_z, other_prior_distrib,
            loss_weights, frame_weights=other_mask[:, :, None].to(torch.float32),
            agent_mask=other_mask, ref_compat=ref_compat, batch=batch)["loss"]

    def decode(z, nfuture):
        return model.decode_embedding(z, embed_info, scene, map_store, None,
                                      nfuture)["future_pred"]

    with frozen_params(model):
        tgt_z, other_z = tgt_z0, cur_z.detach()
        adam = Adam([tgt_z, other_z], lr)
        losses = []
        for _ in range(num_iters):
            tz = tgt_z.detach().requires_grad_(True)
            oz = other_z.detach().requires_grad_(True)
            z = _combine_z(tz, oz).detach().requires_grad_(True)
            with torch.enable_grad():
                pred = decode(z, future_len)
                la = avoid_loss(pred, tz)
                lm = match_loss(pred[:, :, :FT], oz)
                gz_a, g_tgt = torch.autograd.grad(
                    la, (z, tz), retain_graph=True, allow_unused=True)
                gz_m, g_other = torch.autograd.grad(
                    lm, (z, oz), allow_unused=True)
            grad_tgt = gz_a[:, 0]
            if g_tgt is not None:
                grad_tgt = grad_tgt + g_tgt
            grad_other = torch.cat([torch.zeros_like(gz_m[:, :1]),
                                    gz_m[:, 1:]], 1)
            if g_other is not None:
                grad_other = grad_other + g_other
            tgt_z, other_z = adam.step([tgt_z, other_z], [grad_tgt, grad_other])
            losses.append((la + lm).detach())

        with torch.no_grad():
            z_final = _combine_z(tgt_z, other_z)
            dec = decode(z_final, FT)
            # non-ego trajectories are the adversarial scenario's
            # (reference :120-121)
            sol_result = torch.where(ego_mask[:, :, None, None], dec,
                                     final_result_traj)
    losses = batch.values(torch.stack(losses)) if losses else torch.zeros(0)
    return z_final, sol_result, losses


def compute_sol_success(sol_result_traj, scene, map_store, state_norm,
                        att_norm, use_map_coll=True):
    """No collision with agents (and optionally the map) => solved.

    :param sol_result_traj: (NA, FT, 4) NORMALIZED single scene
    :param scene: a one-scene ``SceneBatch``
    :return: bool (reference ``utils/sol_optim.py:126-165``)
    """
    mask = scene.mask[0].cpu().numpy()
    n = int(mask.sum())
    fut = state_norm.unnormalize(sol_result_traj[:n].detach().cpu().numpy())
    lw_u = att_norm.unnormalize(scene.lw[0, :n].cpu().numpy())
    coll, _ = check_single_veh_coll(fut[0], lw_u[0], fut[1:], lw_u[1:])
    impossible = bool(coll.sum() > 0)

    if use_map_coll and not impossible:
        env = compute_coll_rate_env(
            scene, sol_result_traj[None, None], map_store, state_norm,
            att_norm, ego_only=True)
        impossible = bool(env["did_collide"][0, 0, 0])
    return not impossible
