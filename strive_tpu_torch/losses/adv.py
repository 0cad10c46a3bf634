"""Adversarial latent-optimization losses.

Port of ``strive_tpu/losses/adv.py`` (reference ``losses/adv_gen_nusc.py``
TgtMatchingLoss :14-51, AdvGenLoss :53-262, AvoidCollLoss :264-341,
check_behind :646-673): the per-scene softmin over the flat node dimension
is a masked softmax over the (NA, T) axes of each scene. All trajectories
UNNORMALIZED.

Each objective takes ``batch``, the reductions over the scene batch that
its means divide by: the whole batch in this process by default, a rank's
share of it under ``parallel.mesh.ShardedBatch``.
"""

from __future__ import annotations

import torch

from ..geometry import interp_traj
from .common import WHOLE_BATCH
from .penalties import env_coll_penalties, motion_prior_nll, veh_coll_penalties


def tgt_matching_loss(future_pred, tgt_traj, z, prior_out, weights,
                      frame_weights=None, agent_mask=None, ref_compat=True,
                      batch=WHOLE_BATCH):
    """Match a decoded future to a target while staying likely under the prior.

    :param future_pred, tgt_traj: (..., 4) UNNORMALIZED, same shape
    :param ref_compat: reproduce the reference bug at ``adv_gen_nusc.py:46``
        where the motion-prior weight multiplies the *matching* loss.
    """
    out = {}
    loss = 0.0
    tgt_loss_mean = 0.0
    if weights.get("match_ext", 0.0) > 0.0:
        tgt_loss = torch.sum((future_pred - tgt_traj) ** 2, dim=-1)
        tgt_loss_mean = (batch.mean(tgt_loss) if frame_weights is None
                         else batch.weighted_mean(tgt_loss, frame_weights))
        loss = loss + weights["match_ext"] * tgt_loss_mean
        out["match_ext_loss"] = tgt_loss_mean

    if weights.get("motion_prior_ext", 0.0) > 0.0:
        nll = motion_prior_nll(z, prior_out)
        nll_mean = (batch.mean(nll) if agent_mask is None
                    else batch.weighted_mean(nll, agent_mask.to(nll.dtype)))
        prior_term = tgt_loss_mean if ref_compat else nll_mean
        loss = loss + weights["motion_prior_ext"] * prior_term
        out["motion_prior_ext_loss"] = nll_mean

    out["loss"] = loss
    return out


def check_behind(attacker_fut, tgt_fut, crash_min_infront):
    """(B, NA, T) True where the agent is behind the target at that step."""
    tgt_h = tgt_fut[:, None, :, 2:4]
    d = attacker_fut[..., :2] - tgt_fut[:, None, :, :2]
    n = torch.linalg.vector_norm(d, dim=-1)
    cossim = torch.where(n > 1e-9,
                         torch.sum(d * tgt_h, -1) / torch.clamp(n, min=1e-9),
                         torch.inf)
    return cossim < crash_min_infront


def adv_gen_loss(future_pred, tgt_traj, z, prior_out, *, lw, mask, mapixes,
                 packed, dx, init_z, weights, veh_coll_buffer=0.0,
                 crash_min_t=0, crash_min_infront=None, attack_agt_mask=None,
                 batch=WHOLE_BATCH):
    """The adversarial objective (reference ``adv_gen_nusc.py:53-262``).

    :param future_pred: (B, NA, T, 4) UNNORMALIZED; agent 0 models the planner
    :param tgt_traj: (B, T, 4) UNNORMALIZED planner trajectory to attack
    :param z, prior_out, init_z: (B, NA, D); ego entries are ignored
    :param lw: (B, NA, 2) UNNORMALIZED
    :param packed: (M, H, W) bit-packed raster, bit 0 the drivable layer
    :param mask: (B, NA) real-agent mask
    :param attack_agt_mask: optional (B, NA) restricting candidate attackers
    :return: dict with 'loss', per-component values, and 'min_agt'/'min_t'
        (B,) current most-likely attacker index (dense, ego=0) and timestep.
    """
    B, NA, T, _ = future_pred.shape
    dev = future_pred.device
    idx = torch.arange(NA, device=dev)
    nonego = mask & (idx[None, :] > 0)
    Tp = T - crash_min_t
    out = {}
    loss = 0.0

    # --- adv_crash: softmin-weighted squared distance to the planner -------
    atk_pred = future_pred[:, :, crash_min_t:]
    tgt_pred = tgt_traj[:, crash_min_t:, :4]
    valid = nonego[:, :, None].expand(B, NA, Tp)
    diff = atk_pred[..., :2] - tgt_pred[:, None, :, :2]
    # mask invalid rows before the norm, eps-safe sqrt: no NaN grads
    diff = torch.where(valid[..., None], diff, 1.0)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)  # (B, NA, Tp)
    min_dist_in = torch.where(valid, dist, torch.inf)

    if crash_min_infront is not None:
        behind_steps = check_behind(atk_pred.detach(), tgt_pred.detach(),
                                    crash_min_infront)
        behind_traj = torch.all(behind_steps | ~valid, dim=2, keepdim=True)
        behind_traj = behind_traj.expand_as(behind_steps)
        # if EVERY candidate of the batch is behind, ignore the filter
        # (reference :120-122)
        n_valid = batch.total(valid)
        all_behind = (batch.total(behind_traj & valid)
                      == torch.clamp(n_valid, min=1))
        behind_traj = torch.where(all_behind, False, behind_traj)
        min_dist_in = torch.where(behind_traj, torch.inf, min_dist_in)

    if attack_agt_mask is not None:
        min_dist_in = torch.where(attack_agt_mask[:, :, None], min_dist_in,
                                  torch.inf)

    # masked softmin per scene over (NA, Tp)
    logits = -min_dist_in.reshape(B, NA * Tp)
    finite = torch.isfinite(logits)
    lmax = torch.amax(torch.where(finite, logits, -torch.inf), dim=1,
                      keepdim=True)
    lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
    ex = torch.where(finite, torch.exp(logits - lmax), 0.0)
    denom = torch.sum(ex, dim=1, keepdim=True)
    softmin = torch.where(denom > 0, ex / torch.clamp(denom, min=1e-30), 0.0)

    flat_arg = torch.argmax(softmin, dim=1)
    out["min_agt"] = flat_arg // Tp
    out["min_t"] = flat_arg % Tp + crash_min_t

    dist_sq = dist.reshape(B, NA * Tp) ** 2
    adv_crash = torch.sum(
        softmin * torch.where(torch.isfinite(dist_sq), dist_sq, 0.0)
        * valid.reshape(B, NA * Tp), dim=1)
    if weights.get("adv_crash", 0.0) > 0.0:
        adv_crash_mean = batch.mean(adv_crash)
        loss = loss + weights["adv_crash"] * adv_crash_mean
        out["adv_crash_loss"] = adv_crash_mean

    # prior reweighting: likely attackers get the *_atk weights
    prior_reweight = 1.0 - torch.sum(softmin.detach().reshape(B, NA, Tp),
                                     dim=2)

    if weights.get("motion_prior", 0.0) > 0.0:
        nll = motion_prior_nll(z, prior_out)
        coeff = (prior_reweight * weights["motion_prior"]
                 + (1.0 - prior_reweight) * weights.get("motion_prior_atk", 0.0))
        mp = batch.weighted_mean(nll * coeff, nonego.to(nll.dtype))
        loss = loss + mp
        out["motion_prior_loss"] = mp

    # regularizers on x3-interpolated trajectories
    fut_interp = interp_traj(future_pred, scale_factor=3)
    if (weights.get("coll_veh", 0.0) > 0.0
            or weights.get("coll_veh_plan", 0.0) > 0.0):
        pens, coll = veh_coll_penalties(fut_interp, lw, mask,
                                        buffer_dist=veh_coll_buffer)

    if weights.get("coll_veh", 0.0) > 0.0:
        pair_nonego = (idx[None, :, None] > 0) & (idx[None, None, :] > 0)
        veh_loss = batch.masked_mean(pens, coll & pair_nonego[:, None])
        loss = loss + weights["coll_veh"] * veh_loss
        out["coll_veh_loss"] = veh_loss

    if weights.get("coll_veh_plan", 0.0) > 0.0:
        w_vec = torch.where(idx[None, :] == 0, 1.0, prior_reweight)
        wmat = torch.where(
            idx[None, :, None] == 0, w_vec[:, None, :],
            torch.where(idx[None, None, :] == 0, w_vec[:, :, None], 1.0))
        ego_pair = (idx[None, :, None] == 0) | (idx[None, None, :] == 0)
        plan_loss = batch.masked_mean(pens * wmat[:, None],
                                      coll & ego_pair[:, None])
        loss = loss + weights["coll_veh_plan"] * plan_loss
        out["coll_veh_plan_loss"] = plan_loss

    if weights.get("coll_env", 0.0) > 0.0:
        env_pens, env_valid = env_coll_penalties(
            fut_interp, lw, nonego, mapixes, packed, dx)
        env_loss = batch.masked_mean(env_pens, env_valid)
        loss = loss + weights["coll_env"] * env_loss
        out["coll_env_loss"] = env_loss

    if weights.get("init_z", 0.0) > 0.0:
        sq = torch.sum((init_z - z) ** 2, dim=-1)
        coeff = (prior_reweight * weights["init_z"]
                 + (1.0 - prior_reweight) * weights.get("init_z_atk", 0.0))
        # the reference SUMS this term over agents (adv_gen_nusc.py:222)
        init_loss = torch.sum(sq * coeff * nonego.to(sq.dtype))
        loss = loss + init_loss
        out["init_loss"] = init_loss

    out["loss"] = loss
    return out


def avoid_coll_loss(future_pred, z, prior_out, *, lw, mask, mapixes, packed,
                    dx, init_z, weights, veh_coll_buffer=0.0,
                    single_veh_idx=None, z_mask=None, batch=WHOLE_BATCH):
    """Collision-avoidance objective (reference ``adv_gen_nusc.py:264-341``).

    :param future_pred: (B, NA, T, 4) UNNORMALIZED
    :param z, prior_out, init_z: (B, NA, D); ``z_mask`` (B, NA) selects which
        agents' latents the prior/init terms apply to (the reference passes
        only the optimized agents' z — e.g. the planner node in sol optim).
    :param packed: (M, H, W) bit-packed raster, bit 0 the drivable layer
    :param single_veh_idx: restrict collision terms to pairs involving this
        agent index, and the environment term to this agent alone (0 = the
        planner node, used by solution optimization).
    """
    if z_mask is None:
        z_mask = mask
    zw = z_mask.to(torch.float32)
    out = {}
    loss = 0.0
    fut_interp = interp_traj(future_pred, scale_factor=3)

    if weights.get("coll_veh", 0.0) > 0.0:
        pens, coll = veh_coll_penalties(fut_interp, lw, mask,
                                        buffer_dist=veh_coll_buffer,
                                        single_veh_idx=single_veh_idx)
        veh_loss = batch.masked_mean(pens, coll)
        loss = loss + weights["coll_veh"] * veh_loss
        out["coll_veh_loss"] = veh_loss

    if weights.get("coll_env", 0.0) > 0.0:
        if single_veh_idx is not None:
            sel = slice(single_veh_idx, single_veh_idx + 1)
            traj, env_mask, env_lw = fut_interp[:, sel], mask[:, sel], lw[:, sel]
        else:
            traj, env_mask, env_lw = fut_interp, mask, lw
        env_pens, env_valid = env_coll_penalties(traj, env_lw, env_mask,
                                                 mapixes, packed, dx)
        env_loss = batch.masked_mean(env_pens, env_valid)
        loss = loss + weights["coll_env"] * env_loss
        out["coll_env_loss"] = env_loss

    if weights.get("motion_prior", 0.0) > 0.0:
        nll = motion_prior_nll(z, prior_out)
        mp = batch.weighted_mean(nll, zw)
        loss = loss + weights["motion_prior"] * mp
        out["motion_prior_loss"] = mp

    if weights.get("init_z", 0.0) > 0.0:
        sq = torch.sum((init_z - z) ** 2, dim=-1)
        init_loss = batch.weighted_mean(sq, zw)
        loss = loss + weights["init_z"] * init_loss
        out["init_loss"] = init_loss

    out["loss"] = loss
    return out
