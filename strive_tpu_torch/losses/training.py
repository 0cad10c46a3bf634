"""Training loss and evaluation errors of the traffic model.

Port of ``strive_tpu/losses/training.py`` (reference
``losses/traffic_model.py``): ``traffic_model_loss`` (TrafficModelLoss,
:20-118), ``compute_err`` (:120-164), ``compute_disp_err`` (:297-364),
``compute_coll_rate_env`` (:366-419) and
``compute_coll_rate_env_from_traj``. The ego-only environment prior reaches
the footprint kernel through ``env_coll_penalties`` at detached poses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..maps.queries import check_on_layer
from .common import WHOLE_BATCH, kl_normal, log_normal
from .penalties import env_coll_penalties, veh_coll_penalties

ENV_COLL_THRESH = 0.05  # reference losses/traffic_model.py:17
VEH_COLL_THRESH = 0.02  # reference losses/traffic_model.py:18


def traffic_model_loss(scene, pred, weights, state_norm, att_norm,
                       map_store=None, batch=WHOLE_BATCH):
    """Weighted CVAE training loss (reference ``losses/traffic_model.py:34-118``).

    :param pred: dict with future_pred (B,NA,FT,4), prior_out, posterior_out,
        optionally future_samp.
    :param weights: dict with recon/kl/coll_veh_prior/coll_env_prior floats.
    :return: dict of scalar losses: recon NLL under a unit-variance Gaussian
        on visible frames, KL(q||p) per agent, and the optional prior-sample
        collision penalties (vehicle over all agents normalized by the pair
        count; environment on the ego only).
    """
    gt = scene.future_gt
    fp = pred["future_pred"]
    w_frame = scene.future_vis * scene.mask[:, :, None].to(torch.float32)
    recon_nll = -log_normal(fp, gt[..., :4], torch.ones_like(fp))
    recon_loss = batch.weighted_mean(recon_nll, w_frame)

    pm, pv = pred["prior_out"]
    qm, qv = pred["posterior_out"]
    kl_loss = batch.weighted_mean(kl_normal(qm, qv, pm, pv),
                                  scene.mask.to(torch.float32))

    loss = weights["recon"] * recon_loss + weights["kl"] * kl_loss
    out = {"recon_loss": recon_loss, "kl_loss": kl_loss}

    if weights.get("coll_veh_prior", 0.0) > 0.0 and "future_samp" in pred:
        samp = state_norm.unnormalize(pred["future_samp"])
        lw_unnorm = att_norm.unnormalize(scene.lw)
        pens, _ = veh_coll_penalties(samp, lw_unnorm, scene.mask)
        na = torch.sum(scene.mask, dim=1).to(torch.float32)
        num_pairs = batch.total(na * na - na)
        coll_veh = torch.sum(pens) / torch.clamp(num_pairs, min=1.0)
        loss = loss + weights["coll_veh_prior"] * coll_veh
        out["coll_veh_prior"] = coll_veh

    if weights.get("coll_env_prior", 0.0) > 0.0 and "future_samp" in pred:
        if map_store is None:
            raise ValueError("coll_env_prior needs the map store")
        ego_samp = state_norm.unnormalize(pred["future_samp"][:, 0:1])
        ego_lw = att_norm.unnormalize(scene.lw[:, 0:1])
        pens, _ = env_coll_penalties(ego_samp, ego_lw, scene.mask[:, 0:1],
                                     scene.map_idx, map_store.packed,
                                     map_store.dx)
        # the reference averages over every (ego, T) entry, zeros included
        coll_env = batch.mean(pens)
        loss = loss + weights["coll_env_prior"] * coll_env
        out["coll_env_prior"] = coll_env

    out["loss"] = loss
    return out


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _ang_deg(gh, ph):
    return torch.rad2deg(torch.arccos(torch.clamp(torch.sum(gh * ph, -1),
                                                  -1, 1)))


def compute_err(scene, pred, state_norm, batch=WHOLE_BATCH):
    """Interpretable errors (reference ``losses/traffic_model.py:120-164``):
    masked means of pos_err (m), ang_err (deg), and the prior NLL and
    Mahalanobis distance of the posterior mean."""
    gt = state_norm.unnormalize(scene.future_gt)
    fp = state_norm.unnormalize(pred["future_pred"])
    w = scene.future_vis * scene.mask[:, :, None].to(torch.float32)
    pos_err = torch.linalg.vector_norm(gt[..., :2] - fp[..., :2], dim=-1)
    ang_err = _ang_deg(_unit(gt[..., 2:4]), _unit(fp[..., 2:4]))

    post_mean = pred["posterior_out"][0]
    pm, pv = pred["prior_out"]
    z_logprob = log_normal(post_mean, pm, pv)
    z_mdist = torch.linalg.vector_norm((post_mean - pm) / torch.sqrt(pv),
                                       dim=-1)
    wa = scene.mask.to(torch.float32)
    return {
        "pos_err": batch.weighted_mean(pos_err, w),
        "ang_err": batch.weighted_mean(ang_err, w),
        "z_logprob": batch.weighted_mean(z_logprob, wa),
        "z_mdist": batch.weighted_mean(z_mdist, wa),
    }


def compute_disp_err(scene, future_pred, state_norm):
    """Sample displacement errors of the ego, which is always fully observed
    (reference ``losses/traffic_model.py:297-364``).

    :param future_pred: (B, NS, NA, FT, 4) NORMALIZED samples
    :return: dict of (B,) tensors: pos_minADE/minFDE, ang_minADE/minFDE, APD
    """
    FT = min(future_pred.shape[3], scene.future_gt.shape[2])
    gt = state_norm.unnormalize(scene.future_gt[:, 0, :FT])  # (B, FT, 6)
    pred = state_norm.unnormalize(future_pred[:, :, 0, :FT])  # (B, NS, FT, 4)
    NS = pred.shape[1]

    diff = torch.linalg.vector_norm(gt[:, None, :, :2] - pred[..., :2],
                                    dim=-1)  # (B, NS, FT)
    pp = pred[..., :2]
    pw = torch.linalg.vector_norm(pp[:, :, None] - pp[:, None, :], dim=-1)
    apd = torch.sum(pw, dim=(1, 2, 3)) / (NS * (NS - 1) * FT)
    ang = _ang_deg(_unit(gt[..., 2:4])[:, None], _unit(pred[..., 2:4]))
    return {
        "pos_minADE": torch.amin(torch.mean(diff, dim=-1), dim=1),
        "pos_minFDE": torch.amin(diff[..., -1], dim=1),
        "ang_minADE": torch.amin(torch.mean(ang, dim=-1), dim=1),
        "ang_minFDE": torch.amin(ang[..., -1], dim=1),
        "APD": apd,
    }


def compute_coll_rate_env(scene, future_pred, map_store, state_norm,
                          att_norm, ego_only=False):
    """Map-collision rate over samples (reference
    ``losses/traffic_model.py:366-419``).

    :param future_pred: (B, NS, NA, FT, 4) NORMALIZED
    :return: dict with did_collide (B, NS, NA) bool (False for padded;
        (B, NS, 1) with ``ego_only``), num_coll_map, num_traj_map.
    """
    B, NS, NA, FT, _ = future_pred.shape
    pred = state_norm.unnormalize(future_pred).reshape(B * NS * NA * FT, 4)
    lw = att_norm.unnormalize(scene.lw)
    lw_flat = lw[:, None, :, None, :].expand(B, NS, NA, FT, 2).reshape(-1, 2)
    mapix = scene.map_idx[:, None, None, None].expand(B, NS, NA, FT)
    frac = check_on_layer(map_store.drivable(), map_store.dx, pred, lw_flat,
                          mapix.reshape(-1)).reshape(B, NS, NA, FT)
    coll_frame = frac < (1.0 - ENV_COLL_THRESH)
    did = torch.any(coll_frame, dim=-1) & scene.mask[:, None, :]
    if ego_only:
        did = did[:, :, 0:1]
        n_traj = B * NS
    else:
        n_traj = torch.sum(scene.mask) * NS
    return {
        "did_collide": did,
        "num_coll_map": torch.sum(did).to(torch.float32),
        "num_traj_map": n_traj,
    }


def compute_coll_rate_env_from_traj(fut_unnorm, lw_unnorm, map_store,
                                    map_idx):
    """Map collision of each agent of an UNNORMALIZED trajectory batch (the
    reference's ``compute_coll_rate_env_from_traj``, ``eval_adv_gen.py:404``).

    :param fut_unnorm: (NA, T, 4) world-frame trajectories (NaN frames ok)
    :param lw_unnorm: (NA, 2)
    :param map_idx: int map index
    :return: (NA,) numpy bool did_collide
    """
    dev = map_store.dx.device
    fut = torch.as_tensor(np.asarray(fut_unnorm, np.float32)
                          if not isinstance(fut_unnorm, torch.Tensor)
                          else fut_unnorm, device=dev)
    lw = torch.as_tensor(np.asarray(lw_unnorm, np.float32)
                         if not isinstance(lw_unnorm, torch.Tensor)
                         else lw_unnorm, device=dev)
    NA, T = fut.shape[:2]
    valid = ~torch.isnan(fut).any(-1)
    flat = torch.where(valid[..., None], fut, 0.0).reshape(NA * T, 4)
    lw_flat = lw[:, None, :].expand(NA, T, 2).reshape(-1, 2)
    mapix = torch.full((NA * T,), int(map_idx), dtype=torch.int64,
                       device=dev)
    frac = check_on_layer(map_store.drivable(), map_store.dx, flat, lw_flat,
                          mapix).reshape(NA, T)
    coll_frame = (frac < (1.0 - ENV_COLL_THRESH)) & valid
    return torch.any(coll_frame, dim=-1).cpu().numpy()
