"""Differentiable collision penalties on dense padded scenes.

Port of ``strive_tpu/losses/penalties.py`` (reference
``losses/adv_gen_nusc.py`` VehCollLoss, EnvCollLoss, MotionPriorLoss).
All trajectories are UNNORMALIZED (x, y, hx, hy).
"""

from __future__ import annotations

import torch

from ..maps.queries import get_coll_point, linspace
from .common import WHOLE_BATCH, log_normal


def vehicle_circles(traj, lw, num_circ=5):
    """Disc-approximation centers along each vehicle.

    :param traj: (..., 4) poses
    :param lw: (..., 2) lengths/widths (broadcastable against traj[..., 0])
    :return: centers (..., num_circ, 2), radius (...,)
    """
    rad = lw[..., 1] / 2.0
    cmin = -(lw[..., 0] / 2.0) + rad
    cmax = (lw[..., 0] / 2.0) - rad
    steps = linspace(0.0, 1.0, num_circ, traj.device)
    cent_x = cmin[..., None] + (cmax - cmin)[..., None] * steps
    cx = traj[..., 0:1] + cent_x * traj[..., 2:3]
    cy = traj[..., 1:2] + cent_x * traj[..., 3:4]
    return torch.stack([cx, cy], dim=-1), rad


def pair_valid_mask(mask, single_veh_idx=None):
    """(B, NA, NA) ordered-pair validity: both real, i != j, optionally
    restricted to pairs involving agent ``single_veh_idx``."""
    NA = mask.shape[1]
    eye = torch.eye(NA, dtype=torch.bool, device=mask.device)
    m = mask[:, :, None] & mask[:, None, :] & ~eye[None]
    if single_veh_idx is not None:
        sel = torch.zeros(NA, dtype=torch.bool, device=mask.device)
        sel[single_veh_idx] = True
        m = m & (sel[None, :, None] | sel[None, None, :])
    return m


def veh_coll_penalties(traj, lw, mask, num_circ=5, buffer_dist=0.0,
                       single_veh_idx=None):
    """Pairwise circle-approximation collision penalties.

    :param traj: (B, NA, T, 4); :param lw: (B, NA, 2); :param mask: (B, NA)
    :return: penalties (B, T, NA, NA) = 1 - min_dist/penalty_dist (0 where
        not colliding), coll_mask (B, T, NA, NA)
    """
    B, NA, T, _ = traj.shape
    cent, _ = vehicle_circles(traj, lw[:, :, None, :], num_circ)
    rad = lw[..., 1] / 2.0
    cent = cent.movedim(2, 1)  # (B, T, NA, C, 2)
    diff = cent[:, :, :, None, :, None, :] - cent[:, :, None, :, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)  # (B, T, NA, NA, C, C)
    min_d = torch.sqrt(torch.amin(d2.reshape(B, T, NA, NA, -1), dim=-1)
                       + 1e-12)
    pen_dist = (rad[:, :, None] + rad[:, None, :] + buffer_dist)[:, None]
    valid = pair_valid_mask(mask, single_veh_idx)[:, None]
    colliding = (min_d <= pen_dist) & valid
    pen = torch.where(colliding, 1.0 - min_d / pen_dist, 0.0)
    return pen, colliding


def masked_mean(x, mask, fallback=0.0):
    """Mean of x over True entries of mask; ``fallback`` when empty."""
    return WHOLE_BATCH.masked_mean(x, mask, fallback)


def env_coll_penalties(traj, lw, mask, mapixes, packed, dx):
    """Non-drivable-overlap penalties.

    :param traj: (B, NA, T, 4); :param lw: (B, NA, 2); :param mapixes: (B,)
    :param packed: (M, H, W) bit-packed raster, bit 0 the drivable layer
    :return: penalties (B, NA, T), valid (B, NA, T) True where the agent is
        real and *partially* off-road.

    The collision point comes from the detached trajectory; gradient flows
    only through the trajectory center (reference ``adv_gen_nusc.py:366-403``).
    """
    B, NA, T, _ = traj.shape
    flat = traj.reshape(B * NA * T, 4)
    flat_lw = lw[:, :, None, :].expand(B, NA, T, 2).reshape(-1, 2)
    flat_map = mapixes[:, None, None].expand(B, NA, T).reshape(-1)
    coll_pt, cp_valid, _ = get_coll_point(packed, dx, flat.detach(), flat_lw,
                                          flat_map)
    pen_dist = torch.sqrt(lw[..., 0] ** 2 / 4.0 + lw[..., 1] ** 2 / 4.0)
    pen_dist = pen_dist[:, :, None].expand(B, NA, T).reshape(-1)
    # eps-safe norm: the collision point can coincide with the center, and
    # norm(0) has a NaN gradient that would survive the where-mask below
    d = flat[:, :2] - coll_pt
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    pen = torch.where(cp_valid, 1.0 - dist / pen_dist, 0.0).reshape(B, NA, T)
    valid = cp_valid.reshape(B, NA, T) & mask[:, :, None]
    return torch.where(valid, pen, 0.0), valid


def motion_prior_nll(z, prior_out):
    """-log N(z | prior) per agent (reference ``adv_gen_nusc.py:343-364``)."""
    mean, var = prior_out
    return -log_normal(z, mean, var)
