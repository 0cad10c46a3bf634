"""Plain PyTorch of STRIVE's losses: the adversarial objective of the
scenario generation and the training loss of the prior.

From the reference's ``losses/adv_gen_nusc.py`` (TgtMatchingLoss,
AdvGenLoss with its vehicle, environment, motion-prior and init-z terms)
and ``losses/traffic_model.py`` (TrafficModelLoss), on dense padded
scenes. Trajectories are unnormalized (x, y, hx, hy) here.
"""

from __future__ import annotations

import torch

from .model import linspace, log_normal, kl_normal, pixels, rotate_grid


def interp3(traj):
    """x3 linear upsampling along time (``F.interpolate`` linear,
    ``align_corners=False``), headings renormalized."""
    T = traj.shape[-2]
    c = (torch.arange(3 * T, dtype=torch.float32, device=traj.device)
         + 0.5) / 3 - 0.5
    c = torch.clamp(c, 0.0, T - 1)
    lo = torch.floor(c).long()
    hi = torch.clamp(lo + 1, max=T - 1)
    w = (c - lo)[..., None]
    out = traj[..., lo, :] * (1.0 - w) + traj[..., hi, :] * w
    h = out[..., 2:4]
    return torch.cat([out[..., :2],
                      h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)],
                     -1)


def veh_coll(traj, lw, mask, buffer=0.0, n_circ=5):
    """Pairwise 5-disc collision penalties: (B, T, N, N) 1 - d / (r_i + r_j
    + buffer) where the discs overlap, and that mask."""
    B, N, T, _ = traj.shape
    r = lw[..., 1] / 2.0
    cmin = -(lw[..., 0] / 2.0) + r
    cmax = lw[..., 0] / 2.0 - r
    st = linspace(0.0, 1.0, n_circ, traj.device)
    off = (cmin[..., None] + (cmax - cmin)[..., None] * st)[:, :, None]
    cx = traj[..., 0:1] + off * traj[..., 2:3]
    cy = traj[..., 1:2] + off * traj[..., 3:4]
    cent = torch.stack([cx, cy], -1).movedim(2, 1)  # (B, T, N, C, 2)
    d = cent[:, :, :, None, :, None] - cent[:, :, None, :, None, :]
    md = torch.sqrt(torch.amin(torch.sum(d * d, -1).reshape(B, T, N, N, -1),
                               -1) + 1e-12)
    pd = (r[:, :, None] + r[:, None, :] + buffer)[:, None]
    eye = torch.eye(N, dtype=torch.bool, device=traj.device)
    valid = (mask[:, :, None] & mask[:, None, :] & ~eye)[:, None]
    hit = (md <= pd) & valid
    return torch.where(hit, 1.0 - md / pd, 0.0), hit


def coll_point(raster, dx, cars, lw, mapix, grid=(39, 16)):
    """Mean world position of the non-drivable samples of each footprint
    (a 39 x 16 grid over length x width), and whether the car is partly
    off the drivable layer (raster channel 0)."""
    lin_l = linspace(-1.0, 1.0, grid[0], cars.device)
    lin_w = linspace(-1.0, 1.0, grid[1], cars.device)
    lwise = lin_l[None, :, None] * (lw[:, 0] / 2.0)[:, None, None]
    wwise = lin_w[None, None, :] * (lw[:, 1] / 2.0)[:, None, None]
    xys = rotate_grid(lwise, wwise, cars[:, :2], cars[:, 2:4])
    m, py, px = pixels(raster, dx, xys, mapix)
    off = (raster[:, 0][m, py, px] == 0).float()[..., None]
    n = torch.sum(off, (1, 2))
    pt = torch.sum(xys * off, (1, 2)) / torch.clamp(n, min=1.0)
    total = float(grid[0] * grid[1])
    return pt, (n[:, 0] > 0) & (n[:, 0] < total)


def env_coll(traj, lw, mask, mapix, raster, dx):
    """(B, N, T) penalties 1 - |center - off-road point| / half diagonal
    where partly off road (the point from the detached pose), and that
    mask."""
    B, N, T, _ = traj.shape
    flat = traj.reshape(B * N * T, 4)
    pt, ok = coll_point(raster, dx, flat.detach(),
                        lw[:, :, None].expand(B, N, T, 2).reshape(-1, 2),
                        mapix[:, None, None].expand(B, N, T).reshape(-1))
    half = torch.sqrt(lw[..., 0] ** 2 / 4.0 + lw[..., 1] ** 2 / 4.0)
    half = half[:, :, None].expand(B, N, T).reshape(-1)
    d = flat[:, :2] - pt
    dist = torch.sqrt(torch.sum(d * d, -1) + 1e-12)
    pen = torch.where(ok, 1.0 - dist / half, 0.0).reshape(B, N, T)
    valid = ok.reshape(B, N, T) & mask[:, :, None]
    return torch.where(valid, pen, 0.0), valid


def masked_mean(x, m):
    c = torch.sum(m)
    return torch.where(c > 0, torch.sum(torch.where(m, x, 0.0))
                       / torch.clamp(c, min=1), 0.0)


def wmean(x, w):
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def tgt_loss(pred_ego, tgt, w):
    """Target matching of the ego's decode to the planner's future; the
    reference weights the *matching* term by ``motion_prior_ext``
    (``adv_gen_nusc.py:46``), which is kept."""
    match = torch.mean(torch.sum((pred_ego - tgt) ** 2, -1))
    return w["match_ext"] * match + w["motion_prior_ext"] * match


def adv_loss(pred, tgt, z, prior, lw, mask, mapix, raster, dx, init_z, w,
             crash_t, buffer=0.1):
    """The adversarial objective; :return: (loss, min_agt, min_t)."""
    B, N, T, _ = pred.shape
    idx = torch.arange(N, device=pred.device)
    nonego = mask & (idx[None] > 0)
    Tp = T - crash_t
    valid = nonego[:, :, None].expand(B, N, Tp)
    diff = pred[:, :, crash_t:, :2] - tgt[:, None, crash_t:, :2]
    diff = torch.where(valid[..., None], diff, 1.0)
    dist = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    logits = -torch.where(valid, dist, torch.inf).reshape(B, N * Tp)
    fin = torch.isfinite(logits)
    lmax = torch.amax(torch.where(fin, logits, -torch.inf), 1, keepdim=True)
    lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
    ex = torch.where(fin, torch.exp(logits - lmax), 0.0)
    den = torch.sum(ex, 1, keepdim=True)
    soft = torch.where(den > 0, ex / torch.clamp(den, min=1e-30), 0.0)
    arg = torch.argmax(soft, 1)
    d2 = dist.reshape(B, N * Tp) ** 2
    crash = torch.sum(soft * torch.where(torch.isfinite(d2), d2, 0.0)
                      * valid.reshape(B, N * Tp), 1)
    loss = w["adv_crash"] * torch.mean(crash)

    rew = 1.0 - torch.sum(soft.detach().reshape(B, N, Tp), 2)
    nll = -log_normal(z, prior[0], prior[1])
    coeff = rew * w["motion_prior"] + (1.0 - rew) * w["motion_prior_atk"]
    loss = loss + wmean(nll * coeff, nonego.float())

    fi = interp3(pred)
    pens, hit = veh_coll(fi, lw, mask, buffer)
    both = (idx[None, :, None] > 0) & (idx[None, None, :] > 0)
    loss = loss + w["coll_veh"] * masked_mean(pens, hit & both[:, None])
    wv = torch.where(idx[None] == 0, 1.0, rew)
    wm = torch.where(idx[None, :, None] == 0, wv[:, None, :],
                     torch.where(idx[None, None, :] == 0, wv[:, :, None], 1.0))
    ego = (idx[None, :, None] == 0) | (idx[None, None, :] == 0)
    loss = loss + w["coll_veh_plan"] * masked_mean(pens * wm[:, None],
                                                   hit & ego[:, None])
    ep, ev = env_coll(fi, lw, nonego, mapix, raster, dx)
    loss = loss + w["coll_env"] * masked_mean(ep, ev)

    sq = torch.sum((init_z - z) ** 2, -1)
    coeff = rew * w["init_z"] + (1.0 - rew) * w["init_z_atk"]
    loss = loss + torch.sum(sq * coeff * nonego.float())
    return loss, arg // Tp, arg % Tp + crash_t


def train_loss(model, sc, pred, prior, post, samp, w):
    """The prior's training loss: reconstruction NLL on seen frames, KL of
    posterior to prior, and on the prior sample the vehicle collision
    penalty (over all ordered pairs) and the ego's environment penalty."""
    fr = sc["future_vis"] * sc["mask"][:, :, None].float()
    gt = sc["future_gt"][..., :4]
    recon = wmean(-log_normal(pred, gt, torch.ones_like(pred)), fr)
    kl = wmean(kl_normal(post[0], post[1], prior[0], prior[1]),
               sc["mask"].float())
    loss = w["recon"] * recon + w["kl"] * kl
    s = model.unnorm(samp)
    lw = model.att_unnorm(sc["lw"])
    pens, _ = veh_coll(s, lw, sc["mask"])
    na = torch.sum(sc["mask"], 1).float()
    loss = loss + w["coll_veh_prior"] * (
        torch.sum(pens) / torch.clamp(torch.sum(na * na - na), min=1.0))
    ep, _ = env_coll(s[:, 0:1], lw[:, 0:1], sc["mask"][:, 0:1],
                     sc["map_idx"], model.raster, model.dx)
    return loss + w["coll_env_prior"] * torch.mean(ep)
