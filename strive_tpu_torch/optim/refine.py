"""Refinement optimization: remove collisions from sampled futures while
staying likely under the prior.

Port of ``strive_tpu/optim/refine.py`` (reference
``refine_traffic_optim.py:146-226``): Adam or L-BFGS on z with the
collision-avoidance loss (buffer 0.2, rollout at ``samp_future_len``), then
one decode at ``save_future_len``. Each Adam iteration, and each L-BFGS
iterate and linesearch trial point, is one decode and one
``torch.autograd.grad``; the model's parameters are frozen for the run.
"""

from __future__ import annotations

import torch

from ..losses.adv import avoid_coll_loss
from .adv import frozen_params
from .loop import LBFGS, Adam


VEH_COLL_BUFFER = 0.2  # meters (reference refine_traffic_optim.py:187)


def run_refine_optim(model, cur_z, lr, loss_weights, scene, map_store,
                     num_iters, embed_info, prior_distrib,
                     samp_future_len=16, save_future_len=12,
                     optimizer="adam"):
    """
    :param cur_z: (B, NA, D) latents of the sampled future
    :param optimizer: 'adam' (the reference's default) or 'lbfgs'
    :return: (final z, refined future (B, NA, save_future_len, 4)
              NORMALIZED, loss history (num_iters,): the loss at each
              iterate before its update)
    """
    if optimizer not in ("adam", "lbfgs"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    smean, sstd = model.smean[:4], model.sstd[:4]
    lw_unnorm = model.att_unnorm(scene.lw)
    init_z = cur_z.detach()

    def value_and_grad(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            dec = model.decode_embedding(z, embed_info, scene, map_store,
                                         None, samp_future_len)
            fut = dec["future_pred"] * sstd + smean
            loss = avoid_coll_loss(
                fut, z, prior_distrib, lw=lw_unnorm, mask=scene.mask,
                mapixes=scene.map_idx, packed=map_store.packed,
                dx=map_store.dx, init_z=init_z, weights=loss_weights,
                veh_coll_buffer=VEH_COLL_BUFFER, z_mask=scene.mask)["loss"]
            (grad,) = torch.autograd.grad(loss, z)
        return loss.detach(), grad

    with frozen_params(model):
        z = init_z
        opt = Adam([z], lr) if optimizer == "adam" else LBFGS(z, lr)
        losses = []
        for _ in range(num_iters):
            loss, grad = value_and_grad(z)
            if optimizer == "adam":
                (z,) = opt.step([z], [grad])
            else:
                z = opt.step(z, loss, grad, value_and_grad)
            losses.append(loss)
        with torch.no_grad():
            fut = model.decode_embedding(z, embed_info, scene, map_store,
                                         None, save_future_len)["future_pred"]
    losses = torch.stack(losses) if losses else torch.zeros(0)
    return z, fut, losses
