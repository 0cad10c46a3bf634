"""Initialization optimization: fit latents to a target future.

Port of ``strive_tpu/optim/init_optim.py`` (reference
``utils/init_optim.py:11-68``): Adam on z minimizing the target-matching
loss between the decoded (unnormalized) future and a target trajectory on
visible frames. One decode and one ``torch.autograd.grad`` an iteration;
the model's parameters are frozen for the run.
"""

from __future__ import annotations

import torch

from ..losses.adv import tgt_matching_loss
from ..losses.common import WHOLE_BATCH
from .adv import frozen_params
from .loop import Adam


def run_init_optim(model, cur_z, init_traj, traj_vis, lr, loss_weights,
                   scene, map_store, num_iters, embed_info, prior_distrib,
                   ext_future=None, ref_compat=True, batch=WHOLE_BATCH):
    """
    :param cur_z: (B, NA, D) starting latents
    :param init_traj: (B, NA, FT, 6) NORMALIZED target future (GT or planner)
    :param traj_vis: (B, NA, FT) visibility of the target
    :param loss_weights: dict with match_ext / motion_prior_ext
    :param prior_distrib: (mean, var) each (B, NA, D)
    :param batch: the loss's reductions over the batch (``losses.common``;
        a rank's share under ``parallel.mesh.ShardedBatch``)
    :return: (final z, final decoded future (B, NA, FT, 4) NORMALIZED,
              loss history (num_iters,))
    """
    smean, sstd = model.smean[:4], model.sstd[:4]
    tgt_unnorm = init_traj[..., :4] * sstd + smean
    w = traj_vis * scene.mask[:, :, None].to(torch.float32)

    def decode(z):
        return model.decode_embedding(z, embed_info, scene, map_store,
                                      ext_future)["future_pred"]

    with frozen_params(model):
        z = cur_z.detach()
        adam = Adam([z], lr)
        losses = []
        for _ in range(num_iters):
            z = z.detach().requires_grad_(True)
            with torch.enable_grad():
                fp = decode(z) * sstd + smean
                loss = tgt_matching_loss(
                    fp, tgt_unnorm, z, prior_distrib, loss_weights,
                    frame_weights=w, agent_mask=scene.mask,
                    ref_compat=ref_compat, batch=batch)["loss"]
                (grad,) = torch.autograd.grad(loss, z)
            (z,) = adam.step([z.detach()], [grad])
            losses.append(loss.detach())
        with torch.no_grad():
            future_pred = decode(z)
    losses = batch.values(torch.stack(losses)) if losses else torch.zeros(0)
    return z, future_pred, losses
