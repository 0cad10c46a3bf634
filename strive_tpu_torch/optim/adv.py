"""Adversarial latent optimization of a scene batch.

Port of ``strive_tpu/optim/adv.py`` (reference ``utils/adv_gen_optim.py``).

- Open loop ('ego'): the recorded planner future is injected into slot 0
  of the rollout (ext_future) and is the attack target.
- Closed loop ('hardcode'): the rule-based planner reacts to the current
  rollout. ``planner_rollout_fn(future_pred_norm) -> (B, FT, 4)``
  (``planners.host_bridge.make_planner_host_fn`` for the numpy planner,
  ``planners.device_planner.DeviceRulePlanner.make_fn`` for the one on the
  card) is called on the detached decode of iterations 0, k, 2k, ...
  (``planner_refresh_every`` = k) and its future is held for the next k
  Adam steps, with one Adam state through the whole loop. The decode at
  the start of each block is that block's first decode, so this is JAX's
  chunked sequence (decode, planner, k steps) with one decode an
  iteration. The model predicts the ego itself (no ext_future), the
  target-matching loss pulls that prediction toward the planner future,
  and the adversarial loss targets the model's own ego prediction
  (reference :134-149).

The tgt-matching loss's cotangent reaches the ego latent (slot 0) only,
the adversarial loss's every latent but slot 0 — the routing of the
reference's two detach-partitioned decodes (``adv_gen_optim.py:119-130``,
``strive_tpu/optim/adv.py:159-194``). Each iteration decodes two copies of
equal value of the batch in one rollout of 2B scenes (copy-major; the map
cropped and encoded once, on copy 0: ``TrafficModel.decoder``'s
``copies``): the tgt-matching loss reads copy 0, the adversarial loss
copy 1. The GNN mixes agents of one scene only, so the copies do not
interact, and one ``torch.autograd.grad`` of the summed loss gives each
copy's latents its own loss's cotangent: the two routed gradients in one
backward pass, through a graph it frees.

The model's parameters are frozen for the run, so the map branch (crop at
a detached pose, CNN) records no autograd graph.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..losses.adv import adv_gen_loss, tgt_matching_loss
from ..losses.common import WHOLE_BATCH
from ..losses.metrics import check_single_veh_coll
from ..utils.spans import span
from .loop import Adam


@contextlib.contextmanager
def frozen_params(model):
    """Temporarily set ``requires_grad=False`` on the model's parameters."""
    live = [p for p in model.parameters() if p.requires_grad]
    for p in live:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in live:
            p.requires_grad_(True)


def _combine_z(tgt_z, other_z):
    """Full (B, NA, D) latents: ego slot 0 from tgt_z, rest from other_z."""
    return torch.cat([tgt_z[:, None], other_z[:, 1:]], dim=1)


class AdvObjective:
    """The adversarial objective of one scene batch.

    :param init_other_z: (B, NA, D) latents the init_z term pulls toward
    :param planner_fut: (B, FT, 4) NORMALIZED planner future, the target of
        the tgt-matching loss. Open loop (``planner_fn`` None): the recorded
        future, also the ext_future of every decode and the attack target.
        Closed loop: the planner's reaction, set on every refresh (None
        before the first).
    :param planner_fn: closed loop: ``fn(future_pred_norm) -> (B, FT, 4)``
    :param future_len: FT of the decodes; the planner future's when None
    :param batch: the losses' reductions over the batch (``losses.common``)
    """

    def __init__(self, model, scene, map_store, embed_info, loss_weights,
                 tgt_prior_distrib, other_prior_distrib, init_other_z,
                 planner_fut, feasibility_time, feasibility_infront_min,
                 attack_agt_mask=None, veh_coll_buffer=0.1, ref_compat=True,
                 planner_fn=None, future_len=None, batch=WHOLE_BATCH):
        self.model, self.scene, self.map_store = model, scene, map_store
        self.embed_info, self.weights = embed_info, loss_weights
        self.tgt_prior, self.other_prior = tgt_prior_distrib, other_prior_distrib
        self.init_other_z, self.planner_fut = init_other_z, planner_fut
        self.FT = future_len or planner_fut.shape[1]
        self.planner_fn = planner_fn
        self.crash_min_t = feasibility_time
        self.crash_min_infront = feasibility_infront_min
        self.attack_agt_mask = attack_agt_mask
        self.veh_coll_buffer, self.ref_compat = veh_coll_buffer, ref_compat
        self.lw_unnorm = model.att_unnorm(scene.lw)
        self.batch = batch
        # the two copies that value_and_grad decodes, built once
        rep = torch.arange(scene.mask.shape[0],
                           device=scene.mask.device).repeat(2)
        with torch.no_grad():
            self.scene2 = scene.take(rep)
            self.map_feat2 = embed_info["map_feat"][rep]
            self.past_feat2 = embed_info["past_feat"][rep]
            self.ext2 = None if planner_fn is not None else planner_fut[rep]

    @property
    def closed_loop(self):
        return self.planner_fn is not None

    def unnorm(self, x):
        return x * self.model.sstd[:4] + self.model.smean[:4]

    def decode(self, z, ext_future):
        return self.model.decode_embedding(
            z, self.embed_info, self.scene, self.map_store, ext_future,
            self.FT)["future_pred"]

    def tgt_loss(self, pred, tgt_z):
        return tgt_matching_loss(
            self.unnorm(pred[:, 0]), self.unnorm(self.planner_fut), tgt_z,
            self.tgt_prior, self.weights, agent_mask=self.scene.mask[:, 0],
            ref_compat=self.ref_compat, batch=self.batch)["loss"]

    def adv_loss_full(self, pred, other_z, tgt_traj=None):
        """:param tgt_traj: (B, FT, 4) attack target; the planner future
        when None"""
        if tgt_traj is None:
            tgt_traj = self.planner_fut
        return adv_gen_loss(
            self.unnorm(pred), self.unnorm(tgt_traj), other_z,
            self.other_prior, lw=self.lw_unnorm, mask=self.scene.mask,
            mapixes=self.scene.map_idx, packed=self.map_store.packed,
            dx=self.map_store.dx, init_z=self.init_other_z,
            weights=self.weights, veh_coll_buffer=self.veh_coll_buffer,
            crash_min_t=self.crash_min_t,
            crash_min_infront=self.crash_min_infront,
            attack_agt_mask=self.attack_agt_mask, batch=self.batch)

    def value_and_grad(self, tgt_z, other_z, refresh=False):
        """One decode of two copies, one autograd pull (module doc).

        :param refresh: closed loop: re-roll the planner on this decode
            (copy 0, detached) before the losses
        :return: (loss, grad wrt tgt_z (B, D), grad wrt other_z (B, NA, D))
        """
        with span("adv.grad"):
            B = tgt_z.shape[0]
            tgt_z = tgt_z.detach().requires_grad_(True)
            other_z = other_z.detach().requires_grad_(True)
            z = _combine_z(tgt_z, other_z).detach().repeat(2, 1, 1)
            z.requires_grad_(True)
            with torch.enable_grad():
                pred = self.model.decoder(self.scene2, self.map_feat2,
                                          self.past_feat2, z, self.map_store,
                                          self.ext2, self.FT, copies=2)
                pred_t, pred_a = pred[:B], pred[B:]
                if refresh:
                    with span("planner.rollout"):
                        self.planner_fut = self.planner_fn(pred_t.detach())
                with span("loss.tgt"):
                    lt = self.tgt_loss(pred_t, tgt_z)
                # the adversarial loss sees the model's own ego prediction
                # in closed loop, the recorded planner in open loop
                # (reference :149)
                with span("loss.adv"):
                    la = self.adv_loss_full(
                        pred_a, other_z, pred_a[:, 0] if self.closed_loop
                        else None)["loss"]
                loss = lt + la
                with span("pull.adv"):
                    gz, g_tgt, g_other = torch.autograd.grad(
                        loss, (z, tgt_z, other_z), allow_unused=True)
            grad_tgt = gz[:B, 0]
            if g_tgt is not None:
                grad_tgt = grad_tgt + g_tgt
            grad_other = torch.cat([torch.zeros_like(gz[B:, :1]),
                                    gz[B:, 1:]], 1)
            if g_other is not None:
                grad_other = grad_other + g_other
            return loss.detach(), grad_tgt, grad_other


def run_adv_gen_optim(model, cur_z, lr, loss_weights, scene, map_store,
                      num_iters, embed_info, planner_name, tgt_prior_distrib,
                      other_prior_distrib, feasibility_time,
                      feasibility_infront_min, planner_rollout_fn=None,
                      attack_agt_mask=None, future_len=None,
                      veh_coll_buffer=0.1, ref_compat=True,
                      planner_refresh_every=1, batch=WHOLE_BATCH):
    """
    :param cur_z: (B, NA, D) initial latents (ego at slot 0)
    :param planner_name: 'ego' (open-loop replay) or 'hardcode' (closed
        loop, module doc)
    :param planner_rollout_fn: for 'hardcode': ``fn(future_pred_norm (B,
        NA, FT, 4)) -> (B, FT, 4)`` NORMALIZED, non-differentiable
    :param planner_refresh_every: closed loop: planner re-roll period in
        Adam iterations (1 = reference-exact)
    :param attack_agt_mask: optional (B, NA) fixed-attacker restriction
    :param batch: the losses' reductions over the batch (``losses.common``;
        a rank's share under ``parallel.mesh.ShardedBatch``)
    :return: (final z (B,NA,D), final_result_traj (B,NA,FT,4) with the TRUE
        planner at slot 0, min_agt (B,), min_t (B,), loss history
        (num_iters,), internal_pred (B,NA,FT,4) — the model's own final
        decode, whose ego slot is the internal planner prediction)
    """
    if planner_name not in ("ego", "hardcode"):
        raise NotImplementedError(f"planner {planner_name!r} is not ported")
    open_loop = planner_name == "ego"
    if not open_loop and planner_rollout_fn is None:
        raise ValueError("the 'hardcode' planner needs planner_rollout_fn")
    FT = future_len if future_len is not None else model.nfuture
    k = max(1, int(planner_refresh_every))
    planner_fut = scene.future_gt[:, 0, :FT, :4] if open_loop else None
    obj = AdvObjective(model, scene, map_store, embed_info, loss_weights,
                       tgt_prior_distrib, other_prior_distrib, cur_z.detach(),
                       planner_fut, feasibility_time, feasibility_infront_min,
                       attack_agt_mask, veh_coll_buffer, ref_compat,
                       None if open_loop else planner_rollout_fn, FT, batch)

    with frozen_params(model):
        tgt_z, other_z = cur_z[:, 0].detach(), cur_z.detach()
        adam = Adam([tgt_z, other_z], lr)
        losses = []
        for it in range(num_iters):
            loss, g_tgt, g_other = obj.value_and_grad(
                tgt_z, other_z, refresh=not open_loop and it % k == 0)
            with span("adv.adam"):
                tgt_z, other_z = adam.step([tgt_z, other_z],
                                           [g_tgt, g_other])
            losses.append(loss)

        with torch.no_grad(), span("adv.final"):
            z_final = _combine_z(tgt_z, other_z)
            final_pred = obj.decode(z_final, None)
            # the final pass targets the TRUE planner (reference :177-209)
            if not open_loop:
                planner_fut = planner_rollout_fn(final_pred)
            final_result = torch.cat([planner_fut[:, None],
                                      final_pred[:, 1:]], 1)
            adv_final = obj.adv_loss_full(final_pred, z_final, planner_fut)
    losses = batch.values(torch.stack(losses)) if losses else torch.zeros(0)
    return (z_final, final_result, adv_final["min_agt"], adv_final["min_t"],
            losses, final_pred)


def compute_adv_gen_success(final_result_traj, state_norm, att_norm, lw, mask,
                            attack_agt):
    """Did the attacker actually collide with the planner? (host numpy)

    :param final_result_traj: (NA, FT, 4) NORMALIZED single scene, slot 0 =
        true planner (tensor on any device, or numpy)
    :param lw: (NA, 2) NORMALIZED; mask: (NA,)
    :param attack_agt: dense agent index of the attacker (>= 1)
    :return: (bool, veh_coll (N,), coll_time (N,))

    Reference ``utils/adv_gen_optim.py:214-235``.
    """
    traj, lw, mask = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a)
                      for a in (final_result_traj, lw, mask))
    n = int(mask.sum())
    fut = state_norm.unnormalize(traj[:n])
    lw_u = att_norm.unnormalize(lw[:n])
    coll, coll_t = check_single_veh_coll(fut[0], lw_u[0], fut[1:], lw_u[1:])
    return bool(coll[int(attack_agt) - 1]), coll, coll_t
