"""Plain PyTorch of the closed-loop adversarial optimization against a
rule-based planner: the reference of the closed-loop cell's decoder
numbers.

As ``optim.py``'s open loop, except where the planner reacts (the
reference's ``utils/adv_gen_optim.py:134-149``): no future is injected
into the decode; the target-matching loss pulls the ego's own decode
toward the planner's future of the iteration; the adversarial loss
attacks the ego's own decode. The planner's futures are given, one an
iteration and one for the final decode (the program's, each computed from
the program's own decode): the reference follows the optimization along
those targets as it follows the program's crops.
"""

from __future__ import annotations

import torch

from .losses import adv_loss, tgt_loss
from .model import Model
from .optim import Adam, AdvObjective


class ClosedObjective(AdvObjective):
    """The objective of one batch at given latents and a given planner
    future (B, FT, 4), normalized."""

    def adv(self, pred, z):
        m = self.model
        return adv_loss(m.unnorm(pred), m.unnorm(pred[:, 0]), z,
                        self.emb["prior"], self.lw, self.sc["mask"],
                        self.sc["map_idx"], m.raster, m.dx, self.z0, self.w,
                        self.ct)

    def value_and_grad(self, tz, oz, target, crop_at=None):
        """:return: (loss, gradient of the ego's latent (B, D), of the
        others' (B, N, D)); the rollout's crop poses in
        ``self.model.poses``"""
        m = self.model
        tz_ = tz.detach().requires_grad_(True)
        oz_ = oz.detach().requires_grad_(True)
        z = torch.cat([tz_[:, None], oz_[:, 1:]], 1).detach()
        z.requires_grad_(True)
        with torch.enable_grad():
            pred = m.decode(self.sc, self.emb, z, None, crop_at)
            lt = tgt_loss(m.unnorm(pred[:, 0]), m.unnorm(target), self.w)
            la = self.adv(pred, oz_)[0]
            gzt, = torch.autograd.grad(lt, (z,), retain_graph=True)
            gza, goz = torch.autograd.grad(la, (z, oz_))
        go = torch.cat([torch.zeros_like(gza[:, :1]), gza[:, 1:]], 1) + goz
        return float((lt + la).detach()), gzt[:, 0], go

    def final(self, tz, oz, target, crop_at=None):
        """The result of the final latents: a decode, the planner's final
        future ``target`` in slot 0."""
        with torch.no_grad():
            zf = torch.cat([tz[:, None], oz[:, 1:]], 1)
            fp = self.model.decode(self.sc, self.emb, zf, None, crop_at)
            return zf, torch.cat([target[:, None], fp[:, 1:]], 1)


def closed_optimize(model: Model, sc, opt, targets, emb=None):
    """The optimization from the prior mean along the planner futures
    ``targets`` (one an iteration, then the final one), as
    ``optim.adv_optimize`` returns it."""
    if emb is None:
        with torch.no_grad():
            emb = model.embed(sc)
    obj = ClosedObjective(model, sc, opt, emb)
    tz, oz = obj.z0[:, 0].clone(), obj.z0.clone()
    adam = Adam([tz, oz], opt["lr"])
    losses, steps, crops = [], [], []
    for k in range(opt["num_iters"]):
        loss, gt, go = obj.value_and_grad(tz, oz, targets[k])
        crops.append(model.poses)
        steps.append((tz, oz, gt, go))
        tz, oz = adam.step([tz, oz], [gt, go])
        losses.append(loss)
    _, res = obj.final(tz, oz, targets[-1])
    crops.append(model.poses)
    return {"result": res, "losses": losses, "steps": steps,
            "last": (tz, oz), "emb": emb, "crops": crops}


def closed_follow(model: Model, sc, opt, emb, steps, last, crops, targets):
    """``optim.adv_follow`` in the closed loop: the reference along
    another optimization's latents, crops and planner futures."""
    obj = ClosedObjective(model, sc, opt, emb)
    adam = Adam([steps[0][0], steps[0][1]], opt["lr"])
    losses, grads, reach, own, scale = [], [], [], [], []
    for (tz, oz, _, _), at, tg in zip(steps, crops, targets):
        loss, gt, go = obj.value_and_grad(tz, oz, tg, at)
        own.append(model.poses)
        losses.append(loss)
        grads.append((gt, go))
        reach.append(tuple(adam.step([tz, oz], [gt, go])))
        scale.append(tuple(torch.sqrt(v) for v in adam.nu))
    _, res = obj.final(*last, targets[-1], crop_at=crops[-1])
    own.append(model.poses)
    return {"losses": losses, "grads": grads, "reach": reach,
            "scale": scale, "result": res, "crops": own}
