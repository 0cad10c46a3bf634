"""Plain PyTorch of the two jobs the benchmark times: the adversarial
latent optimization of a scene batch, and steps of the prior's training.

- Adam as optax 0.2.6 computes it: moments, bias corrections in float32,
  ``p - lr * m_hat / (sqrt(v_hat) + eps)``.
- Adversarial optimization, open loop (the recorded ego future is the
  planner, injected into every decode and the attack target): from the
  prior mean, each iteration decodes once; the target-matching loss
  moves only the ego's latent, the adversarial loss only the others'
  (the reference's two detach-partitioned decodes,
  ``utils/adv_gen_optim.py:119-130``). A final decode without the
  injected future gives the result, the recorded future in slot 0.
- Training: the posterior decode and the prior-sample decode, the loss,
  the gradient of every parameter, and Adam.
"""

from __future__ import annotations

import numpy as np
import torch

from .losses import adv_loss, tgt_loss, train_loss
from .model import Model


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, params, grads):
        self.t += 1
        one = np.float32(1)
        c1 = float(one - np.float32(self.b1) ** np.float32(self.t))
        c2 = float(one - np.float32(self.b2) ** np.float32(self.t))
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            u = (self.mu[i] / c1) / (torch.sqrt(self.nu[i] / c2) + self.eps)
            out.append(p + (-self.lr) * u)
        return out


class AdvObjective:
    """The adversarial objective of one batch at given latents: one decode
    with the recorded ego future injected, the two losses, and each
    latent's gradient by its own loss."""

    def __init__(self, model: Model, sc, opt, emb):
        self.model, self.sc, self.emb = model, sc, emb
        self.w, self.ct = opt["weights"], opt["feasibility_time"]
        self.plan = sc["future_gt"][:, 0, :, :4]
        self.lw = model.att_unnorm(sc["lw"])
        self.z0 = emb["prior"][0]

    def adv(self, pred, z):
        m = self.model
        return adv_loss(m.unnorm(pred), m.unnorm(self.plan), z,
                        self.emb["prior"], self.lw, self.sc["mask"],
                        self.sc["map_idx"], m.raster, m.dx, self.z0, self.w,
                        self.ct)

    def value_and_grad(self, tz, oz, crop_at=None):
        """:param crop_at: the FT crop poses to use (``Model.decode``)
        :return: (loss, gradient of the ego's latent (B, D), of the
        others' (B, N, D)); the rollout's own crop poses are in
        ``self.model.poses``"""
        m = self.model
        tz_ = tz.detach().requires_grad_(True)
        oz_ = oz.detach().requires_grad_(True)
        z = torch.cat([tz_[:, None], oz_[:, 1:]], 1).detach()
        z.requires_grad_(True)
        with torch.enable_grad():
            pred = m.decode(self.sc, self.emb, z, self.plan, crop_at)
            lt = tgt_loss(m.unnorm(pred[:, 0]), m.unnorm(self.plan), self.w)
            la = self.adv(pred, oz_)[0]
            gzt, = torch.autograd.grad(lt, (z,), retain_graph=True)
            gza, goz = torch.autograd.grad(la, (z, oz_))
        go = torch.cat([torch.zeros_like(gza[:, :1]), gza[:, 1:]], 1) + goz
        return float((lt + la).detach()), gzt[:, 0], go

    def final(self, tz, oz, crop_at=None):
        """The result of the final latents: a decode without the injected
        future, the recorded future in slot 0."""
        with torch.no_grad():
            zf = torch.cat([tz[:, None], oz[:, 1:]], 1)
            fp = self.model.decode(self.sc, self.emb, zf, None, crop_at)
            return zf, torch.cat([self.plan[:, None], fp[:, 1:]], 1)


def adv_optimize(model: Model, sc, opt, emb=None):
    """The whole optimization from the prior mean.

    :param opt: the configuration's ``optim`` dict
    :param emb: the embedding to start from ({'map', 'past', 'prior'});
        the model's own of ``sc`` when None
    :return: dict of the result (B, N, FT, 4) normalized, each
        iteration's loss, each iteration's latents and
        gradients ('steps': [(tz, oz, g_tz, g_oz)]), the latents after the
        last step, the embedding, and the crop poses of each decode
        ('crops': [FT (B * N, 4)], the iterations' then the final one's)"""
    if emb is None:
        with torch.no_grad():
            emb = model.embed(sc)
    obj = AdvObjective(model, sc, opt, emb)
    tz, oz = obj.z0[:, 0].clone(), obj.z0.clone()
    adam = Adam([tz, oz], opt["lr"])
    losses, steps, crops = [], [], []
    for _ in range(opt["num_iters"]):
        loss, gt, go = obj.value_and_grad(tz, oz)
        crops.append(model.poses)
        steps.append((tz, oz, gt, go))
        tz, oz = adam.step([tz, oz], [gt, go])
        losses.append(loss)
    _, res = obj.final(tz, oz)
    crops.append(model.poses)
    return {"result": res, "losses": losses, "steps": steps,
            "last": (tz, oz), "emb": emb, "crops": crops}


def adv_follow(model: Model, sc, opt, emb, steps, last, crops):
    """The reference along another optimization's path: at each
    iteration's latents ``steps[k][:2]``, cropping where that run cropped
    (``crops``, as :func:`adv_optimize` returns them), its own loss,
    gradients and Adam step (its moments fed by its own gradients), and
    the result of the final latents ``last``.

    :return: dict of losses, gradients [(g_tz, g_oz)], the latents each
        step reaches [(tz, oz)], the root of Adam's second moment after
        each step ('scale'), the result, and the rollouts' own crop poses
        ('crops', as ``crops``)"""
    obj = AdvObjective(model, sc, opt, emb)
    adam = Adam([steps[0][0], steps[0][1]], opt["lr"])
    losses, grads, reach, own, scale = [], [], [], [], []
    for (tz, oz, _, _), at in zip(steps, crops):
        loss, gt, go = obj.value_and_grad(tz, oz, at)
        own.append(model.poses)
        losses.append(loss)
        grads.append((gt, go))
        reach.append(tuple(adam.step([tz, oz], [gt, go])))
        scale.append(tuple(torch.sqrt(v) for v in adam.nu))
    _, res = obj.final(*last, crop_at=crops[-1])
    own.append(model.poses)
    return {"losses": losses, "grads": grads, "reach": reach,
            "scale": scale, "result": res, "crops": own}


def train_steps(model: Model, batches, noise, opt, follow=None):
    """Training steps on ``batches`` from the model's parameters, or along
    another run's path.

    :param noise: per step (eps, eps_samp), (B, N, D) each
    :param follow: optional per step (the parameters before it, by name;
        the 2 x FT (B * N, 4) poses its two rollouts cropped at): each
        step then starts from those parameters and crops at those poses,
        with this run's own Adam moments
    :return: dict of per step lists: the loss, the gradients and the
        parameters before and after the step ({name: tensor}), and the
        rollouts' own crop poses"""
    names = list(model.p)
    params = [model.p[n] for n in names]
    adam = Adam(params, opt["lr"])
    w = dict(opt["weights"])
    FT = model.m["future_len"]
    out = {"losses": [], "grads": [], "before": [], "after": [], "crops": []}
    for k, (sc, (eps, eps_samp)) in enumerate(zip(batches, noise)):
        at = (None, None)
        if follow is not None:
            params = [follow[k][0][n] for n in names]
            at = (follow[k][1][:FT], follow[k][1][FT:])
        leaves = [p.detach().requires_grad_(True) for p in params]
        model.p = dict(zip(names, leaves))
        with torch.enable_grad():
            emb = model.embed(sc)
            prior, post = emb["prior"], emb["post"]
            zq = post[0] + eps * torch.sqrt(post[1])
            zp = prior[0] + eps_samp * torch.sqrt(prior[1])
            pred = model.decode(sc, emb, zq, None, at[0])
            poses = model.poses
            samp = model.decode(sc, emb, zp, None, at[1])
            out["crops"].append(poses + model.poses)
            loss = train_loss(model, sc, pred, prior, post, samp, w)
            grads = torch.autograd.grad(loss, leaves)
        before = [p.detach() for p in leaves]
        params = adam.step(before, grads)
        out["losses"].append(float(loss.detach()))
        out["grads"].append(dict(zip(names, grads)))
        out["before"].append(dict(zip(names, before)))
        out["after"].append(dict(zip(names, params)))
    model.p = dict(zip(names, params))
    return out
