"""Training loop: the train and eval steps of the traffic model.

Port of ``strive_tpu/train.py`` (reference ``train_traffic.py:64-171``):
a step is the forward pass (posterior decode, and with either collision
prior a prior-sample decode), ``traffic_model_loss`` and, when training,
one ``torch.autograd.grad`` and an Adam (or AdamW) update of the model's
parameters in place. The KL weight is an argument of the step, so
annealing changes nothing else. The noise of each step (posterior ``eps``
and prior ``eps_samp``) is drawn on the CPU from the trainer's generator
and moved, so the card and the CPU see the same numbers; tests pass
strive_tpu's noise through :meth:`Trainer.draw_noise`.

Inside a process group (``parallel.mesh.launch``) the steps are
data-parallel, as strive_tpu's are over its ``scenes`` mesh: each rank
steps on its contiguous rows of the batch (a batch that does not split
evenly raises, as strive_tpu's ``device_put`` does) with its rows of the
batch's noise, the losses divide by totals over every rank
(``ShardedBatch``), and the gradients and metrics are summed over the
ranks. The losses are means over the whole batch, so a mean of the ranks'
own means would be another loss wherever their rows hold different numbers
of agents or frames; this way a step is the one-process step on the same
batch, and every rank takes the same Adam step.

``run_epoch`` skips a batch whose step raises a ``RuntimeError``, as the
reference does (``train_traffic.py:120-131``), with two exceptions: an
error on the first batch means the step itself is broken and is
re-raised, and an error of a kernel of this package, of its build or of
CUDA itself (``utils/launch.is_device_fault``) is always re-raised, so a
failed launch can never be skipped quietly.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .losses.common import WHOLE_BATCH
from .losses.training import compute_err, traffic_model_loss
from .optim.loop import Adam, AdamW
from .parallel.mesh import ShardedBatch, shard_rows, sum_tensors
from .utils.launch import is_device_fault
from .utils.logger import Logger
from .utils.spans import span


def compute_kl_weight(cur_epoch, end_epoch, final_kl_weight):
    """Linear KL annealing from 0 (reference ``utils/torch.py:65-67``)."""
    return min(1.0, float(cur_epoch) / end_epoch) * final_kl_weight


class Trainer:
    """The model's optimizer state, its steps and the epoch loop; the step
    noise comes from a CPU generator seeded 0."""

    def __init__(self, model, loss_weights, state_norm, att_norm, lr=1e-5,
                 weight_decay=0.0):
        self.model = model
        self.loss_weights = dict(loss_weights)
        self.state_norm, self.att_norm = state_norm, att_norm
        self.params = [p for p in model.parameters()]
        if weight_decay > 0.0:
            self.opt = AdamW(self.params, lr, weight_decay)
        else:
            self.opt = Adam(self.params, lr)
        self.generator = torch.Generator().manual_seed(0)
        self.do_sample = (loss_weights.get("coll_veh_prior", 0.0) > 0.0
                          or loss_weights.get("coll_env_prior", 0.0) > 0.0)
        self.step_count = 0

    def draw_noise(self, scene):
        """Standard-normal (eps, eps_samp or None), (B, NA, latent) each,
        drawn on the CPU."""
        shape = (scene.B, scene.NA, self.model.latent_size)
        eps = torch.randn(shape, generator=self.generator)
        eps_samp = (torch.randn(shape, generator=self.generator)
                    if self.do_sample else None)
        return eps, eps_samp

    def _loss(self, scene, map_store, kl_weight, eps, eps_samp):
        """:return: (loss, metrics, batch): this rank's share of each inside
        a process group (module doc)"""
        batch = WHOLE_BATCH
        if dist.is_initialized():
            rows = shard_rows(scene.B)
            scene, eps = scene.take(rows), eps[rows]
            eps_samp = None if eps_samp is None else eps_samp[rows]
            batch = ShardedBatch()
        dev = scene.past.device
        with span("train.forward"):
            pred = self.model(
                scene, map_store, eps=eps.to(dev),
                future_sample=self.do_sample,
                eps_samp=None if eps_samp is None else eps_samp.to(dev))
        with span("train.loss"):
            w = dict(self.loss_weights, kl=kl_weight)
            out = traffic_model_loss(scene, pred, w, self.state_norm,
                                     self.att_norm, map_store, batch)
            with torch.no_grad():
                err = compute_err(scene, pred, self.state_norm, batch)
        return out["loss"], {**out, **err}, batch

    @staticmethod
    def _whole(metrics, batch):
        """The batch's metrics (detached 0-dim tensors) from this rank's
        shares."""
        keys = sorted(metrics)
        vals = batch.values(torch.stack([metrics[k].detach() for k in keys]))
        return dict(zip(keys, vals.unbind()))

    def gradients(self, scene, map_store, kl_weight, eps, eps_samp=None):
        """:return: (the batch loss's gradient for each parameter, summed
        over the ranks inside a process group; the step's metrics,
        detached 0-dim tensors)"""
        with torch.enable_grad():
            loss, metrics, batch = self._loss(scene, map_store, kl_weight,
                                              eps, eps_samp)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, self.params)
        return sum_tensors(grads), self._whole(metrics, batch)

    def train_step(self, scene, map_store, kl_weight, eps, eps_samp=None):
        """One update of the parameters; :return: the step's metrics
        (detached 0-dim tensors)."""
        grads, metrics = self.gradients(scene, map_store, kl_weight, eps,
                                        eps_samp)
        with span("train.adam"):
            new = self.opt.step([p.detach() for p in self.params], grads)
            with torch.no_grad():
                for p, q in zip(self.params, new):
                    p.copy_(q)
        self.step_count += 1
        return metrics

    def eval_step(self, scene, map_store, kl_weight, eps, eps_samp=None):
        with torch.no_grad():
            _, metrics, batch = self._loss(scene, map_store, kl_weight, eps,
                                           eps_samp)
        return self._whole(metrics, batch)

    def run_epoch(self, batches, map_store, kl_weight, train=True,
                  log_every=0, wandb_run=None, step_counter=0,
                  step_seconds=None):
        """Run one epoch; :return: (dict of mean metrics, step_counter).

        :param step_seconds: optional list, appended each step's wall
            seconds (ended by a device synchronize)
        """
        step_fn = self.train_step if train else self.eval_step
        agg = {}
        n = 0
        t0 = time.time()
        for i, scene in enumerate(batches):
            with span("train.step"):
                t_step = time.perf_counter()
                try:
                    with span("train.noise"):
                        eps, eps_samp = self.draw_noise(scene)
                    metrics = step_fn(scene, map_store, kl_weight, eps,
                                      eps_samp)
                    with span("train.read"):
                        loss_val = float(metrics["loss"])
                except RuntimeError as e:
                    if n == 0 or is_device_fault(e):
                        raise
                    Logger.log(f"  caught error in batch {i}: {e}; skipping")
                    continue
                if step_seconds is not None:
                    if scene.past.is_cuda:
                        torch.cuda.synchronize(scene.past.device)
                    step_seconds.append(time.perf_counter() - t_step)
                n += 1
                step_counter += int(scene.B)
                for k, v in metrics.items():
                    if v.dim() == 0:
                        agg.setdefault(k, 0.0)
                if log_every and (i + 1) % log_every == 0:
                    Logger.log(f"  batch {i + 1}: loss={loss_val:.4f}")
                with span("train.read"):
                    for k in agg:
                        agg[k] += float(metrics[k])
                if wandb_run is not None and train:
                    wandb_run.log({f"Train Batch Mean {k}": float(metrics[k])
                                   for k in agg}, step=step_counter)
        out = {k: v / max(n, 1) for k, v in agg.items()}
        out["epoch_time"] = time.time() - t0
        return out, step_counter
