"""Faults planted in the program, to show that the check sees them.

Each is a context manager that breaks the timed path underneath the
harness and puts it back on exit:

- ``unchanged``: the optimizer's step returns its state unchanged;
- ``half_batch``: the losses' batch means are taken over the first half
  of the scenes alone;
- ``altered``: an answer altered where it is produced: the rollout the
  adversarial losses read is moved 1 cm, or each training step's loss is
  1% off.

The benchmark's runs never enter them: ``benchmark/tests`` and
``benchmark.calibrate --fault`` do.
"""

from __future__ import annotations

import contextlib
import functools

import torch


class HalfBatch:
    """The batch's reductions over its first half of scenes alone."""

    def __init__(self):
        from strive_tpu_torch.losses.common import BatchReduce

        self.whole = BatchReduce()

    @staticmethod
    def _half(x):
        return x[: max(1, x.shape[0] // 2)] if x.dim() else x

    def total(self, x):
        return self.whole.total(self._half(x))

    def mean(self, x):
        return self.whole.mean(self._half(x))

    def weighted_mean(self, x, w):
        return self.whole.weighted_mean(self._half(x), self._half(w))

    def masked_mean(self, x, mask, fallback=0.0):
        return self.whole.masked_mean(self._half(x), self._half(mask),
                                      fallback)

    def values(self, x):
        return x


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _stuck_adam():
    from strive_tpu_torch.optim.loop import Adam

    class Stuck(Adam):
        def step(self, params, grads):
            self.count += 1
            return list(params)

    return Stuck


def fault(name, driver):
    """The fault ``name`` for cells of ``driver`` ('optim' or 'train')."""
    from strive_tpu_torch import train
    from strive_tpu_torch.model.traffic_model import TrafficModel
    from strive_tpu_torch.optim import adv

    if name == "unchanged":
        return _patched(adv if driver == "optim" else train, "Adam",
                        _stuck_adam())
    if name == "half_batch" and driver == "optim":
        return _patched(adv, "run_adv_gen_optim", functools.partial(
            adv.run_adv_gen_optim, batch=HalfBatch()))
    if name == "half_batch":
        orig = train.traffic_model_loss

        def half(scene, pred, weights, state_norm, att_norm, map_store=None,
                 batch=None):
            return orig(scene, pred, weights, state_norm, att_norm,
                        map_store, HalfBatch())

        return _patched(train, "traffic_model_loss", half)
    if name == "altered" and driver == "optim":
        orig = TrafficModel.decoder

        def moved(self, *a, **k):
            out = orig(self, *a, **k)
            return out + torch.tensor([0.01 / float(self.sstd[0]), 0.0, 0.0,
                                       0.0], device=out.device)

        return _patched(TrafficModel, "decoder", moved)
    if name == "altered":
        orig = train.traffic_model_loss

        def off(*a, **k):
            out = orig(*a, **k)
            out["loss"] = out["loss"] * 1.01
            return out

        return _patched(train, "traffic_model_loss", off)
    raise ValueError(f"no fault {name!r}")


FAULTS = ("unchanged", "half_batch", "altered")
