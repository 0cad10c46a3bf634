"""Adam, AdamW and L-BFGS with optax 0.2.6's semantics, written out.

Port of the optimizers that ``strive_tpu`` takes from optax: ``optax.adam``
(the latent optimizations of ``optim/loop.py``), ``optax.adamw`` (the
trainer's ``--weight_decay``, ``train.py``) and ``optax.lbfgs`` (the
refine optimizer's L-BFGS, ``optim/loop.py:36-57``).

Adam (``scale_by_adam`` then ``scale_by_learning_rate``)::

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    u  = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    p  = p + (-lr) * u

with the bias corrections computed in float32 as optax does; AdamW adds
``weight_decay * p`` to ``u`` before the learning rate (``add_decayed_weights``).

L-BFGS is ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``, then
``scale_by_learning_rate(lr)``, then ``scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy='one')`` (``optax.lbfgs``'s
defaults in ``alias.py``; ``transform.py`` and ``linesearch.py``). It is not
``torch.optim.LBFGS``, a different algorithm. Every scalar of its state is a
float32 tensor, as in optax: Python floats are float64 and would flip the
linesearch's accept/reject decisions on near-ties. Inner products are
accumulated in float64 and rounded to float32.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch


class Adam:
    """Functional Adam over a list of tensors (no autograd bookkeeping)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def _decay(self, u, p):
        return u

    def step(self, params, grads):
        """:return: the updated parameters (new tensors)."""
        self.count += 1
        one = np.float32(1)
        c1 = float(one - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(one - np.float32(self.b2) ** np.float32(self.count))
        new = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            u = (self.mu[i] / c1) / (torch.sqrt(self.nu[i] / c2) + self.eps)
            new.append(p + (-self.lr) * self._decay(u, p))
        return new

    def state_dict(self):
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.mu = [m.to(old.device) for m, old in zip(state["mu"], self.mu)]
        self.nu = [v.to(old.device) for v, old in zip(state["nu"], self.nu)]


class AdamW(Adam):
    """``optax.adamw(lr, weight_decay=...)``: Adam's update plus
    ``weight_decay * p``, then scaled by ``-lr``."""

    def __init__(self, params, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr, b1, b2, eps)
        self.weight_decay = weight_decay

    def _decay(self, u, p):
        return u + self.weight_decay * p


def _vdot(a, b):
    """float32 inner product, accumulated in float64."""
    return torch.sum(a.double() * b.double()).float()


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class ZoomLinesearch:
    """``optax.scale_by_zoom_linesearch`` (``linesearch.py:576-1282``) with
    the defaults ``optax.lbfgs`` gives it: at most 20 steps, initial guess
    'one', no maximal stepsize.

    Each trial point is one ``value_and_grad(params)`` evaluation (zoom
    needs the slope). ``steps`` is the count of the last search.
    """

    max_steps = 20
    tol = 0.0
    increase_factor = 2.0
    slope_rtol = 1e-4
    curv_rtol = 0.9
    approx_dec_rtol = 1e-6
    interval_threshold = 1e-5  # stepsize_precision

    def __init__(self):
        self.steps = 0

    def _on_line(self, s, stepsize, value_and_grad):
        value, grad = value_and_grad(s.params + stepsize * s.updates)
        return value, grad, _vdot(grad, s.updates)

    def _decrease_error(self, stepsize, value, slope, s):
        err = value - s.value_init - self.slope_rtol * stepsize * s.slope_init
        approx = slope - (2 * self.slope_rtol - 1.0) * s.slope_init
        delta = (value - s.value_init
                 - self.approx_dec_rtol * torch.abs(s.value_init))
        err = torch.minimum(torch.maximum(approx, delta), err)
        err = torch.clamp(err, min=0.0)
        return torch.where(torch.isnan(err), _f32(math.inf, err), err)

    def _curvature_error(self, slope, s):
        err = torch.abs(slope) - self.curv_rtol * torch.abs(s.slope_init)
        err = torch.clamp(err, min=0.0)
        return torch.where(torch.isnan(err), _f32(math.inf, err), err)

    def _search_interval(self, s, value_and_grad):
        """Algorithm 3.5 of Nocedal and Wright (``linesearch.py:815-969``)."""
        first = s.count == 0
        new_step = (s.stepsize_guess if first
                    else self.increase_factor * s.stepsize)
        value, grad, slope = self._on_line(s, new_step, value_and_grad)
        dec = self._decrease_error(new_step, value, slope, s)
        curv = self._curvature_error(slope, s)
        err = torch.maximum(dec, curv)
        safe = dec <= self.tol
        s.safe_stepsize = torch.where(safe, new_step, s.safe_stepsize)
        s.safe_value = torch.where(safe, value, s.safe_value)
        s.safe_grad = torch.where(safe, grad, s.safe_grad)
        set_high = (dec > 0.0) | ((value >= s.value) & (not first))
        set_low = (slope >= 0.0) & ~set_high
        # high <- new by default, low <- new where set_low (high <- prev)
        prev = (s.stepsize, s.value, s.slope)
        new = (new_step, value, slope)
        s.low, s.value_low, s.slope_low = (
            torch.where(set_low, n, p) for n, p in zip(new, prev))
        s.high, s.value_high, s.slope_high = (
            torch.where(set_low, p, n) for n, p in zip(new, prev))
        s.cubic_ref, s.value_cubic_ref = s.low, s.value_low
        found = set_high | set_low | (err <= self.tol)
        done = err <= self.tol
        s.interval_found, s.done = found, done
        s.failed = torch.tensor(s.count + 1 >= self.max_steps,
                                device=done.device) & ~done
        s.stepsize, s.value, s.grad, s.slope = new_step, value, grad, slope
        s.decrease_error, s.curvature_error = dec, curv

    def _zoom(self, s, value_and_grad):
        """Algorithm 3.6 of Nocedal and Wright (``linesearch.py:971-1139``)."""
        low, high = s.low, s.high
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small = delta <= self.interval_threshold
        mid_cubic = _cubicmin(low, s.value_low, s.slope_low, high,
                              s.value_high, s.cubic_ref, s.value_cubic_ref)
        use_cubic = (mid_cubic > left + cubic_chk) & (mid_cubic < right
                                                      - cubic_chk)
        mid_quad = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
        use_quad = ~use_cubic & (mid_quad > left + quad_chk) & (
            mid_quad < right - quad_chk)
        use_bisect = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, mid_cubic, s.cubic_ref)
        middle = torch.where(use_quad, mid_quad, middle)
        middle = torch.where(use_bisect, (low + high) / 2.0, middle)

        value, grad, slope = self._on_line(s, middle, value_and_grad)
        dec = self._decrease_error(middle, value, slope, s)
        curv = self._curvature_error(slope, s)
        err = torch.maximum(dec, curv)
        upd_safe = (dec <= self.tol) & (value < s.safe_value)
        s.safe_stepsize = torch.where(upd_safe, middle, s.safe_stepsize)
        s.safe_value = torch.where(upd_safe, value, s.safe_value)
        s.safe_grad = torch.where(upd_safe, grad, s.safe_grad)
        done = err <= self.tol

        set_high_mid = (dec > 0.0) | (value >= s.value_low)
        set_high_low = (slope * (high - low) >= 0.0) & ~set_high_mid
        set_low_mid = ~set_high_mid
        mid = (middle, value, slope)
        lo = (low, s.value_low, s.slope_low)
        hi = (high, s.value_high, s.slope_high)
        new_hi = tuple(torch.where(set_high_mid, m, h) for m, h in zip(mid, hi))
        new_hi = tuple(torch.where(set_high_low, l, h) for l, h in zip(lo, new_hi))
        new_lo = tuple(torch.where(set_low_mid, m, l) for m, l in zip(mid, lo))
        moved_high = set_high_mid | set_high_low
        s.cubic_ref = torch.where(moved_high, high, low)
        s.value_cubic_ref = torch.where(moved_high, s.value_high, s.value_low)
        s.high, s.value_high, s.slope_high = new_hi
        s.low, s.value_low, s.slope_low = new_lo
        presumably = torch.tensor(s.count + 1 >= self.max_steps,
                                  device=done.device) | (
            too_small & (s.safe_stepsize > 0.0))
        s.done, s.failed = done, presumably & ~done
        s.stepsize, s.value, s.grad, s.slope = middle, value, grad, slope
        s.decrease_error, s.curvature_error = dec, curv

    def search(self, params, updates, value, grad, value_and_grad):
        """:return: the stepsize (a float32 tensor) and the value and
        gradient at ``params + stepsize * updates``."""
        zero = _f32(0.0, value)
        slope = _vdot(updates, grad)
        inf = _f32(math.inf, value)
        s = SimpleNamespace(
            count=0, params=params, updates=updates,
            stepsize_guess=_f32(1.0, value), stepsize=zero, value=value,
            grad=grad, slope=slope, value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf,
            interval_found=torch.tensor(False), done=torch.tensor(False),
            failed=torch.tensor(False),
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad)
        while not bool(s.done | s.failed):
            if bool(s.interval_found):
                self._zoom(s, value_and_grad)
            else:
                self._search_interval(s, value_and_grad)
            s.count += 1
            if bool(s.failed):
                # _try_safe_step: a step with sufficient decrease, if any
                take = (s.safe_stepsize > 0.0) | torch.isinf(s.decrease_error)
                s.stepsize = torch.where(take, s.safe_stepsize, s.stepsize)
                s.value = torch.where(take, s.safe_value, s.value)
                s.grad = torch.where(take, s.safe_grad, s.grad)
        self.steps = s.count
        return s.stepsize, s.value, s.grad


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (``linesearch.py:455-493``); NaN if it has none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * v0 + (-(db ** 2)) * v1) / denom
    B = ((-(dc ** 3)) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (``linesearch.py:496-519``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class LBFGS:
    """``optax.lbfgs(learning_rate=lr, memory_size=...)`` over one tensor.

    :meth:`step` takes the value and gradient at the current iterate and a
    ``value_and_grad(params) -> (value, grad)`` for the linesearch's trial
    points, and returns the next iterate.
    """

    def __init__(self, params, lr, memory_size=10):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.lr = lr
        self.m = memory_size
        self.count = 0
        self.prev_params = torch.zeros_like(params)
        self.prev_grad = torch.zeros_like(params)
        self.dw = torch.zeros((memory_size,) + params.shape,
                              dtype=params.dtype, device=params.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(memory_size, dtype=torch.float32,
                               device=params.device)
        self.linesearch = ZoomLinesearch()

    def _direction(self, params, grad):
        """``scale_by_lbfgs``'s update (``transform.py:1679-1750``)."""
        idx = self.count % self.m
        prev = (self.count - 1) % self.m
        if self.count > 0:
            dp, dg = params - self.prev_params, grad - self.prev_grad
            vd = _vdot(dg, dp)
            w = torch.where(vd == 0.0, _f32(0.0, vd), 1.0 / vd)
            num = vd
            den = torch.sum(dg.double() * dg.double()).float()
            scale = torch.where(den > 0.0, num / den, _f32(1.0, den))
        else:
            dp, dg = torch.zeros_like(params), torch.zeros_like(grad)
            w = _f32(0.0, grad)
            norm = torch.sqrt(torch.sum(grad.double() * grad.double()).float())
            scale = torch.minimum(_f32(1.0, norm), 1.0 / norm)
        self.dw[prev], self.du[prev], self.rho[prev] = dp, dg, w
        order = [(idx + i) % self.m for i in range(self.m)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * _vdot(self.dw[i], vec)
            vec = vec + (-alphas[i]) * self.du[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * _vdot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        return vec

    def step(self, params, value, grad, value_and_grad):
        """:param value, grad: the loss and its gradient at ``params``.
        :return: the next iterate."""
        direction = self._direction(params, grad)
        self.prev_params, self.prev_grad = params, grad
        self.count += 1
        updates = (-self.lr) * direction
        stepsize, _, _ = self.linesearch.search(params, updates, value, grad,
                                                value_and_grad)
        return params + stepsize * updates
