"""The port's L-BFGS and AdamW against optax's, in float32.

``strive_tpu_torch.optim.loop.LBFGS`` against ``optax.lbfgs(learning_rate=
lr, memory_size=m)`` (the refine optimizer of ``strive_tpu/optim/loop.py``:
``scale_by_lbfgs``, ``scale_by_learning_rate`` and the zoom linesearch with
its 20-step cap), driven as ``run_lbfgs_loop`` drives it: the value and
gradient at each iterate, then the update. Test functions on R^6 (numpy
seed 0): a well-conditioned and an ill-conditioned quadratic (condition
number 100), Rosenbrock at lr 1 (one trial point an iteration) and lr 10
(the zoom phase: 2-3 trial points an iteration, cubic and quadratic
interpolation), and a near-linear function whose first linesearch doubles
its stepsize until the 20-step cap and takes the safe step. Each with
``memory_size`` 10 and 3 (the memory wraps after 3 iterations).

Over 8 iterations: iterates within 1e-5 relative (rtol 1e-5, atol 1e-6 on
elements near 0), losses rtol 1e-5, and the linesearch's trial-point count
equal at every iteration. Beyond where the iterates converge to float
noise, the linesearch's accept/reject decisions rest on differences of a
few ulps (summation order), so the count stops there.

``AdamW`` against ``optax.adamw(lr, weight_decay=wd)`` and ``Adam`` against
``optax.adam``: 10 steps on random gradients, parameters rtol 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_helpers  # noqa: F401  (sets the torch thread count)
from strive_tpu_torch.optim.loop import LBFGS, Adam, AdamW

D, ITERS = 6, 8
_rng = np.random.default_rng(0)
_A = _rng.normal(size=(D, D))
Q_WELL = (_A @ _A.T / D + np.eye(D)).astype(np.float32)
_U, _ = np.linalg.qr(_rng.normal(size=(D, D)))
Q_ILL = (_U @ np.diag(np.logspace(0, 2, D)) @ _U.T).astype(np.float32)
B = _rng.normal(size=D).astype(np.float32)
X0 = _rng.normal(size=D).astype(np.float32)


def _quad(Q):
    return (lambda x: 0.5 * x @ (jnp.asarray(Q) @ x) - jnp.asarray(B) @ x,
            lambda x: 0.5 * x @ (torch.from_numpy(Q) @ x)
            - torch.from_numpy(B) @ x)


FUNCS = {
    "quadratic": _quad(Q_WELL),
    "ill_conditioned": _quad(Q_ILL),
    "rosenbrock": (
        lambda x: jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2
                          + (1 - x[:-1]) ** 2),
        lambda x: torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2
                            + (1 - x[:-1]) ** 2)),
    "capped_linesearch": (
        lambda x: jnp.sum(jnp.asarray(B) * x) + 1e-9 * jnp.sum(x * x),
        lambda x: torch.sum(torch.from_numpy(B) * x)
        + 1e-9 * torch.sum(x * x)),
}
CASES = [(f, lr) for f in ("quadratic", "ill_conditioned",
                           "capped_linesearch") for lr in (1.0,)] + [
    ("rosenbrock", 1.0), ("rosenbrock", 10.0)]


def run_optax(f, lr, m):
    tx = optax.lbfgs(learning_rate=lr, memory_size=m)
    vg = jax.jit(jax.value_and_grad(f))
    upd = jax.jit(lambda g, st, x, v: tx.update(g, st, x, value=v, grad=g,
                                                value_fn=f))
    x = jnp.asarray(X0)
    st = tx.init(x)
    xs, ls, steps = [], [], []
    for _ in range(ITERS):
        v, g = vg(x)
        u, st = upd(g, st, x, v)
        x = optax.apply_updates(x, u)
        xs.append(np.asarray(x))
        ls.append(float(v))
        steps.append(int(st[2].info.num_linesearch_steps))
    return np.array(xs), np.array(ls), steps


def run_port(f, lr, m):
    def vg(p):
        p = p.detach().requires_grad_(True)
        v = f(p)
        (g,) = torch.autograd.grad(v, p)
        return v.detach(), g

    x = torch.from_numpy(X0.copy())
    opt = LBFGS(x, lr, memory_size=m)
    xs, ls, steps = [], [], []
    for _ in range(ITERS):
        v, g = vg(x)
        x = opt.step(x, v, g, vg)
        xs.append(x.numpy().copy())
        ls.append(float(v))
        steps.append(opt.linesearch.steps)
    return np.array(xs), np.array(ls), steps


@pytest.mark.parametrize("memory_size", [10, 3])
@pytest.mark.parametrize("name,lr", CASES)
def test_lbfgs_matches_optax(name, lr, memory_size):
    fj, ft = FUNCS[name]
    xj, lj, sj = run_optax(fj, lr, memory_size)
    xt, lt, st = run_port(ft, lr, memory_size)
    assert st == sj
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    if name == "capped_linesearch":
        assert st[0] == 20  # the cap, then the safe step
    if name == "rosenbrock" and lr == 10.0:
        assert max(st) > 1  # the zoom phase ran
        assert lt[-1] < lt[0]


def test_lbfgs_rejects_empty_memory():
    with pytest.raises(ValueError):
        LBFGS(torch.zeros(3), 1.0, memory_size=0)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam_and_adamw_match_optax(wd):
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32),
          rng.normal(size=(5,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in p0]
             for _ in range(10)]
    lr = 1e-2
    tx = optax.adamw(lr, weight_decay=wd) if wd else optax.adam(lr)
    pj = [jnp.asarray(p) for p in p0]
    st = tx.init(pj)
    for g in grads:
        u, st = tx.update([jnp.asarray(x) for x in g], st, pj)
        pj = optax.apply_updates(pj, u)
    pt = [torch.from_numpy(p.copy()) for p in p0]
    opt = AdamW(pt, lr, wd) if wd else Adam(pt, lr)
    for g in grads:
        pt = opt.step(pt, [torch.from_numpy(x) for x in g])
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
