"""The port's open-loop adversarial optimization against strive_tpu's.

- one iteration's loss and gradients against strive_tpu's single-decode
  VJP (``optim/adv.py:159-194``), rebuilt here as in tests/test_optim.py;
- the port's one-decode / two-pull gradients against the literal
  two-decode, detach-partitioned form of the reference
  (``adv_gen_optim.py:119-130``), mirroring
  tests/test_optim.py::test_single_decode_vjp_matches_two_decode;
- three Adam iterations through ``run_adv_gen_optim`` on both sides;
- the port's one pull over two copies of the rollout against its former
  iteration, kept here (one decode, a pull for each loss through it), in
  open loop and in closed loop with the planner re-rolled every
  iteration, for three Adam steps.

Tolerances: loss rtol 1e-4 and gradients rtol 1e-3 / atol 1e-5 for one
iteration (float32 rollouts summed in another order); the two torch forms
share every op, so rtol 1e-4 / atol 1e-6; after three Adam steps the loss
history rtol 1e-3 and the final latents atol 1e-4; the fold against the
two pulls rtol 1e-5, and atol 1e-5 of each tensor's largest magnitude
(measured 1.7e-6): the same ops, but the rollout's GEMMs run at twice the
rows, and the CPU's GEMM can round otherwise at another row count (it
does at 8 rows against 16); the copies agree with each other bit for bit,
with the one-copy decode within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import TEST_CATS, make_scene, tiny_model, tiny_store
from torch_helpers import n, port_model, scene_to_torch, t

from strive_tpu.losses.adv import adv_gen_loss, tgt_matching_loss
from strive_tpu.model.traffic_model import init_model_params
from strive_tpu.optim.adv import run_adv_gen_optim as j_run
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.optim.adv import (AdvObjective, _combine_z,
                                        frozen_params)
from strive_tpu_torch.optim.adv import run_adv_gen_optim as t_run
from strive_tpu_torch.optim.loop import Adam
from strive_tpu_torch.planners import PLANNER_CONFIGS
from strive_tpu_torch.planners.device_planner import DeviceRulePlanner

WEIGHTS = {"adv_crash": 2.0, "motion_prior": 1.0, "motion_prior_atk": 0.005,
           "coll_veh": 20.0, "coll_veh_plan": 20.0, "coll_env": 20.0,
           "init_z": 0.5, "init_z_atk": 0.05, "match_ext": 10.0,
           "motion_prior_ext": 0.0001}
FEAS_T = 2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=6)
    model = tiny_model(FT=6, PT=4)
    js = tiny_store()
    params = init_model_params(model, scene, js, jax.random.PRNGKey(0))
    je = jax.jit(lambda p, s: model.apply(p, s, js, method="embed"))(params,
                                                                     scene)
    tm = port_model(model, params, 3)
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    tsc = scene_to_torch(scene)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    return model, params, scene, js, je, tm, tsc, ts, te


def _objective(tm, tsc, ts, te, planner_fn=None):
    prior = te["prior_out"]
    return AdvObjective(tm, tsc, ts, te, WEIGHTS, (prior[0][:, 0],
                                                   prior[1][:, 0]),
                        prior, prior[0].detach(),
                        None if planner_fn else tsc.future_gt[:, 0, :, :4],
                        FEAS_T, None, planner_fn=planner_fn, future_len=6)


def _two_pulls(obj, tgt_z, other_z, refresh=False):
    """``AdvObjective.value_and_grad`` before the fold: one decode of the B
    scenes, and a ``torch.autograd.grad`` for each loss through it."""
    tgt_z = tgt_z.detach().requires_grad_(True)
    other_z = other_z.detach().requires_grad_(True)
    z = _combine_z(tgt_z, other_z).detach().requires_grad_(True)
    with torch.enable_grad():
        pred = obj.decode(z, None if obj.closed_loop else obj.planner_fut)
        if refresh:
            obj.planner_fut = obj.planner_fn(pred.detach())
        lt = obj.tgt_loss(pred, tgt_z)
        la = obj.adv_loss_full(pred, other_z, pred[:, 0] if obj.closed_loop
                               else None)["loss"]
        gz_t, g_tgt = torch.autograd.grad(lt, (z, tgt_z), retain_graph=True,
                                          allow_unused=True)
        gz_a, g_other = torch.autograd.grad(la, (z, other_z),
                                            allow_unused=True)
    grad_tgt = gz_t[:, 0]
    if g_tgt is not None:
        grad_tgt = grad_tgt + g_tgt
    grad_other = torch.cat([torch.zeros_like(gz_a[:, :1]), gz_a[:, 1:]], 1)
    if g_other is not None:
        grad_other = grad_other + g_other
    return (lt + la).detach(), grad_tgt, grad_other


def _device_planner(js, tsc):
    """The port's rule planner on the card's path (here the CPU), reset on
    the batch: ``fn(future_pred_norm) -> (B, FT, 4)``."""
    state_norm = state_normalizer_for(TEST_CATS)
    init = state_norm.unnormalize(n(tsc.past_gt[:, :, -1]))
    lw = att_normalizer_for(TEST_CATS).unnormalize(n(tsc.lw))
    graphs = {m: tlg.synthetic_lanegraph(extent_m=128.0, spacing_m=32.0)
              for m in js.map_names}
    planner = DeviceRulePlanner(graphs, list(js.map_names),
                                PLANNER_CONFIGS["default"], device="cpu")
    planner.reset(init, lw, n(tsc.mask), n(tsc.map_idx))
    return planner.make_fn(state_norm, 0.5, 6)


def test_one_iteration_matches_jax(setup):
    model, params, scene, js, je, tm, tsc, ts, te = setup
    prior = je["prior_out"]
    z0 = prior[0]
    smean = jnp.asarray(model.norm.state_mean[:4])
    sstd = jnp.asarray(model.norm.state_std[:4])
    unnorm = lambda x: x * sstd + smean
    lw_un = (scene.lw * jnp.asarray(model.norm.att_std)
             + jnp.asarray(model.norm.att_mean))
    fut = scene.future_gt[:, 0, :, :4]

    def vg(tgt_z, other_z):
        z = other_z.at[:, 0].set(tgt_z)
        pred, pullback = jax.vjp(lambda zz: model.apply(
            params, zz, je, scene, js, fut, 6,
            method="decode_embedding")["future_pred"], z)
        lt, (ct, gt) = jax.value_and_grad(
            lambda p, tz: tgt_matching_loss(
                unnorm(p[:, 0]), unnorm(fut), tz,
                (prior[0][:, 0], prior[1][:, 0]), WEIGHTS,
                agent_mask=scene.mask[:, 0])["loss"], argnums=(0, 1))(pred,
                                                                      tgt_z)
        la, (ca, go) = jax.value_and_grad(
            lambda p, oz: adv_gen_loss(
                unnorm(p), unnorm(fut), oz, prior, lw=lw_un, mask=scene.mask,
                mapixes=scene.map_idx, drivable=js.drivable(), dx=js.dx,
                init_z=z0, weights=WEIGHTS, veh_coll_buffer=0.1,
                crash_min_t=FEAS_T)["loss"], argnums=(0, 1))(pred, other_z)
        return (lt + la, pullback(ct)[0][:, 0] + gt,
                pullback(ca)[0].at[:, 0].set(0.0) + go)

    jl, jgt, jgo = jax.jit(vg)(z0[:, 0], z0)
    with frozen_params(tm):
        tl, tgt, tgo = _objective(tm, tsc, ts, te).value_and_grad(
            t(z0[:, 0]), t(z0))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(n(tgt), n(jgt), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(n(tgo), n(jgo), rtol=1e-3, atol=1e-5)


def test_one_decode_matches_two_decode_form(setup):
    *_, tm, tsc, ts, te = setup
    obj = _objective(tm, tsc, ts, te)
    z0 = te["prior_out"][0].detach()
    with frozen_params(tm):
        loss1, g_tgt1, g_other1 = obj.value_and_grad(z0[:, 0], z0)
        tgt_z = z0[:, 0].clone().requires_grad_(True)
        other_z = z0.clone().requires_grad_(True)
        z_for_tgt = torch.cat([tgt_z[:, None], other_z.detach()[:, 1:]], 1)
        z_for_other = torch.cat([tgt_z.detach()[:, None], other_z[:, 1:]], 1)
        fut = obj.planner_fut
        loss2 = (obj.tgt_loss(obj.decode(z_for_tgt, fut), tgt_z)
                 + obj.adv_loss_full(obj.decode(z_for_other, fut),
                                     other_z)["loss"])
        g_tgt2, g_other2 = torch.autograd.grad(loss2, (tgt_z, other_z))
    np.testing.assert_allclose(loss1.item(), loss2.item(), rtol=1e-5)
    np.testing.assert_allclose(n(g_tgt1), n(g_tgt2), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(n(g_other1), n(g_other2), rtol=1e-4,
                               atol=1e-6)


def test_three_iterations_match_jax(setup):
    model, params, scene, js, je, tm, tsc, ts, te = setup
    jp, tp = je["prior_out"], te["prior_out"]
    jout = j_run(model, params, jp[0], 0.05, WEIGHTS, scene, js, 3, je, "ego",
                 (jp[0][:, 0], jp[1][:, 0]), jp, FEAS_T, None)
    tout = t_run(tm, tp[0], 0.05, WEIGHTS, tsc, ts, 3, te, "ego",
                 (tp[0][:, 0], tp[1][:, 0]), tp, FEAS_T, None)
    z, result, min_agt, min_t, losses, pred = tout
    assert all(p.requires_grad for p in tm.parameters())  # restored
    np.testing.assert_allclose(n(losses), n(jout[4]), rtol=1e-3)
    np.testing.assert_allclose(n(z), n(jout[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(min_agt), n(jout[2]))
    np.testing.assert_array_equal(n(min_t), n(jout[3]))
    np.testing.assert_allclose(n(result), n(jout[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(pred), n(jout[5]), rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError):
        t_run(tm, tp[0], 0.05, WEIGHTS, tsc, ts, 1, te, "no_such_planner",
              (tp[0][:, 0], tp[1][:, 0]), tp, FEAS_T, None)


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_one_pull_over_two_copies_matches_two_pulls(setup, loop):
    """The fold's loss and gradients equal the two pulls', iteration by
    iteration, along the fold's own Adam steps (closed loop: the planner
    re-rolled on every decode, ``planner_refresh_every`` 1)."""
    model, params, scene, js, je, tm, tsc, ts, te = setup
    fn = _device_planner(js, tsc) if loop == "closed" else None
    folded, ref = (_objective(tm, tsc, ts, te, fn) for _ in range(2))
    z0 = te["prior_out"][0].detach()
    tgt_z, other_z = z0[:, 0], z0
    adam = Adam([tgt_z, other_z], 0.05)
    with frozen_params(tm):
        for _ in range(3):
            refresh = fn is not None
            got = folded.value_and_grad(tgt_z, other_z, refresh=refresh)
            want = _two_pulls(ref, tgt_z, other_z, refresh=refresh)
            if refresh:
                torch.testing.assert_close(folded.planner_fut,
                                           ref.planner_fut, rtol=1e-5,
                                           atol=1e-7)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5,
                                           atol=1e-5 * float(w.abs().max()))
            assert got[2][:, 0].abs().max() == 0  # the ego is tgt_z's
            tgt_z, other_z = adam.step([tgt_z, other_z], list(got[1:]))
