"""The options of strive_tpu's TrafficModel on the port, against strive_tpu
on the CPU: a bf16 ``compute_dtype`` (blocks, the crop, the whole model, a
train step and three adversarial iterations), ``output_bicycle=False``,
``traj_encoder='gru'`` and ``map_refresh_every``; and the entry points
with ``--bf16`` and ``--no_output_bicycle``.

The tiny model of tests/test_torch_model.py (numpy seed 5, B=2 x NA=4,
PT=4, FT=6, 64 px crops), one strive_tpu model per option with weights
``init_model_params(PRNGKey(5))`` carried over by ``params_from_flax``,
noise passed in.

Tolerances, each with the largest difference measured:
- bf16 blocks: ``MLP`` and ``SceneInteractionNet`` equal bit for bit,
  ``MapEncoder`` within 1e-6 of the output's largest magnitude (2.3e-7):
  both frameworks round the same ops to bf16 at the same places;
  ``get_map_crop(dtype=bf16)`` exact (0/1 values);
- the bf16 model against strive_tpu's: 3e-3 of each output's largest
  magnitude (measured 1.4e-3 on the map feature, 9.6e-4 on the prior,
  9.3e-4 on the rollouts). A conv output that rounds to the other bf16
  neighbour (2^-8 apart) moves what follows by that much;
- the port's bf16 against its own float32: 0.2 normalized units, the bound
  of tests/test_train.py::test_bf16_compute_mode;
- ``output_bicycle=False``, ``traj_encoder='gru'``, ``map_refresh_every``:
  tests/test_torch_model.py's float32 tolerances (atol 1e-4; rtol 1e-4
  on forward's sampled rollouts, where the direct output, whose steps
  rotate each other's errors, gets atol 1e-3: measured 3.3e-4, 'gru'
  1.9e-6), over the rollout steps before the first map crop that differs
  between the two: a pose 1e-6 apart gathers another pixel where it lies
  that close to a rounding tie, and with random weights the direct
  output (poses jump 1-5 normalized units a step) turns that pixel into
  1e-2 at the next step. Every scene is compared at three steps at least
  (measured: every rollout whole, 1.8e-5 at most);
- the bf16 train step: the metrics rtol 1e-2 (measured 4e-3, ang_err);
  each gradient leaf, relative to its norm, within 2.5x (measured 1.7x)
  of how far strive_tpu's own bf16 gradient lies from its float32 one
  (up to 25%: bf16 rounding carried back through six rollout steps);
- three bf16 adversarial iterations: the loss history rtol 1e-2
  (measured 5.4e-3), the final rollouts as the bf16 model's, the latents
  that Adam stepped a full lr the same way each time atol 2e-2 (measured
  1.0e-2) and the others within the 6 lr that three steps of opposite
  sign can part them (measured 0.133): bf16 rounding is 2^16 times
  float32's, so per-iteration quantities are held, not long fits.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from helpers import TEST_CATS, make_scene, tiny_model, tiny_store
from torch_helpers import n, port_model, scene_to_torch, t

from strive_tpu.maps import get_map_crop as j_crop
from strive_tpu.model import cnn as jcnn, common as jcommon
from strive_tpu.model import interaction as jint
from strive_tpu.model.traffic_model import TrafficModel, init_model_params
from strive_tpu.normalize import att_normalizer_for as j_att_norm
from strive_tpu.normalize import state_normalizer_for as j_state_norm
from strive_tpu.optim.adv import run_adv_gen_optim as j_run
from strive_tpu.train import TrainState, make_train_step
from strive_tpu_torch.maps import queries as tq
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.model import cnn as tcnn, common as tcommon
from strive_tpu_torch.model import interaction as tint
from strive_tpu_torch.model import traffic_model as ttm
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.optim.adv import run_adv_gen_optim as t_run
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.scripts import train_traffic as ttrain_script
from strive_tpu_torch.train import Trainer
from strive_tpu_torch.utils.convert import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = jnp.bfloat16
FT = 6
MODEL = dict(rtol=0, atol=1e-4)
BF16_MODEL = 3e-3  # of each output's largest magnitude
TRAIN_WEIGHTS = {"recon": 1.0, "kl": 0.004, "coll_veh_prior": 0.05,
                 "coll_env_prior": 0.1}
ADV_WEIGHTS = {"adv_crash": 2.0, "motion_prior": 1.0,
               "motion_prior_atk": 0.005, "coll_veh": 20.0,
               "coll_veh_plan": 20.0, "coll_env": 20.0, "init_z": 0.5,
               "init_z_atk": 0.05, "match_ext": 10.0,
               "motion_prior_ext": 0.0001}


def _load(module, params):
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return module


def _close_rel(got, want, tol, what=""):
    """|got - want| <= tol x max|want| (NaN where both are NaN)."""
    got = n(got.float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    scale = float(np.nanmax(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ---- the blocks in bf16 --------------------------------------------------------

def test_mlp_bf16_matches(rng):
    x = rng.normal(size=(3, 5, 11)).astype(np.float32)
    jm = jcommon.MLP((16, 16, 7), dtype=BF)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _load(tcommon.MLP(11, (16, 16, 7), dtype=torch.bfloat16), p)
    got = tm(t(x))
    assert got.dtype == torch.bfloat16
    assert all(q.dtype == torch.float32 for q in tm.parameters())
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(jm.apply(p, jnp.asarray(x)),
                                             np.float32))


def test_map_encoder_bf16_matches(rng):
    """The same 0/1 crop, in bf16 as K1 writes it; the output is float32."""
    crop = (rng.uniform(size=(4, 32, 32, 3)) > 0.5).astype(np.float32)
    je = jcnn.MapEncoder(16, (5, 3, 3), (2, 2, 2), (8, 8, 16), dtype=BF)
    jx = jnp.asarray(crop, BF)
    p = je.init(jax.random.PRNGKey(2), jx, input_layout="nhwc")
    te = _load(tcnn.MapEncoder(3, 32, 16, (5, 3, 3), (2, 2, 2), (8, 8, 16),
                               dtype=torch.bfloat16), p)
    got = te(t(crop).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    _close_rel(got, je.apply(p, jx, input_layout="nhwc"), 1e-6)


def test_scene_interaction_net_bf16_matches(rng):
    B, NA, D, NC = 2, 5, 12, 2
    x = rng.normal(size=(B, NA, D)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, (B, NA))
    pos = np.concatenate([rng.normal(size=(B, NA, 2)) * 10,
                          np.stack([np.cos(th), np.sin(th)], -1)],
                         -1).astype(np.float32)
    sem = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, (B, NA))]
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)  # lone agent
    jn = jint.SceneInteractionNet(16, 6, dtype=BF)
    args = tuple(map(jnp.asarray, (x, pos, sem, mask)))
    p = jn.init(jax.random.PRNGKey(3), *args)
    tn = _load(tint.SceneInteractionNet(D, NC, 16, 6, dtype=torch.bfloat16),
               p)
    msgs = []
    tn.conv0.edge_mlp.register_forward_hook(
        lambda mod, inp, out: msgs.append(out.dtype))
    got = tn(t(x), t(pos), t(sem), t(mask))
    assert got.dtype == torch.float32 and msgs == [torch.bfloat16]
    np.testing.assert_array_equal(n(got), np.asarray(jn.apply(p, *args)))


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_get_map_crop_bf16_is_exact(rng, layout):
    js = tiny_store()
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    th = rng.uniform(-np.pi, np.pi, 16)
    pos = np.concatenate([rng.uniform(20.0, 100.0, (16, 2)),
                          np.stack([np.cos(th), np.sin(th)], 1)],
                         1).astype(np.float32)
    mapix = rng.integers(0, 2, 16)
    bounds = (-4.0, -8.0, 12.0, 8.0)
    want = j_crop(js.raster, js.dx, jnp.asarray(pos), jnp.asarray(mapix),
                  bounds, L=64, W=64, dtype=BF, packed=js.packed,
                  layout=layout)
    got = tq.get_map_crop(ts.packed, ts.dx, t(pos), t(mapix), bounds, 3,
                          L=64, W=64, layout=layout, dtype=torch.bfloat16)
    f32 = tq.get_map_crop(ts.packed, ts.dx, t(pos), t(mapix), bounds, 3,
                          L=64, W=64, layout=layout)
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    assert torch.equal(got, f32.to(torch.bfloat16))
    np.testing.assert_array_equal(n(got.float()), np.asarray(want,
                                                             np.float32))


# ---- the whole model, option by option ------------------------------------------

class _DirectOutputModel(TrafficModel):
    """strive_tpu's TrafficModel with ``output_bicycle=False`` able to run.

    Its decoder scans with the scene's 6-dim last state as the carry, and
    the direct-output step returns the 4-dim pose, so ``lax.scan`` refuses
    the carry (a fault of strive_tpu: ROADMAP §3). That path reads only
    ``prev_state[..., :4]``, so starting the carry at the pose is the same
    rollout; nothing else changes."""

    def decoder(self, scene, *args, **kw):
        return super().decoder(
            dataclasses.replace(scene, past=scene.past[..., :4]), *args,
            **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=FT)
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    return scene, tiny_store(), scene_to_torch(scene), ts


def _option_models(data, **opt):
    scene, js = data[:2]
    model = tiny_model(FT=FT, PT=4)
    if opt.get("output_bicycle") is False:
        model = _DirectOutputModel(**{
            f.name: getattr(model, f.name) for f in dataclasses.fields(model)
            if f.name not in ("parent", "name")})
    model = dataclasses.replace(model, **opt)
    params = init_model_params(model, scene, js, jax.random.PRNGKey(5))
    return model, params, port_model(model, params, 3)


@pytest.fixture(scope="module")
def bf16(data):
    return _option_models(data, compute_dtype="bfloat16")


@pytest.fixture(scope="module", params=["direct", "gru"])
def option(request, data):
    opt = {"direct": dict(output_bicycle=False),
           "gru": dict(traj_encoder="gru")}[request.param]
    return (request.param, *_option_models(data, **opt))


def _embeds(model, params, tm, data):
    scene, js, tsc, ts = data
    je = jax.jit(lambda p: model.apply(p, scene, js, method="embed"))(params)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    return je, te


def _jax_decode(model, params, z, je, scene, js, ext):
    return jax.jit(lambda p, z_, e_, x_: model.apply(
        p, z_, e_, scene, js, x_, method="decode_embedding"))(
            params, z, je, ext)["future_pred"]


def _crop_flips(model, data, jpred, tpred, ext=None):
    """Per scene, the first rollout step whose map crops (at the step's
    poses, the injected ego pose where ``ext`` is given) differ between
    the two rollouts; FT where none does."""
    scene, js, tsc, ts = data
    sstd = np.asarray(model.norm.state_std[:4], np.float32)
    smean = np.asarray(model.norm.state_mean[:4], np.float32)
    B, NA = scene.B, scene.NA
    mapix = np.repeat(np.asarray(scene.map_idx), NA)
    first = np.full(B, FT)
    for step in range(FT):
        poses = []
        for pred in (np.array(n(jpred)), np.array(n(tpred))):
            p = pred[:, :, step]
            if ext is not None:
                p[:, 0] = np.asarray(ext)[:, step]
            poses.append((p * sstd + smean).reshape(B * NA, 4))
        want = j_crop(js.raster, js.dx, jnp.asarray(poses[0]),
                      jnp.asarray(mapix), model.map_bounds, L=64, W=64,
                      packed=js.packed, layout="nhwc")
        got = tq.get_map_crop(ts.packed, ts.dx, t(poses[1]), t(mapix),
                              model.map_bounds, 3, L=64, W=64, layout="nhwc")
        differ = (n(got) != np.asarray(want)).reshape(B, -1).any(1)
        first = np.where(differ & (first == FT), step, first)
    return first


def _rollouts_close(model, data, tpred, jpred, ext=None, **tol):
    """Each scene's steps up to the first that crops another map (which
    then feeds the next step) agree within ``tol``; at least 3 steps."""
    flips = _crop_flips(model, data, jpred, tpred, ext)
    assert (flips >= 2).all(), flips
    for b, s in enumerate(flips):
        np.testing.assert_allclose(n(tpred)[b, :, :s + 1],
                                   np.asarray(jpred)[b, :, :s + 1], **tol)
    return flips


def test_bf16_model_matches_jax_and_stays_near_f32(bf16, data):
    model, params, tm = bf16
    scene, js, tsc, ts = data
    assert tm.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    je, te = _embeds(model, params, tm, data)
    for k in ("map_feat", "past_feat"):
        assert te[k].dtype == torch.float32
        _close_rel(te[k], je[k], BF16_MODEL, k)
    for k in ("prior_out", "posterior_out"):
        for i in range(2):
            _close_rel(te[k][i], je[k][i], BF16_MODEL, k)
    z, ext = je["prior_out"][0], scene.future_gt[:, 0, :, :4]
    jd = _jax_decode(model, params, z, je, scene, js, ext)
    with torch.no_grad():
        td = tm.decode_embedding(t(z), te, tsc, ts, t(ext))["future_pred"]
    _close_rel(td, jd, BF16_MODEL, "decode_embedding")

    key = jax.random.PRNGKey(7)
    jo = jax.jit(lambda p, k: model.apply(p, scene, js, k,
                                          future_sample=True,
                                          method="forward"))(params, key)
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, jo["posterior_out"][0].shape)
    eps_s = jax.random.normal(k2, jo["prior_out"][0].shape)
    with torch.no_grad():
        to = tm(tsc, ts, eps=t(eps), future_sample=True, eps_samp=t(eps_s))
    for k in ("future_pred", "future_samp"):
        _close_rel(to[k], jo[k], BF16_MODEL, k)

    # the port's bf16 against its float32 on the same weights
    f32 = port_model(dataclasses.replace(model, compute_dtype=None), params,
                     3)
    with torch.no_grad():
        a = f32(tsc, ts, use_post_mean=True)["future_pred"]
        b = tm(tsc, ts, use_post_mean=True)["future_pred"]
    assert torch.isfinite(b).all()
    assert (a - b).abs().max() < 0.2


def test_option_rollouts_match(option, data):
    """forward, reconstruct and decode_embedding with and without an
    external ego future, for ``output_bicycle=False`` and the 'gru'
    encoders."""
    name, model, params, tm = option
    scene, js, tsc, ts = data
    if name == "gru":
        assert {"past_gru", "past_out", "future_gru", "future_out"} <= set(
            params["params"])
        assert tm.past_gru.layer0.ih.in_features == 9 + scene.NC
    else:
        assert tm.decoder_net.mlp_out.fc2.out_features == 4
    je, te = _embeds(model, params, tm, data)
    for k in ("map_feat", "past_feat"):
        np.testing.assert_allclose(n(te[k]), n(je[k]), **MODEL, err_msg=k)
    for k in ("prior_out", "posterior_out"):
        for i in range(2):
            np.testing.assert_allclose(n(te[k][i]), n(je[k][i]), **MODEL)
    z = je["prior_out"][0]
    for ext in (None, scene.future_gt[:, 0, :, :4]):
        jd = _jax_decode(model, params, z, je, scene, js, ext)
        with torch.no_grad():
            td = tm.decode_embedding(t(z), te, tsc, ts,
                                     None if ext is None else t(ext))
        _rollouts_close(model, data, td["future_pred"], jd, ext, **MODEL)

    jr = jax.jit(lambda p: model.apply(p, scene, js,
                                       method="reconstruct"))(params)
    with torch.no_grad():
        tr = tm.reconstruct(tsc, ts)
    _rollouts_close(model, data, tr["future_pred"], jr["future_pred"],
                    **MODEL)

    key = jax.random.PRNGKey(7)
    jo = jax.jit(lambda p, k: model.apply(p, scene, js, k,
                                          future_sample=True,
                                          method="forward"))(params, key)
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, jo["posterior_out"][0].shape)
    eps_s = jax.random.normal(k2, jo["prior_out"][0].shape)
    with torch.no_grad():
        to = tm(tsc, ts, eps=t(eps), future_sample=True, eps_samp=t(eps_s))
    # z = mu + eps sqrt(var) carries the posterior's 1e-5 into the
    # rollouts; the direct output's steps rotate each other's errors
    atol = 1e-3 if name == "direct" else 1e-4
    for k in ("future_pred", "future_samp"):
        _rollouts_close(model, data, to[k], jo[k], rtol=1e-4, atol=atol)


@pytest.mark.parametrize("k", [2, 3])
def test_map_refresh_matches(data, k):
    scene, js, tsc, ts = data
    model, params, tm = _option_models(data, map_refresh_every=k)
    je, te = _embeds(model, params, tm, data)
    z = je["prior_out"][0]
    for ext in (None, scene.future_gt[:, 0, :, :4]):
        jd = _jax_decode(model, params, z, je, scene, js, ext)
        with torch.no_grad():
            td = tm.decode_embedding(t(z), te, tsc, ts,
                                     None if ext is None else t(ext))
        _rollouts_close(model, data, td["future_pred"], jd, ext, **MODEL)


def _crop_calls(monkeypatch):
    """Count the model's map crops (the dispatch to K1 on the card)."""
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return tq.get_map_crop(*a, **kw)

    monkeypatch.setattr(ttm, "get_map_crop", spy)
    return calls


def test_map_refresh_counts_and_fallback(data, monkeypatch):
    """A decode crops FT / k times; k = 5 does not divide FT = 6 (nor k = 2
    an nfuture of 5) and falls back to k = 1; step 0 is k = 1's."""
    scene, js, tsc, ts = data
    model = tiny_model(FT=FT, PT=4)
    params = init_model_params(model, scene, js, jax.random.PRNGKey(5))
    models = {k: port_model(dataclasses.replace(model, map_refresh_every=k),
                            params, 3) for k in (1, 2, 3, 5)}
    with torch.no_grad():
        te = models[1].embed(tsc, ts)
        calls = _crop_calls(monkeypatch)
        z = te["prior_out"][0]
        preds = {}
        for k, tm in models.items():
            calls.clear()
            preds[k] = tm.decode_embedding(z, te, tsc, ts)["future_pred"]
            assert len(calls) == (FT if k == 5 else FT // k), k
        calls.clear()
        short = models[2].decode_embedding(z, te, tsc, ts, nfuture=5)
        assert len(calls) == 5
        ns = models[2].decode_embedding(z[:, None].expand(-1, 3, -1, -1),
                                        te, tsc, ts)["future_pred"]
    assert len(calls) == 5 + FT // 2  # the sample axis: one crop a step
    assert torch.equal(preds[5], preds[1])
    torch.testing.assert_close(short["future_pred"],
                               models[1].decode_embedding(
                                   z, te, tsc, ts, nfuture=5)["future_pred"],
                               rtol=0, atol=0)
    for k in (2, 3):
        torch.testing.assert_close(preds[k][:, :, 0], preds[1][:, :, 0],
                                   rtol=0, atol=0)
        assert torch.isfinite(preds[k]).all()
    torch.testing.assert_close(ns[:, 1], preds[2], rtol=0, atol=1e-6)


# ---- the slice in bf16: a train step, three adversarial iterations ------------

def test_bf16_train_step_matches(bf16, data):
    """One step of strive_tpu's ``make_train_step`` (its optimizer swapped
    for one that returns the gradients) against the port's
    ``Trainer.train_step`` (its Adam handed the gradients), both priors
    on. bf16 gradients carry bf16 rounding back through six rollout steps:
    each leaf is held to strive_tpu's bf16 gradient as closely as that is
    to strive_tpu's float32 one (the rounding's own size), within 2.5x."""
    model, params, _ = bf16
    scene, js, tsc, ts = data
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    key, kl_w = jax.random.PRNGKey(9), 0.002
    jgrads = {}
    for cdt in ("bfloat16", None):
        step = jax.jit(make_train_step(
            dataclasses.replace(model, compute_dtype=cdt), keep,
            TRAIN_WEIGHTS, j_state_norm(TEST_CATS), j_att_norm(TEST_CATS)))
        state, jm = step(TrainState(params, keep.init(params),
                                    jnp.asarray(0)), scene, js, key, kl_w)
        jgrads[cdt] = params_from_flax(jax.tree_util.tree_map(
            np.asarray, state.opt_state))
        if cdt:
            jm16 = jm

    tm = port_model(model, params, 3)  # the step updates its weights
    trainer = Trainer(tm, TRAIN_WEIGHTS, state_normalizer_for(TEST_CATS),
                      att_normalizer_for(TEST_CATS), lr=1e-4)
    grads = []
    adam = trainer.opt.step
    trainer.opt.step = lambda p, g: (grads.extend(g), adam(p, g))[1]
    k1, k2 = jax.random.split(key)
    shape = (scene.B, scene.NA, 32)
    tmet = trainer.train_step(tsc, ts, kl_w, t(jax.random.normal(k1, shape)),
                              t(jax.random.normal(k2, shape)))
    assert sorted(tmet) == sorted(jm16)
    for k in jm16:
        np.testing.assert_allclose(float(tmet[k]), float(jm16[k]),
                                   rtol=1e-2, err_msg=k)
    names = [k for k, _ in tm.named_parameters()]
    assert sorted(jgrads[None]) == sorted(names) and len(grads) == len(names)

    def rel(a, b):
        return np.linalg.norm(n(a) - n(b)) / np.linalg.norm(n(b))

    bad = {}
    for name, g in zip(names, grads):
        want, f32 = jgrads["bfloat16"][name], jgrads[None][name]
        err, noise = rel(g, want), rel(want, f32)
        if not err <= 2.5 * noise + 1e-3:
            bad[name] = (err, noise)
    assert not bad, bad


def test_bf16_adversarial_iterations_match(bf16, data):
    model, params, tm = bf16
    scene, js, tsc, ts = data
    je, te = _embeds(model, params, tm, data)
    jp, tp = je["prior_out"], te["prior_out"]
    jout = j_run(model, params, jp[0], 0.05, ADV_WEIGHTS, scene, js, 3, je,
                 "ego", (jp[0][:, 0], jp[1][:, 0]), jp, 2, None)
    z, result, _, _, losses, _ = t_run(
        tm, tp[0], 0.05, ADV_WEIGHTS, tsc, ts, 3, te, "ego",
        (tp[0][:, 0], tp[1][:, 0]), tp, 2, None)
    np.testing.assert_allclose(n(losses), n(jout[4]), rtol=1e-2)
    _close_rel(result, jout[1], BF16_MODEL, "result")
    # Adam's first steps are lr x sign(g): a latent whose gradient is bf16
    # noise may step either way each iteration, one that stepped a full lr
    # the same way all three times did not
    zj, z0 = n(jout[0]), n(jp[0])
    steady = np.abs(zj - z0) >= 2.9 * 0.05
    assert steady.mean() > 0.4
    np.testing.assert_allclose(n(z)[steady], zj[steady], rtol=0, atol=2e-2)
    np.testing.assert_allclose(n(z), zj, rtol=0, atol=6 * 0.05)


# ---- the entry points --------------------------------------------------------------

# the widths of configs/train_traffic_synthetic.cfg, for test_traffic
# and refine reading its checkpoint
TINY_WIDTHS = """\
data_version: synthetic
max_agents: 8
synth_scenes: 8
future_len: 6
map_obs_size_pix: 64
map_obs_bounds: [-4.0, -8.0, 12.0, 8.0]
conv_kernel_list: [5, 3, 3]
conv_stride_list: [2, 2, 2]
conv_filter_list: [8, 8, 16]
"""
TEST_CONFIG = TINY_WIDTHS + """\
batch_size: 4
split: val
test_sample_num: 2
test_sample_future_len: 6
test_sample_disp_err: true
test_sample_coll_rate: true
"""
REFINE_CONFIG = TINY_WIDTHS + """\
batch_size: 7
split: test
feasibility_num: 3
samp_future_len: 6
save_future_len: 6
num_iters: 2
save: true
"""


@pytest.mark.parametrize("flag", ["--bf16", "--no_output_bicycle"])
def test_entry_points_run_the_options(tmp_path, flag):
    """train_traffic (one epoch of two batches), then test_traffic, refine
    and adv_scenario_gen (one iteration on two scenes) reading its
    checkpoint, and convert_ref_ckpt on a stand-in reference state dict,
    each with ``flag``, on the CPU: finite numbers and written files."""
    from strive_tpu_torch.scripts import (convert_ref_ckpt,
                                          refine_traffic_optim, test_traffic)
    from strive_tpu_torch.scripts.common import build_model
    from torch_helpers import reference_state_dict

    out = tmp_path / "train"
    metrics = ttrain_script.main([
        "-c", os.path.join(REPO, "configs/train_traffic_synthetic.cfg"),
        "--out", str(out), "--device", "cpu", "--epochs", "1", flag])
    assert np.isfinite(float(metrics["loss"]))
    ckpt = str(out / "checkpoints" / "latest_model")
    assert os.path.isdir(ckpt)

    cfg = tmp_path / "test.cfg"
    cfg.write_text(TEST_CONFIG)
    got = test_traffic.main(["-c", str(cfg), "--out", str(tmp_path / "test"),
                             "--device", "cpu", "--ckpt", ckpt, flag])
    assert got and all(np.isfinite(v) for v in got.values())

    cfg = tmp_path / "refine.cfg"
    cfg.write_text(REFINE_CONFIG)
    stats = refine_traffic_optim.main(["-c", str(cfg), "--out",
                                       str(tmp_path / "refine"), "--device",
                                       "cpu", "--ckpt", ckpt, flag])
    assert stats["scenes"] > 0

    timings = {}
    out = tmp_path / "adv"
    tgen.main(["-c", os.path.join(REPO, "configs/adv_gen_synthetic.cfg"),
               "--out", str(out), "--device", "cpu", "--num_iters", "1",
               "--max_scenes", "2", "--ckpt", ckpt, flag], timings=timings)
    assert timings["final_loss"] and all(
        np.isfinite(v) for v in timings["final_loss"].values())
    for folder in ("refine", "adv"):
        assert [f for _, _, files in os.walk(tmp_path / folder)
                for f in files if f.endswith(".json")], folder

    cfg = tgen.parse_cfg(["-c", os.path.join(
        REPO, "configs/adv_gen_synthetic.cfg"), flag])
    cats = tuple(sorted(cfg.agent_types))
    model = build_model(cfg, state_normalizer_for(cats),
                        att_normalizer_for(cats), len(cats), "cpu")
    pth = tmp_path / "traffic_model.pth"
    torch.save({"model": reference_state_dict(model, 3)}, pth)
    widths = []
    for key in ("map_obs_size_pix", "map_obs_bounds", "conv_kernel_list",
                "conv_stride_list", "conv_filter_list", "future_len"):
        val = getattr(cfg, key)
        widths += [f"--{key}"] + [str(v) for v in (
            val if isinstance(val, list) else [val])]
    path = convert_ref_ckpt.main(["--pth", str(pth), "--out",
                                  str(tmp_path / "conv" / "m"), "--device",
                                  "cpu", flag] + widths)
    assert os.path.isdir(path)
