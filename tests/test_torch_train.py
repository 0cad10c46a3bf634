"""The port's training and evaluation against strive_tpu's.

The tiny model of tests/test_torch_pipeline_stages.py (B=2 scenes x NA=4,
FT=6, numpy seed 0, weights ``init_model_params(PRNGKey(0))``), JAX's noise
passed in (``PRNGKey(5)``, split as ``TrafficModel.forward`` splits it):

- ``traffic_model_loss`` with both collision priors on (recon 1, kl 0.004,
  coll_veh_prior 0.05, coll_env_prior 0.1): every term rtol 1e-4, and the
  gradient of the loss for every parameter, by name, rtol 1e-3 / atol
  1e-5;
- ``compute_err`` rtol 1e-4 / atol 1e-5 (ang_err atol 1e-3 deg: arccos
  near 1 turns 1e-7 into 1e-3 deg); ``compute_disp_err`` on JAX's samples
  rtol 1e-5 / atol 1e-5; ``compute_coll_rate_env_from_traj`` exact (NaN
  frames too); ``TrafficModel.reconstruct`` atol 1e-4;
- one ``Trainer`` step (Adam, and AdamW with weight decay 0.01; lr 1e-4
  as configs/train_synth_prod.cfg, both priors on): the metrics rtol 1e-4
  and every updated parameter atol 1e-5, a tenth of the step, but where
  the gradient is within float noise of 0. Adam's first step is
  lr * g / (|g| + 1e-8), so an element whose step JAX took below 0.99 lr
  (|g| under 1e-6) moved by noise, and is held within 2 lr: measured, one
  element of 33,792 in ``prior_net.conv0.edge_mlp.fc0.weight`` 3.5e-5
  apart (at lr 1e-3, one of 36,864 in ``map_encoder.out.weight``);
- ``compute_kl_weight``; ``batch_iterator`` and ``bucketed_batch_iterator``
  batch for batch equal to strive_tpu's (every field, the masked tails) for
  seeds 0, 1, 2, with and without NA buckets;
- ``run_epoch``'s error policy (tests/test_train.py:41-73): a failure on
  the first batch re-raises, a ``RuntimeError`` on a later batch is
  skipped, and a kernel error (``KernelError``, or a CUDA error message) on
  a later batch is re-raised, also when it comes from where the crop
  wrapper launches inside the model's forward;

The entry points (``test_traffic``, ``train_traffic``, checkpoints) are in
tests/test_torch_train_entry_points.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import TEST_CATS, make_scene, tiny_model, tiny_store
from torch_helpers import n, port_model, scene_to_torch, t

from strive_tpu.data import dataset as jds
from strive_tpu.losses import training as jtr
from strive_tpu.model.traffic_model import init_model_params
from strive_tpu.normalize import att_normalizer_for as j_att_norm
from strive_tpu.normalize import state_normalizer_for as j_state_norm
from strive_tpu.train import Trainer as JTrainer
from strive_tpu_torch.data import dataset as tds
from strive_tpu_torch.losses import training as ttr
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.train import Trainer, compute_kl_weight
from strive_tpu_torch.utils.convert import params_from_flax
from strive_tpu_torch.utils.launch import KernelError, is_device_fault

FT = 6
WEIGHTS = {"recon": 1.0, "kl": 0.004, "coll_veh_prior": 0.05,
           "coll_env_prior": 0.1}
SN, AN = state_normalizer_for(TEST_CATS), att_normalizer_for(TEST_CATS)
JSN, JAN = j_state_norm(TEST_CATS), j_att_norm(TEST_CATS)
@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=FT)
    model = tiny_model(FT=FT, PT=4)
    js = tiny_store()
    params = init_model_params(model, scene, js, jax.random.PRNGKey(0))
    tm = port_model(model, params, 3)
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    return model, params, scene, js, tm, scene_to_torch(scene), ts


def _jax_noise(key, scene, latent=32):
    """The (eps, eps_samp) ``TrafficModel.forward`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    shape = (scene.B, scene.NA, latent)
    return (t(jax.random.normal(k1, shape, jnp.float32)),
            t(jax.random.normal(k2, shape, jnp.float32)))


def _grads_by_name(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


# ---- the loss and the errors ---------------------------------------------------

def test_traffic_model_loss_and_gradients_match(setup):
    model, params, scene, js, tm, tsc, ts = setup
    key = jax.random.PRNGKey(5)

    def jloss(p):
        pred = model.apply(p, scene, js, key, future_sample=True,
                           method="forward")
        out = jtr.traffic_model_loss(scene, pred, WEIGHTS, JSN, JAN, js)
        return out["loss"], out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    eps, eps_samp = _jax_noise(key, scene)
    pred = tm(tsc, ts, eps=eps, future_sample=True, eps_samp=eps_samp)
    tout = ttr.traffic_model_loss(tsc, pred, WEIGHTS, SN, AN, ts)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(n(tout[k]), n(jout[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(jout["coll_env_prior"]) > 0.0
    names = [k for k, _ in tm.named_parameters()]
    tgrad = torch.autograd.grad(tout["loss"], list(tm.parameters()))
    want = _grads_by_name(jgrad)
    assert sorted(want) == sorted(names)
    for name, g in zip(names, tgrad):
        np.testing.assert_allclose(n(g), n(want[name]), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_compute_err_and_reconstruct_match(setup):
    model, params, scene, js, tm, tsc, ts = setup
    jrec = jax.jit(lambda p: model.apply(p, scene, js,
                                         method="reconstruct"))(params)
    with torch.no_grad():
        trec = tm.reconstruct(tsc, ts)
    np.testing.assert_allclose(n(trec["future_pred"]),
                               n(jrec["future_pred"]), rtol=0, atol=1e-4)
    for a, b in zip(trec["posterior_out"], jrec["posterior_out"]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-4)
    key = jax.random.PRNGKey(5)
    jpred = jax.jit(lambda p: model.apply(p, scene, js, key,
                                          use_post_mean=True,
                                          method="forward"))(params)
    with torch.no_grad():
        tpred = tm(tsc, ts, use_post_mean=True)
    jerr = jtr.compute_err(scene, jpred, JSN)
    terr = ttr.compute_err(tsc, tpred, SN)
    for k in jerr:
        atol = 1e-3 if k == "ang_err" else 1e-5
        np.testing.assert_allclose(n(terr[k]), n(jerr[k]), rtol=1e-4,
                                   atol=atol, err_msg=k)


def test_compute_disp_err_matches(setup):
    model, params, scene, js, tm, tsc, ts = setup
    samp = np.random.default_rng(3).normal(
        size=(scene.B, 5, scene.NA, FT, 4)).astype(np.float32)
    samp[..., 2:4] /= np.linalg.norm(samp[..., 2:4], axis=-1, keepdims=True)
    want = jtr.compute_disp_err(scene, jnp.asarray(samp), JSN)
    got = ttr.compute_disp_err(tsc, t(samp), SN)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_coll_rate_env_from_traj_matches(setup):
    _, _, _, js, _, _, ts = setup
    rng = np.random.default_rng(7)
    NA, T = 12, 2
    h = rng.uniform(-np.pi, np.pi, (NA, T))
    fut = np.concatenate([rng.uniform(20, 108, (NA, T, 2)),
                          np.stack([np.cos(h), np.sin(h)], -1)],
                         -1).astype(np.float32)
    fut[2, 1:] = np.nan
    lw = np.stack([rng.uniform(4, 5.5, NA), rng.uniform(1.8, 2.2, NA)],
                  -1).astype(np.float32)
    for mi in (0, 1):
        want = jtr.compute_coll_rate_env_from_traj(fut, lw, js, mi)
        got = ttr.compute_coll_rate_env_from_traj(fut, lw, ts, mi)
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


# ---- the trainer ---------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_trainer_step_matches(setup, weight_decay):
    model, params, scene, js, _, tsc, ts = setup
    lr, kl_w = 1e-4, 0.002  # configs/train_synth_prod.cfg's lr
    # the JAX trainer donates its state: give it a copy of the weights
    jt = JTrainer(model, jax.tree_util.tree_map(jnp.array, params), WEIGHTS,
                  JSN, JAN, lr=lr, weight_decay=weight_decay)
    key = jax.random.PRNGKey(9)
    jm, _ = jt.run_epoch([scene], js, key, kl_w, train=True)
    _, sub = jax.random.split(key)  # run_epoch's split of the batch key

    tm = port_model(model, params, 3)
    tt = Trainer(tm, WEIGHTS, SN, AN, lr=lr, weight_decay=weight_decay)
    tt.draw_noise = lambda sc: _jax_noise(sub, sc)
    tmet, _ = tt.run_epoch([tsc], ts, kl_w, train=True)
    for k in jm:
        if k != "epoch_time":
            atol = 1e-3 if k == "ang_err" else 1e-6
            np.testing.assert_allclose(tmet[k], jm[k], rtol=1e-4, atol=atol,
                                       err_msg=k)
    want = _grads_by_name(jt.state.params)
    before = _grads_by_name(params)
    for name, p in tm.named_parameters():
        # Adam's first update direction, as JAX took it
        u = (n(before[name]) - n(want[name])) / lr - weight_decay * n(
            before[name])
        noise = np.abs(u) < 0.99  # |g| < 1e-6: a gradient of float noise
        diff = np.abs(n(p) - n(want[name]))
        assert diff[~noise].max(initial=0) <= 1e-5, name
        assert diff[noise].max(initial=0) <= 2 * lr, name
    assert tt.step_count == 1 and tt.opt.count == 1


def test_kl_weight_schedule():
    from strive_tpu.train import compute_kl_weight as j_kl

    for e in (0, 5, 10, 20, 30):
        assert compute_kl_weight(e, 20, 0.004) == j_kl(e, 20, 0.004)
    assert compute_kl_weight(10, 20, 0.004) == pytest.approx(0.002)


def _ds_scenes():
    rng = np.random.default_rng(11)
    scenes = []
    for i, na in enumerate((3, 12, 6, 2, 9, 16, 5, 7, 4, 11)):
        scenes.append({
            "past": rng.normal(size=(na, 4, 6)).astype(np.float32),
            "past_vis": np.ones((na, 4), np.float32),
            "future": rng.normal(size=(na, FT, 6)).astype(np.float32),
            "future_vis": np.ones((na, FT), np.float32),
            "sem": np.eye(2, dtype=np.float32)[rng.integers(0, 2, na)],
            "lw": rng.normal(size=(na, 2)).astype(np.float32),
            "map_idx": i % 2})
    return scenes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("buckets", [None, (4, 8, 16)])
def test_batch_iterators_match(seed, buckets):
    scenes = _ds_scenes()
    jd = jds.SceneDataset(scenes, 8, 2, buckets=buckets)
    td = tds.SceneDataset(scenes, 8, 2, buckets=buckets, device="cpu")
    assert td.na_max == jd.na_max
    assert [td.bucket_of(i) for i in range(len(td))] == \
        [jd.bucket_of(i) for i in range(len(jd))]
    for it in ("batch_iterator", "bucketed_batch_iterator"):
        want = list(getattr(jds, it)(jd, 3, shuffle=True, seed=seed))
        got = list(getattr(tds, it)(td, 3, shuffle=True, seed=seed))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in g.__dataclass_fields__:
                np.testing.assert_array_equal(n(getattr(g, k)),
                                              n(getattr(w, k)), err_msg=k)
    cat_t = tds.ConcatSceneDataset([td, tds.SceneDataset(scenes[:3], 8, 2,
                                                         device="cpu")])
    cat_j = jds.ConcatSceneDataset([jd, jds.SceneDataset(scenes[:3], 8, 2)])
    assert len(cat_t) == len(cat_j) == 13
    got, want = cat_t.get_batch([12, 0, 10]), cat_j.get_batch([12, 0, 10])
    for k in got.__dataclass_fields__:
        np.testing.assert_array_equal(n(getattr(got, k)),
                                      n(getattr(want, k)), err_msg=k)


@pytest.fixture
def small_trainer(setup):
    model, params, scene, js, _, tsc, ts = setup
    tm = port_model(model, params, 3)
    w = dict(WEIGHTS, coll_veh_prior=0.0, coll_env_prior=0.0)
    return Trainer(tm, w, SN, AN, lr=1e-3), tsc, ts


def test_run_epoch_first_batch_failure_raises(small_trainer):
    trainer, tsc, ts = small_trainer
    real = trainer.train_step

    def flaky(scene, *a):
        if scene is None:  # the sentinel "bad" batch
            raise RuntimeError("bad batch")
        return real(scene, *a)

    trainer.train_step = flaky
    trainer.draw_noise = lambda sc: (None, None) if sc is None else \
        Trainer.draw_noise(trainer, sc)
    with pytest.raises(RuntimeError):
        trainer.run_epoch([None], ts, 0.004)
    m, _ = trainer.run_epoch([tsc, None, tsc], ts, 0.004)
    assert np.isfinite(m["loss"]) and trainer.step_count == 2


@pytest.mark.parametrize("error", [
    KernelError("strive_map_crop launch failed: cudaError 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"),
])
def test_run_epoch_never_skips_a_kernel_fault(small_trainer, error):
    trainer, tsc, ts = small_trainer
    real = trainer.train_step
    calls = []

    def failing_second(scene, *a):
        calls.append(1)
        if len(calls) == 2:
            raise error
        return real(scene, *a)

    trainer.train_step = failing_second
    assert is_device_fault(error) and isinstance(error, RuntimeError)
    with pytest.raises(type(error), match=str(error)[:12]):
        trainer.run_epoch([tsc, tsc, tsc], ts, 0.004)
    assert not is_device_fault(RuntimeError("bad batch"))


@pytest.mark.parametrize("error,skipped", [
    (KernelError("strive_map_crop launch failed: cudaError 700"), False),
    (RuntimeError("bad batch"), True),
])
def test_run_epoch_error_from_inside_the_model(small_trainer, monkeypatch,
                                               error, skipped):
    """The error raised where the crop wrapper launches, in the second
    batch's forward: a ``KernelError`` ends the epoch, a plain
    ``RuntimeError`` skips the batch."""
    from strive_tpu_torch.model import traffic_model as ttm

    trainer, tsc, ts = small_trainer
    real = ttm.get_map_crop
    per_batch = 1 + FT  # no collision priors: the posterior decode alone
    calls = []

    def crop(*a, **k):
        calls.append(1)
        if len(calls) == per_batch + 1:
            raise error
        return real(*a, **k)

    monkeypatch.setattr(ttm, "get_map_crop", crop)
    if skipped:
        m, _ = trainer.run_epoch([tsc, tsc, tsc], ts, 0.004)
        assert np.isfinite(m["loss"]) and trainer.step_count == 2
    else:
        with pytest.raises(KernelError):
            trainer.run_epoch([tsc, tsc, tsc], ts, 0.004)
        assert trainer.step_count == 1


# ---- the kernels' shapes on this path ---------------------------------------

def test_training_kernel_args_are_the_steps(monkeypatch):
    """``kernel_cases.decode_crop_args(B=8)`` and ``training_k2`` (the
    inputs chip_smoke.py and the card tests hold K1 and K2 to at
    training's shape) are what a training forward hands ``get_map_crop``
    at a decode step (B x NA poses, 1 + 2 FT calls with both priors) and
    what ``traffic_model_loss`` hands ``get_coll_point`` (the ego's FT
    prior-sample poses, 96 cars)."""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.losses import penalties
    from strive_tpu_torch.maps import queries as tq

    store, args = kc.training_k2("cpu")
    _, scene, (smean, sstd, amean, astd) = kc._full_width_scene("cpu", 12,
                                                                16, 8)
    seen = []

    def spy(*a, **k):
        seen.append(a)
        return tq.get_coll_point(*a, **k)

    monkeypatch.setattr(penalties, "get_coll_point", spy)
    pred = {"future_pred": scene.future_gt[..., :4],
            "future_samp": scene.future_gt[..., :4],
            "prior_out": (torch.zeros(8, 16, 2), torch.ones(8, 16, 2)),
            "posterior_out": (torch.zeros(8, 16, 2), torch.ones(8, 16, 2))}
    ttr.traffic_model_loss(scene, pred, WEIGHTS, SN, AN, store)
    (got,) = seen
    assert got[2].shape == (96, 4) == args[2].shape
    for a, b in zip(got[:5], args[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)

    crop = kc.decode_crop_args("cpu", 8)
    assert crop[2].shape == (128, 4)
    torch.testing.assert_close(
        crop[2], (scene.future_gt[:, :, 0, :4] * sstd + smean).reshape(-1, 4))


def test_training_forward_crops_a_step_in_one_call(setup, monkeypatch):
    """A training forward with both priors crops 1 + 2 FT times, every
    pose of a step in one call (one K1 launch a step on the card)."""
    from strive_tpu_torch.maps import queries as tq
    from strive_tpu_torch.model import traffic_model as ttm

    _, _, scene, _, tm, tsc, ts = setup
    sizes = []

    def spy(packed, dx, pos, *a, **k):
        sizes.append(pos.shape[0])
        return tq.get_map_crop(packed, dx, pos, *a, **k)

    monkeypatch.setattr(ttm, "get_map_crop", spy)
    with torch.no_grad():
        eps = torch.zeros(scene.B, scene.NA, 32)
        tm(tsc, ts, eps=eps, future_sample=True, eps_samp=eps)
    assert sizes == [scene.B * scene.NA] * (1 + 2 * FT)
