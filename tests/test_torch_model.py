"""Port model against strive_tpu on the CPU: the Flax->torch converter, the
blocks (MLP, StackedGRU, MapEncoder, SceneInteractionNet), and the
TrafficModel's embed / decode_embedding (with ext_future) / forward.

Tolerances: blocks atol 1e-5 (float32 matmuls and norms summed in another
order); embed and decode_embedding outputs atol 1e-4 in normalized units
(the GRU / GNN / bicycle steps compound those differences); forward's
rollouts from sampled latents rtol 1e-4 on top. The map
crops both models read are first checked to agree pixel for pixel, so the
tolerance never has to absorb a flipped pixel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import make_scene, tiny_model, tiny_store
from torch_helpers import assert_gather_parity, n, port_model, scene_to_torch, t

from strive_tpu.data.synthetic import synthetic_scene_list
from strive_tpu.maps import get_map_crop as j_crop
from strive_tpu.maps import synthetic_map_store as j_store
from strive_tpu.model import cnn as jcnn, common as jcommon
from strive_tpu.model import interaction as jint
from strive_tpu.model.traffic_model import (NormConfig, TrafficModel,
                                            init_model_params)
from strive_tpu.normalize import att_normalizer_for, state_normalizer_for
from strive_tpu.scene import pad_scene_arrays
from strive_tpu_torch.maps import queries as tq
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.model import cnn as tcnn, common as tcommon
from strive_tpu_torch.model import interaction as tint
from strive_tpu_torch.utils.convert import params_from_flax

BLOCK = dict(rtol=0, atol=1e-5)
MODEL = dict(rtol=0, atol=1e-4)


def _load(module, params):
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return module


def test_mlp_and_stacked_gru(rng):
    x = rng.normal(size=(3, 5, 11)).astype(np.float32)
    jm = jcommon.MLP((16, 16, 7))
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _load(tcommon.MLP(11, (16, 16, 7)), p)
    np.testing.assert_allclose(n(tm(t(x))),
                               n(jax.jit(jm.apply)(p, jnp.asarray(x))),
                               **BLOCK)

    h = rng.normal(size=(3, 2, 5, 8)).astype(np.float32)
    xi = rng.normal(size=(2, 5, 4)).astype(np.float32)
    jg = jcommon.StackedGRU(8, 3)
    pg = jax.jit(jg.init)(jax.random.PRNGKey(1), jnp.asarray(xi),
                          jnp.asarray(h))
    tg = _load(tcommon.StackedGRU(4, 8, 3), pg)
    jo, jh = jax.jit(jg.apply)(pg, jnp.asarray(xi), jnp.asarray(h))
    to, th = tg(t(xi), t(h))
    np.testing.assert_allclose(n(to), n(jo), **BLOCK)
    np.testing.assert_allclose(n(th), n(jh), **BLOCK)


def test_map_encoder_same_crop(rng):
    """NHWC crop in, channels_last NCHW view on the torch side."""
    crop = (rng.uniform(size=(4, 32, 32, 3)) > 0.5).astype(np.float32)
    je = jcnn.MapEncoder(16, (5, 3, 3), (2, 2, 2), (8, 8, 16))
    p = je.init(jax.random.PRNGKey(2), jnp.asarray(crop), input_layout="nhwc")
    te = _load(tcnn.MapEncoder(3, 32, 16, (5, 3, 3), (2, 2, 2), (8, 8, 16)), p)
    got = te(t(crop).permute(0, 3, 1, 2))
    want = je.apply(p, jnp.asarray(crop), input_layout="nhwc")
    np.testing.assert_allclose(n(got), n(want), **BLOCK)


def test_scene_interaction_net(rng):
    B, NA, D, NC = 2, 5, 12, 2
    x = rng.normal(size=(B, NA, D)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, (B, NA))
    pos = np.concatenate([rng.normal(size=(B, NA, 2)) * 10,
                          np.stack([np.cos(th), np.sin(th)], -1)],
                         -1).astype(np.float32)
    sem = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, (B, NA))]
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)  # lone agent
    jn = jint.SceneInteractionNet(16, 6)
    args = tuple(map(jnp.asarray, (x, pos, sem, mask)))
    p = jax.jit(jn.init)(jax.random.PRNGKey(3), *args)
    tn = _load(tint.SceneInteractionNet(D, NC, 16, 6), p)
    np.testing.assert_allclose(n(tn(t(x), t(pos), t(sem), t(mask))),
                               n(jax.jit(jn.apply)(p, *args)), **BLOCK)


def _crops_agree(jstore, tstore, scene, map_px, bounds):
    """The crops at the scene's current poses agree pixel for pixel."""
    st = scene.past[:, :, -1, :4] * 15.0  # lscale std; heading std 1
    pos = np.asarray(st).reshape(-1, 4)
    mapix = np.repeat(np.asarray(scene.map_idx), scene.NA)
    want = j_crop(jstore.raster, jstore.dx, jnp.asarray(pos),
                  jnp.asarray(mapix), bounds, L=map_px, W=map_px,
                  packed=jstore.packed, layout="nhwc")
    got = tq.get_map_crop(tstore.packed, tstore.dx, t(pos), t(mapix), bounds,
                          tstore.C, L=map_px, W=map_px, layout="nhwc")
    xys = tq.gen_car_coords(t(pos[:, :2]), t(pos[:, 2:]), map_px, map_px,
                            bounds=bounds)
    d = tstore.dx[t(mapix)][:, None, None, :].expand_as(xys)
    per_px = (n(got) != n(want)).any(axis=-1)
    return assert_gather_parity(per_px, np.zeros_like(per_px), xys, d)


def _compare_embed(je, te):
    for k in ("map_feat", "past_feat"):
        np.testing.assert_allclose(n(te[k]), n(je[k]), **MODEL, err_msg=k)
    for k in ("prior_out", "posterior_out"):
        for i in range(2):
            np.testing.assert_allclose(n(te[k][i]), n(je[k][i]), **MODEL,
                                       err_msg=k)


def test_full_width_embed_and_decode():
    """Default widths and 256 px crops (flatten 2x2x128 = 512 rows): holds
    the converter and the NHWC flatten order at the bench.py width."""
    cats = ("car", "truck")
    norm = NormConfig.from_normalizers(state_normalizer_for(cats),
                                       att_normalizer_for(cats))
    model = TrafficModel(npast=4, nfuture=2, map_obs_size_pix=256,
                         nclasses=2, norm=norm)
    js = j_store(num_maps=2, size_px=1024, channels=4)
    ts = t_store(num_maps=2, size_px=1024, channels=4, device="cpu")
    scene = pad_scene_arrays(synthetic_scene_list(
        num_scenes=1, num_maps=2, map_size_px=1024, PT=4, FT=2,
        min_agents=3, max_agents=3), 3, 2)
    params = init_model_params(model, scene, js, jax.random.PRNGKey(0))
    tm = port_model(model, params, map_channels=4)
    assert tm.map_encoder.out.weight.shape == (64, 512)
    assert _crops_agree(js, ts, scene, 256, model.map_bounds) == 0
    tsc = scene_to_torch(scene)
    je = jax.jit(lambda p, s: model.apply(p, s, js, method="embed"))(params,
                                                                     scene)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    _compare_embed(je, te)
    ext = scene.future_gt[:, 0, :, :4]
    jd = jax.jit(lambda p, z, e, x: model.apply(
        p, z, e, scene, js, x, method="decode_embedding"))(
            params, je["prior_out"][0], je, ext)["future_pred"]
    with torch.no_grad():
        td = tm.decode_embedding(t(je["prior_out"][0]), te, tsc, ts,
                                 t(ext))["future_pred"]
    np.testing.assert_allclose(n(td), n(jd), **MODEL)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(5)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=6)
    model = tiny_model(FT=6, PT=4)
    js = tiny_store()
    params = init_model_params(model, scene, js, jax.random.PRNGKey(5))
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    return model, params, scene, js, port_model(model, params, 3), ts


def test_embed_and_decode_with_ext_future(tiny):
    model, params, scene, js, tm, ts = tiny
    assert _crops_agree(js, ts, scene, 64, model.map_bounds) == 0
    tsc = scene_to_torch(scene)
    je = jax.jit(lambda p, s: model.apply(p, s, js, method="embed"))(params,
                                                                     scene)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    _compare_embed(je, te)
    z = je["prior_out"][0]
    ext = scene.future_gt[:, 0, :, :4]
    jd = jax.jit(lambda p, z, e, x: model.apply(
        p, z, e, scene, js, x, method="decode_embedding"))(params, z, je, ext)
    with torch.no_grad():
        td = tm.decode_embedding(t(z), te, tsc, ts, t(ext))
    np.testing.assert_allclose(n(td["future_pred"]), n(jd["future_pred"]),
                               **MODEL)


def test_forward_with_noise_passed_in(tiny):
    model, params, scene, js, tm, ts = tiny
    key = jax.random.PRNGKey(7)
    jo = jax.jit(lambda p, k: model.apply(p, scene, js, k, future_sample=True,
                                          method="forward"))(params, key)
    # forward draws eps ~ N(0, 1) from split(key)[0] (and [1] for samples)
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, jo["posterior_out"][0].shape)
    eps_s = jax.random.normal(k2, jo["prior_out"][0].shape)
    with torch.no_grad():
        to = tm(scene_to_torch(scene), ts, eps=t(eps), future_sample=True,
                eps_samp=t(eps_s))
    # z = mu + eps*sqrt(var) carries the posterior's differences into six
    # rollout steps: positions of ~4 normalized units get rtol 1e-4 too
    for k in ("future_pred", "future_samp"):
        np.testing.assert_allclose(n(to[k]), n(jo[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("prior_out", "posterior_out"):
        np.testing.assert_allclose(n(to[k][1]), n(jo[k][1]), **MODEL)

