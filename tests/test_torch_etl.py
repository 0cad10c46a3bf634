"""The port's nuScenes ETL against strive_tpu's, on the CPU.

- every function of ``data/etl.py`` (finite differences with NaN gaps,
  the drivable/carpark frame filter, the splits, the challenge anchors),
  exact;
- ``WindowedSceneDataset``: windows, per-window dicts and batches, with
  the noise draws, NA buckets, challenge windows and the final window,
  exact;
- ``load_etl_dataset`` from an ETL directory written here (3 maps of
  nuScenes' unequal extents at 0.25 px/m, so ``dx`` is not 0.25 and
  differs per map; 12 scenes; ``mini``, and ``trainval`` with and without
  the random val split): the store's raster, ``dx`` and packed bytes, the
  windows, the batches and the lane graphs equal;
- ``finalize_scene_states`` on that directory's raw scenes, equal;
- ``scenarios_as_scenes`` on the tracked scenario JSONs, and
  ``--scenario_dir`` appending the same windows to the training split;
- ``rasterize_maps``, ``process_nuscenes_lanegraph`` and
  ``flip_lanegraph_x`` on tests/test_map_ref_parity.py's ``FakeNMap``,
  byte-equal;
- the nuScenes-store cases of ``kernel_cases`` (K1's and K2's inputs on
  the four maps' extents, here at 0.25 px/m): every kind of pose lands
  where it should, and the plain versions agree with strive_tpu's crop
  and footprint on them;
- the production configs (``train_traffic.cfg``, ``test_traffic.cfg``,
  ``adv_gen_rule_based.cfg``) through the port's entry points on that
  directory, cut in size; a missing ETL directory raises the
  ``FileNotFoundError`` strive_tpu raises.
"""

import argparse
import importlib.util
import os
import pickle

import numpy as np
import jax  # noqa: F401  (JAX on the CPU before torch's threads start)
import pytest
import torch

import tg_shim
from test_map_ref_parity import (LAYERS, FakeNMap, _fake_discretize,
                                 _lane_payload, _masks_for)
from torch_helpers import assert_gather_parity, n, t

from strive_tpu.data import etl as jetl
from strive_tpu.data import scenario_ingest as jingest
from strive_tpu.data.loading import load_environment as j_load
from strive_tpu.maps import get_map_crop as j_crop
from strive_tpu.maps import lanegraph as jlg
from strive_tpu.maps import queries as jq
from strive_tpu.normalize import att_normalizer_for as j_att
from strive_tpu.normalize import state_normalizer_for as j_state
from strive_tpu_torch.data import etl as tetl
from strive_tpu_torch.data import scenario_ingest as tingest
from strive_tpu_torch.data.loading import load_environment as t_load
from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.data.synthetic_etl import write_synthetic_etl
from strive_tpu_torch.maps import crop_kernel
from strive_tpu_torch.maps import lanegraph as tlg
from strive_tpu_torch.maps import queries as tq
from strive_tpu_torch.maps.store import NUSC_MAP_SIZES
from strive_tpu_torch.normalize import att_normalizer_for as t_att
from strive_tpu_torch.normalize import state_normalizer_for as t_state
from strive_tpu_torch.scripts import preprocess_nuscenes as tpre

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN_ROOT = os.path.join(REPO, "out/adv_gen_synth_hc_prod/scenario_results")
CATS = ("car", "truck")
MAPS3 = ["singapore-onenorth", "boston-seaport", "singapore-queenstown"]
PIX_PER_M = 0.25


def _load_script(name):
    """scripts/<name>.py of the JAX package, by path."""
    spec = importlib.util.spec_from_file_location(
        f"_strive_scripts_{name}", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jpre():
    return _load_script("preprocess_nuscenes")


def _cfg(**kw):
    base = dict(data_version="trainval", agent_types=list(CATS),
                reduce_cats=False, max_agents=8, past_len=4, future_len=6,
                seq_interval=3, data_noise_std=0.0, na_buckets=None,
                val_size=200, random_val=False, use_challenge_splits=False,
                scenario_dir=None, synth_scenes=3)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def etl_root(tmp_path_factory):
    """Small ETL directories: 'mini' with 12 scenes and 'trainval' with
    800 names, 12 of them with data (6 in NUSC_VAL_SPLIT_200)."""
    root = str(tmp_path_factory.mktemp("nusc"))
    kw = dict(maps=MAPS3, pix_per_m=PIX_PER_M, frames=24, agents=(6, 12),
              spacing_m=256.0, lane_res_m=8.0, device="cpu")
    write_synthetic_etl(root, version="mini", num_scenes=12, seed=1, **kw)
    val = sorted(jetl.NUSC_VAL_SPLIT_200)[:6]
    write_synthetic_etl(root, version="trainval", num_scenes=800,
                        with_data=val + [3, 5, 7, 9, 11, 13], seed=2, **kw)
    return root


# ---- etl.py functions ---------------------------------------------------------

def _nan_traj(rng, T=16):
    x = rng.normal(size=(T, 4)) * 3
    x[:, 2:] /= np.linalg.norm(x[:, 2:], axis=-1, keepdims=True)
    for t0, t1 in ((0, 2), (6, 8), (T - 1, T)):
        x[t0:t1] = np.nan
    return x


def test_finite_differences_exact():
    rng = np.random.default_rng(0)
    t = np.arange(16) * 0.5
    for _ in range(4):
        x = _nan_traj(rng)
        h = np.arctan2(x[:, 3], x[:, 2])
        np.testing.assert_array_equal(tetl.velocity(x[:, :2], t),
                                      jetl.velocity(x[:, :2], t))
        np.testing.assert_array_equal(tetl.heading_change_rate(h, t),
                                      jetl.heading_change_rate(h, t))
        for a, b in zip(tetl.states_from_xyh(x, h, t),
                        jetl.states_from_xyh(x, h, t)):
            np.testing.assert_array_equal(a, b)


def test_drivable_filter_and_states_exact():
    """The frame filter (check_on_layer: the port's in torch, strive_tpu's
    in JAX) on a raster of non-0.25 dx, then the states."""
    rng = np.random.default_rng(1)
    raster = np.zeros((2, 4, 120, 90), np.uint8)
    raster[:, 0, 20:100, 10:80] = 1
    raster[:, 1, 40:60, 30:50] = 1
    dx = np.array([[0.2503, 0.2497], [0.3333, 0.2501]], np.float32)
    t = np.arange(16) * 0.5
    for mi in (0, 1):
        for _ in range(6):
            x = np.concatenate([rng.uniform(0, 25, (16, 2)),
                                rng.normal(size=(16, 2))], 1)
            x[:, 2:] /= np.linalg.norm(x[:, 2:], axis=-1, keepdims=True)
            x[rng.random(16) < 0.2] = np.nan
            h = np.arctan2(x[:, 3], x[:, 2])
            lw = rng.uniform(2, 5, 2)
            for carpark in (None, raster[:, 1]):
                want = jetl.drivable_keep_mask(x, lw, mi, raster[:, 0], dx,
                                               carpark=carpark)
                got = tetl.drivable_keep_mask(x, lw, mi, raster[:, 0], dx,
                                              carpark=carpark)
                np.testing.assert_array_equal(got, want)
                a = tetl.agent_states_with_filter(x, h, t, got)
                b = jetl.agent_states_with_filter(x, h, t, want)
                assert (a is None) == (b is None)
                if a is not None:
                    for u, v in zip(a, b):
                        np.testing.assert_array_equal(u, v)
    x = np.full((16, 4), np.nan)
    assert tetl.agent_states_with_filter(x, x[:, 0], t) is None


@pytest.mark.parametrize("version,split,val_size,randomize", [
    ("trainval", "train", 200, True), ("trainval", "val", 400, True),
    ("trainval", "test", 200, False), ("trainval", "val", 200, False),
    ("mini", "train", 200, True), ("mini", "val", 200, False),
])
def test_split_scene_names_exact(version, split, val_size, randomize):
    names = ["scene-%04d" % i for i in range(850 if version == "trainval"
                                             else 10)]
    got = tetl.split_scene_names(names, split, version, val_size, randomize)
    assert got == jetl.split_scene_names(names, split, version, val_size,
                                         randomize)
    assert tetl.NUSC_VAL_SPLIT_400 == jetl.NUSC_VAL_SPLIT_400
    assert tetl.CAT2KEY == jetl.CAT2KEY and tetl.REDUCE_MAP == jetl.REDUCE_MAP


def test_challenge_splits_and_anchors_exact():
    train = ["scene-%04d" % i for i in range(300)]
    val = ["scene-%04d" % i for i in range(300, 350)]
    pred = {s: [f"i{s}_s{s}"] for s in train[::3] + val}
    for split in ("train", "val", "test"):
        assert tetl.challenge_split_scenes(pred, train, val, split) == \
            jetl.challenge_split_scenes(pred, train, val, split)
    sc = {"agent_tokens": ["ego", "instA", "instB"],
          "sample_tokens": ["s%02d" % t for t in range(20)]}
    toks = ["instA_s07", "instB_s12", "instZ_s05", "instA_s99"]
    assert tetl.challenge_anchors_for_scene(sc, toks) == \
        jetl.challenge_anchors_for_scene(sc, toks) == [(1, 7), (2, 12)]


# ---- WindowedSceneDataset ------------------------------------------------------

def _raw_scenes(seed=3, n_scenes=3, T=22):
    rng = np.random.default_rng(seed)
    scenes = []
    for si in range(n_scenes):
        na = int(rng.integers(3, 14))
        traj = rng.normal(size=(na, T, 6)).astype(np.float32) * 5
        traj[..., 2:4] /= np.linalg.norm(traj[..., 2:4], axis=-1,
                                         keepdims=True)
        traj[rng.random((na, T)) < 0.15] = np.nan
        traj[0] = np.abs(traj[0])
        scenes.append({
            "traj": traj,
            "vis": (~np.isnan(traj).any(-1)).astype(np.float32),
            "lw": rng.uniform(1, 6, (na, 2)).astype(np.float32),
            "sem": np.eye(2, dtype=np.float32)[rng.integers(0, 2, na)],
            "map_idx": si % 2, "name": f"s{si}",
            "challenge_anchors": [(1, 5), (2, 9), (1, 20)],
        })
    return scenes


@pytest.mark.parametrize("kw", [
    dict(seq_interval=2),
    dict(seq_interval=1, noise_std=0.01, seed=5),
    dict(seq_interval=3, buckets=(4, 8), require_full_past=True),
    dict(include_final_window=True, noise_std=0.05, seed=7),
    dict(challenge=True),
])
def test_windowed_dataset_exact(kw):
    scenes = _raw_scenes()
    js = jetl.WindowedSceneDataset(scenes, 6, 2, 4, 6, j_state(CATS),
                                   j_att(CATS), **kw)
    ts = tetl.WindowedSceneDataset(scenes, 6, 2, 4, 6, t_state(CATS),
                                   t_att(CATS), device="cpu", **kw)
    assert ts.windows == js.windows and len(ts) == len(js) > 0
    assert [ts.bucket_of(i) for i in range(len(ts))] == \
        [js.bucket_of(i) for i in range(len(js))]
    for i in range(len(ts)):  # the noise draws follow the same order
        a, b = ts.scene_dict(i), js.scene_dict(i)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    idx = list(range(min(3, len(ts))))
    got, want = ts.get_batch(idx, na=8), js.get_batch(idx, na=8)
    for k in got.__dataclass_fields__:
        if getattr(got, k) is not None:
            np.testing.assert_array_equal(n(getattr(got, k)),
                                          n(getattr(want, k)), err_msg=k)


# ---- load_etl_dataset ------------------------------------------------------------

@pytest.mark.parametrize("version,split,random_val,noise", [
    ("mini", "train", True, 0.0), ("mini", "val", False, 0.01),
    ("trainval", "val", True, 0.0), ("trainval", "val", False, 0.01),
    ("trainval", "train", True, 0.01), ("trainval", "test", False, 0.0),
])
def test_load_etl_dataset_exact(etl_root, version, split, random_val, noise):
    cfg = _cfg(data_version=version, random_val=random_val,
               data_noise_std=noise, data_dir=etl_root)
    etl_dir = os.path.join(etl_root, "strive_tpu_etl", version)
    js = jetl.load_etl_dataset(etl_dir, split, cfg, j_state(CATS),
                               j_att(CATS), load_lanegraph=True)
    ts = tetl.load_etl_dataset(etl_dir, split, cfg, t_state(CATS),
                               t_att(CATS), load_lanegraph=True,
                               device="cpu")
    (jd, jst, jlgs), (td, tst, tlgs) = js[:3], ts[:3]
    # the store: raster, per-map dx, the packed bytes (strive_tpu's packed
    # is zero-padded to its TPU block grid)
    np.testing.assert_array_equal(n(tst.raster), n(jst.raster))
    np.testing.assert_array_equal(n(tst.dx), n(jst.dx))
    M, H, W = tst.packed.shape
    np.testing.assert_array_equal(n(tst.packed), n(jst.packed)[:, :H, :W])
    assert not n(jst.packed)[:, H:].any() and not n(jst.packed)[:, :, W:].any()
    assert tst.map_names == jst.map_names == tuple(MAPS3)
    dxs = n(tst.dx)
    assert not np.any(dxs == 0.25) and len(set(dxs[:, 0].tolist())) == 3
    # windows and batches
    assert td.windows == jd.windows
    assert len(td) == len(jd) > 0
    for i in range(len(td)):
        a, b = td.scene_dict(i), jd.scene_dict(i)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    idx = list(range(0, len(td), max(1, len(td) // 4)))
    got, want = td.get_batch(idx), jd.get_batch(idx)
    for k in got.__dataclass_fields__:
        if getattr(got, k) is not None:
            np.testing.assert_array_equal(n(getattr(got, k)),
                                          n(getattr(want, k)), err_msg=k)
    # the lane graphs
    assert sorted(tlgs) == sorted(jlgs) == sorted(MAPS3)
    for m in tlgs:
        for k in ("xy", "edges", "edgeixes"):
            np.testing.assert_array_equal(tlgs[m][k], jlgs[m][k])
        assert tlgs[m]["out_edges"] == jlgs[m]["out_edges"]


def test_load_environment_etl_and_upsample(etl_root):
    """``load_environment``'s ETL branch; ``pix_per_m`` upsamples from the
    finest map (strive_tpu/data/loading.py:83-93)."""
    cfg = _cfg(data_version="trainval", data_dir=etl_root)
    for ppm in (None, 1.0):
        _, jst, _, _, _ = j_load(cfg, "val", pix_per_m=ppm)
        _, tst, _, _, _ = t_load(cfg, "val", pix_per_m=ppm, device="cpu")
        np.testing.assert_array_equal(n(tst.raster), n(jst.raster))
        np.testing.assert_array_equal(n(tst.dx), n(jst.dx))
    assert tst.raster.shape[-1] == 4 * round(max(
        NUSC_MAP_SIZES[m][1] for m in MAPS3) * PIX_PER_M)
    cfg.data_dir = os.path.join(etl_root, "missing")
    with pytest.raises(FileNotFoundError):
        j_load(cfg, "val")
    with pytest.raises(FileNotFoundError):
        t_load(cfg, "val", device="cpu")


def test_finalize_scene_states_exact(jpre):
    """The filter-then-states pass of the preprocessing on raw scenes of
    ``extract_scenes``' format, on nuScenes-extent maps."""
    from strive_tpu_torch.data import synthetic_etl as se

    maps = {m: se.SyntheticNuscMap(NUSC_MAP_SIZES[m], 256.0) for m in MAPS3}
    raster, dx, map_list = tpre.rasterize_maps(maps, LAYERS, PIX_PER_M)
    jr, jdx, jml = jpre.rasterize_maps(maps, LAYERS, PIX_PER_M)
    np.testing.assert_array_equal(raster, jr)
    np.testing.assert_array_equal(dx, jdx)
    rng = np.random.default_rng(4)
    lanes = [((0.0, 256.0), (1.0, 0.0), 1500.0),
             ((256.0, 0.0), (0.0, 1.0), 1500.0)]
    raw = {f"s{i}": se._scene(rng, f"s{i}", i % 3, MAPS3[i % 3], lanes, 20,
                              (3, 10), CATS, MAPS3[i % 3].startswith("sing"))
           for i in range(6)}
    keep = {"s1": np.array([False, True] + [False] * 20)}
    got = tpre.finalize_scene_states(raw, raster, dx, 1, keep)
    want = jpre.finalize_scene_states(raw, raster, dx, 1, keep)
    assert sorted(got) == sorted(want)
    for name in got:
        for k in want[name]:
            a, b = got[name][k], want[name][k]
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                assert a == b, k


# ---- K1 and K2 on the nuScenes-extent store ------------------------------------

def test_nusc_kernel_cases_against_strive_tpu():
    """The plain versions of K1 and K2 (the card's oracle) against
    strive_tpu's crop and footprint on the nuScenes-extent store: poses
    inside, at the true edge, in the zero padding of smaller maps and off
    the stack, on every map (Singapore's flipped)."""
    import jax.numpy as jnp

    store = kc.nusc_store("cpu", pix_per_m=PIX_PER_M)
    assert store.map_names == tuple(NUSC_MAP_SIZES)
    assert set(n(store.dx).ravel().tolist()).isdisjoint({1 / PIX_PER_M})
    cases = kc.nusc_pose_cases(store, per=6)
    M, H, W = store.packed.shape
    for kind, (pos, mapix) in cases.items():
        m, py, px = tq._pixel_index(H, W, store.dx, t(pos[:, None, :2]),
                                    t(mapix))
        at_origin = ((py == 0) & (px == 0))[:, 0]
        byte = store.packed[m[:, 0], py[:, 0], px[:, 0]]
        if kind == "off":
            assert bool(at_origin.all())
        if kind == "padding":
            assert not bool(at_origin.any()) and not bool(byte.any())
        if kind == "interior":
            assert not bool(at_origin.any()) and bool(byte.any())
        assert set(mapix.tolist()) == (set(range(4)) if kind != "padding"
                                       else set(mapix.tolist()))
    k1, k1_nchw, k2 = kc.nusc_kernel_args(store, cases, L=32)
    pos, mapix = n(k1[2]), n(k1[3])
    raster = jnp.asarray(n(store.raster))
    dx = jnp.asarray(n(store.dx))
    for args in (k1, k1_nchw):
        got = crop_kernel.map_crop_plain(*args)
        want = j_crop(raster, dx, jnp.asarray(pos), jnp.asarray(mapix),
                      (-17.0, -38.5, 60.0, 38.5), L=32, W=32,
                      layout=args[-1])
        ch = 1 if args[-1] == "nchw" else 3
        per_px = (n(got) != n(want)).any(axis=ch)
        xys = tq.rotate_grid(args[4][None, :, None], args[5][None, None, :],
                             args[2][:, :2], args[2][:, 2:4])
        d = store.dx[args[3]][:, None, None, :].expand_as(xys)
        assert_gather_parity(per_px, np.zeros_like(per_px), xys, d)
    got = crop_kernel.footprint_coll_point_plain(*k2)
    want = jq.get_coll_point(raster[:, 0], dx, jnp.asarray(pos),
                             jnp.asarray(n(k2[3])), jnp.asarray(mapix))
    same = n(got[2]) == n(want[2])
    assert same.mean() > 0.95
    np.testing.assert_array_equal(n(got[1])[same], n(want[1])[same])
    np.testing.assert_allclose(n(got[0])[same], n(want[0])[same], rtol=0,
                               atol=2e-6 * float(np.abs(pos[:, :2]).max()
                                                 + 12))


# ---- scenario re-ingestion -------------------------------------------------------

@pytest.mark.parametrize("folder", ["adv_sol_success", "sol_failed",
                                    "adv_failed"])
def test_scenarios_as_scenes_exact(folder):
    d = os.path.join(SCEN_ROOT, folder)
    maps = ["synthetic-0", "synthetic-1"]
    got = tingest.scenarios_as_scenes(d, maps, 2)
    want = jingest.scenarios_as_scenes(d, maps, 2)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_scenario_dir_appends_the_same_windows():
    cfg = _cfg(data_version="synthetic", future_len=12, max_agents=16,
               scenario_dir=os.path.join(SCEN_ROOT, "adv_failed"),
               data_noise_std=0.01)
    jd = j_load(cfg, "train")[0]
    td = t_load(cfg, "train", device="cpu")[0]
    assert len(td) == len(jd) == 3 + 17
    idx = list(range(len(td)))
    got, want = td.get_batch(idx), jd.get_batch(idx)
    for k in got.__dataclass_fields__:
        if getattr(got, k) is not None:
            np.testing.assert_array_equal(n(getattr(got, k)),
                                          n(getattr(want, k)), err_msg=k)
    assert len(t_load(cfg, "val", device="cpu")[0]) == 3  # train only


# ---- maps: rasterizer and lane graphs -------------------------------------------

@pytest.fixture(scope="module")
def fake_maps():
    tg_shim.install_nuscenes_stub()
    import nuscenes.map_expansion.arcline_path_utils as arc

    arc.discretize_lane = _fake_discretize
    maps = {}
    for m in ["singapore-hollandvillage", "singapore-queenstown",
              "boston-seaport", "singapore-onenorth"]:
        px = tuple(np.round(np.array(NUSC_MAP_SIZES[m]) * 0.125)
                   .astype(np.int32))
        maps[m] = FakeNMap(*_lane_payload(), _masks_for(m, px, LAYERS))
    return maps


@pytest.mark.parametrize("layers", [LAYERS, ["road_divider", "drivable_area",
                                              "lane_divider"]])
def test_rasterize_maps_byte_equal(jpre, fake_maps, layers):
    for flip in (True, False):
        got = tpre.rasterize_maps(fake_maps, layers, 0.125, flip)
        want = jpre.rasterize_maps(fake_maps, layers, 0.125, flip)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype and got[2] == want[2]


@pytest.mark.parametrize("mname", ["boston-seaport", "singapore-queenstown"])
def test_lanegraph_extraction_and_flip_byte_equal(fake_maps, mname):
    got = tlg.process_nuscenes_lanegraph(fake_maps[mname], 1.0, 1e-6)
    want = jlg.process_nuscenes_lanegraph(fake_maps[mname], 1.0, 1e-6)
    H = NUSC_MAP_SIZES[mname][0]
    for a, b in ((got, want), (tlg.flip_lanegraph_x(got, H),
                               jlg.flip_lanegraph_x(want, H))):
        for k in ("xy", "edges", "edgeixes"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        assert a["in_edges"] == b["in_edges"]
        assert a["out_edges"] == b["out_edges"]
    assert pickle.dumps(tlg.flip_lanegraph_x(got, H)["xy"]) == \
        pickle.dumps(jlg.flip_lanegraph_x(want, H)["xy"])


# ---- the production configs through the port's entry points -------------------

# cut in size: a small model (64 px crops, three narrow convs), 2 iterations
SMALL = ["--map_obs_size_pix", "64", "--conv_kernel_list", "5", "3", "3",
         "--conv_stride_list", "2", "2", "2", "--conv_filter_list", "4", "4",
         "4", "--map_feat_size", "8", "--past_feat_size", "8",
         "--future_feat_size", "8", "--latent_size", "4", "--device", "cpu"]


def _cfg_without(tmp_path, name, drop):
    with open(os.path.join(REPO, "configs", name)) as f:
        lines = [l for l in f if l.split(":")[0].strip() not in drop]
    p = tmp_path / name
    p.write_text("".join(lines))
    return str(p)


def test_train_and_test_traffic_configs_on_etl(etl_root, tmp_path):
    from strive_tpu_torch.scripts import test_traffic, train_traffic

    cfg = _cfg_without(tmp_path, "train_traffic.cfg", ())
    timings = {}
    m = train_traffic.main(["-c", cfg, "--data_dir", etl_root, "--out",
                            str(tmp_path / "tr"), "--epochs", "1",
                            "--future_len", "6", "--batch_size", "16"]
                           + SMALL, timings=timings)
    assert np.isfinite(m["loss"]) and len(timings["train_steps"]) > 0
    ckpt = tmp_path / "tr" / "checkpoints" / "latest_model"
    assert (ckpt / "torch_state.pt").exists()
    cfg = _cfg_without(tmp_path, "test_traffic.cfg", ("ckpt",))
    got = test_traffic.main(["-c", cfg, "--data_dir", etl_root, "--out",
                             str(tmp_path / "te"), "--ckpt", str(ckpt),
                             "--future_len", "6", "--test_sample_num", "2",
                             "--test_sample_future_len", "6",
                             "--batch_size", "16"] + SMALL)
    assert all(np.isfinite(v) for v in got.values())
    assert {"pos_minADE", "coll_rate_env", "coll_rate_veh"} <= set(got)
    viz = sorted(os.listdir(tmp_path / "te" / "viz"))
    assert viz and all(v.startswith("sample_") for v in viz)


def test_adv_gen_rule_based_config_on_etl(etl_root, tmp_path):
    from strive_tpu_torch.scripts import adv_scenario_gen

    # cut: the separation check off (4 m pixels block most lines) and a
    # feasibility window that the 6-step future holds
    cfg = _cfg_without(tmp_path, "adv_gen_rule_based.cfg",
                       ("ckpt", "feasibility_check_sep"))
    out = tmp_path / "adv"
    stats = adv_scenario_gen.main(
        ["-c", cfg, "--data_dir", etl_root, "--out", str(out),
         "--num_iters", "1", "--num_samples", "3", "--max_scenes", "2",
         "--feasibility_thresh", "1e9", "--feasibility_vel", "0.0",
         "--feasibility_time", "1", "--seq_interval", "5",
         "--future_len", "6", "--sol_future_len", "6"] + SMALL)
    assert stats["candidates"] == 2
    folders = [f for f in os.listdir(out / "scenario_results")]
    assert folders
    for f in folders:
        names = os.listdir(out / "scenario_results" / f)
        jpgs = os.listdir(out / "viz_results" / f)
        for nm in names:
            s = nm[:-len(".json")]
            assert f"{s}_before.jpg" in jpgs and f"{s}_after.jpg" in jpgs
