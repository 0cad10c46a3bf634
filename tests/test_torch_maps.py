"""Port map store and queries against strive_tpu on the CPU.

Tolerances: the store is exact. Crops and footprint samples are exact
except samples within TIE_BAND_PX (1e-3 px) of a rounding tie, which are
counted; none may differ outside that band. ``valid`` and ``frac`` are
exact for every car whose samples all agree; ``coll_pt`` is a float32 mean
of up to 624 coordinates summed in another order, so it is held to
2e-6 x the largest coordinate.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import assert_gather_parity, n, t

from strive_tpu.maps import get_map_crop as j_crop
from strive_tpu.maps import queries as jq
from strive_tpu.maps import synthetic_map_store as j_store
from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.maps import crop_kernel, queries as tq
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.utils import build

BOUNDS = (-17.0, -38.5, 60.0, 38.5)
SMALL = (-4.0, -8.0, 12.0, 8.0)


_STORES = {}


def _stores(size_px, channels, seed):
    key = (size_px, channels, seed)
    if key not in _STORES:
        _STORES[key] = (
            j_store(num_maps=2, size_px=size_px, channels=channels, seed=seed),
            t_store(num_maps=2, size_px=size_px, channels=channels, seed=seed,
                    device="cpu"))
    return _STORES[key]


@pytest.fixture(scope="module")
def stores():
    return _stores(512, 3, 3)


@pytest.mark.parametrize("size_px,channels", [(512, 3), (600, 4), (256, 1)])
def test_store_matches(size_px, channels):
    js, ts = _stores(size_px, channels, 5)
    np.testing.assert_array_equal(n(ts.raster), n(js.raster))
    np.testing.assert_array_equal(n(ts.dx), n(js.dx))
    # the port keeps no TPU block padding: packed is exactly the real extent
    assert ts.packed.shape == (2, size_px, size_px)
    np.testing.assert_array_equal(n(ts.packed),
                                  n(js.packed)[:, :size_px, :size_px])
    np.testing.assert_array_equal(n(ts.drivable()), n(js.drivable()))


def _poses(rng, N, lo, hi):
    h = rng.uniform(-np.pi, np.pi, N)
    return np.concatenate([rng.uniform(lo, hi, (N, 2)),
                           np.stack([np.cos(h), np.sin(h)], -1)],
                          1).astype(np.float32)


def _case(rng, case):
    if case == "interior":
        return _poses(rng, 8, 20.0, 110.0), BOUNDS, 256
    if case == "edges":
        pos = _poses(rng, 8, 0.0, 128.0)
        pos[:6, :2] = [[1, 1], [127, 127], [1, 127], [-20, 50], [150, 50],
                       [64, 0.5]]
        return pos, BOUNDS, 256
    if case == "nan":
        pos = _poses(rng, 3, 20.0, 110.0)
        pos[0] = np.nan
        pos[2, 2:] = np.nan
        return pos, BOUNDS, 256
    return _poses(rng, 6, 20.0, 110.0), SMALL, 64


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", ["interior", "edges", "nan", "small"])
def test_crop_matches(stores, layout, packed, case):
    """The port's crop of its packed raster against the JAX crop of the
    packed raster (``packed``) and of the per-channel raster."""
    js, ts = stores
    rng = np.random.default_rng(["interior", "edges", "nan",
                                 "small"].index(case))
    pos, bounds, L = _case(rng, case)
    mapix = rng.integers(0, 2, len(pos)).astype(np.int32)  # both maps
    want = j_crop(js.raster, js.dx, jnp.asarray(pos), jnp.asarray(mapix),
                  bounds, L=L, W=L, packed=js.packed if packed else None,
                  layout=layout)
    got = tq.get_map_crop(ts.packed, ts.dx, t(pos), t(mapix), bounds, ts.C,
                          L=L, W=L, layout=layout)
    assert got.shape == want.shape and got.dtype == torch.float32
    ch = 1 if layout == "nchw" else 3
    per_px = (n(got) != n(want)).any(axis=ch)
    xys = tq.gen_car_coords(t(pos[:, :2]), t(pos[:, 2:]), L, L, bounds=bounds)
    xys = torch.where(torch.isnan(xys), 0.0, xys)
    d = ts.dx[t(mapix)][:, None, None, :]
    assert_gather_parity(per_px, np.zeros_like(per_px), xys,
                         d.expand_as(xys))
    # the dispatcher's CPU path is the kernel's plain version
    lo, wo = tq.crop_offsets(bounds, L, L)
    plain = crop_kernel.map_crop_plain(ts.packed, ts.dx, t(pos), t(mapix),
                                       lo, wo, 3, layout)
    assert torch.equal(plain, got)


def _cars(rng, P, lw_hi, unit_h, extent):
    x = rng.uniform(-0.1 * extent, 1.1 * extent, (P, 2))
    if unit_h:
        th = rng.uniform(0, 2 * np.pi, P)
        h = np.stack([np.cos(th), np.sin(th)], 1)
    else:
        h = rng.uniform(100, 400, (P, 2))
    lw = np.stack([rng.uniform(3, lw_hi, P), rng.uniform(1.5, 3, P)], 1)
    return (np.concatenate([x, h], 1).astype(np.float32),
            lw.astype(np.float32), rng.integers(0, 2, P).astype(np.int32))


@pytest.mark.parametrize("lw_hi,unit_h,size_px", [
    (6.0, False, 2048),   # un-normalized headings (|h| ~ 300)
    (6.0, True, 2048),
    (18.0, True, 600),    # large trucks
    (45.0, True, 2048),   # footprints beyond any TPU window
    (6.0, True, 600),
])
def test_coll_point_matches(lw_hi, unit_h, size_px):
    """Cases of tests/test_crop_kernel.py::test_footprint_kernel_randomized_sweep
    (one car count, so the JAX side compiles once per store)."""
    rng = np.random.default_rng(int(lw_hi) + size_px + unit_h)
    js, ts = _stores(size_px, 3, 11)
    cars, lw, mapix = _cars(rng, 48, lw_hi, unit_h, size_px * 0.25)
    L, W = jq.COLL_POINT_GRID
    # per-sample agreement first (exact outside the tie band) ...
    jx = jq.gen_car_coords(jnp.asarray(cars[:, :2]), jnp.asarray(cars[:, 2:]),
                           L, W, ls=jnp.asarray(lw[:, 0]),
                           ws=jnp.asarray(lw[:, 1]))
    want_pix = jq._pixel_lookup(js.drivable(), js.dx, jx, jnp.asarray(mapix))
    tx = tq.gen_car_coords(t(cars[:, :2]), t(cars[:, 2:]), L, W,
                           ls=t(lw[:, 0]), ws=t(lw[:, 1]))
    got_pix = tq._pixel_lookup(ts.drivable(), ts.dx, tx, t(mapix))
    d = ts.dx[t(mapix)][:, None, None, :].expand_as(tx)
    assert_gather_parity(got_pix, want_pix, tx, d)
    same = ~(n(got_pix) != n(want_pix)).any(axis=(1, 2))
    assert same.sum() >= len(same) - 2
    # ... then the reductions, the port's on bit 0 of its packed raster
    want = jq.get_coll_point(js.drivable(), js.dx, jnp.asarray(cars),
                             jnp.asarray(lw), jnp.asarray(mapix))
    scale = float(np.abs(n(tx)).max())
    got = tq.get_coll_point(ts.packed, ts.dx, t(cars), t(lw), t(mapix))
    np.testing.assert_array_equal(n(got[1])[same], n(want[1])[same])
    np.testing.assert_array_equal(n(got[2])[same], n(want[2])[same])
    np.testing.assert_allclose(n(got[0])[same], n(want[0])[same], rtol=0,
                               atol=2e-6 * scale)


@pytest.mark.parametrize("case", ["grid_7x5", "grid_64x40", "off_map",
                                  "on_road", "one_car"])
def test_coll_point_edge_cases_match(stores, case):
    """The footprint kernel's edge cases (grids that are no multiple of any
    thread count, cars wholly off the map or wholly on drivable ground,
    P = 1) through the port's plain path against the JAX package."""
    js, ts = stores
    cars, lw, mapix, grid = kc.coll_point_cases(512)[case]
    L, W = grid
    jx = jq.gen_car_coords(jnp.asarray(cars[:, :2]), jnp.asarray(cars[:, 2:]),
                           L, W, ls=jnp.asarray(lw[:, 0]),
                           ws=jnp.asarray(lw[:, 1]))
    want_pix = jq._pixel_lookup(js.drivable(), js.dx, jx, jnp.asarray(mapix))
    tx = tq.gen_car_coords(t(cars[:, :2]), t(cars[:, 2:]), L, W,
                           ls=t(lw[:, 0]), ws=t(lw[:, 1]))
    got_pix = tq._pixel_lookup(ts.drivable(), ts.dx, tx, t(mapix))
    d = ts.dx[t(mapix)][:, None, None, :].expand_as(tx)
    assert_gather_parity(got_pix, want_pix, tx, d)
    same = ~(n(got_pix) != n(want_pix)).any(axis=(1, 2))
    want = jq.get_coll_point(js.drivable(), js.dx, jnp.asarray(cars),
                             jnp.asarray(lw), jnp.asarray(mapix), grid=grid)
    got = tq.get_coll_point(ts.packed, ts.dx, t(cars), t(lw), t(mapix),
                            grid=grid)
    assert got[0].shape == (len(cars), 2)
    np.testing.assert_array_equal(n(got[1])[same], n(want[1])[same])
    np.testing.assert_array_equal(n(got[2])[same], n(want[2])[same])
    np.testing.assert_allclose(n(got[0])[same], n(want[0])[same], rtol=0,
                               atol=2e-6 * float(np.abs(n(tx)).max()))
    if case in ("off_map", "on_road"):  # every sample reads one kind
        assert same.all() and not n(got[1]).any()
        assert set(n(got[2]).tolist()) <= {0.0, 1.0}
    if case == "on_road":
        assert not n(got[2]).any()


def test_main_path_coll_point_args_are_the_losses(monkeypatch):
    """``kernel_cases.main_path_coll_point_args`` (the inputs chip_smoke.py
    and the card tests hold K2 to) is what the main path's
    environment-collision loss hands ``get_coll_point``."""
    from strive_tpu_torch.data.synthetic import synthetic_scene_list
    from strive_tpu_torch.geometry import interp_traj
    from strive_tpu_torch.losses import penalties
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)
    from strive_tpu_torch.scene import pad_scene_arrays

    ts = t_store(num_maps=2, size_px=256, channels=4, device="cpu")
    scene = pad_scene_arrays(synthetic_scene_list(
        num_scenes=2, num_maps=2, map_size_px=256, PT=4, FT=4,
        min_agents=3, max_agents=3), 3, 2, device="cpu")
    sn, an = (state_normalizer_for(("car", "truck")),
              att_normalizer_for(("car", "truck")))
    smean, sstd = t(sn.mean_np[:4]), t(sn.std_np[:4])
    amean, astd = t(an.mean_np), t(an.std_np)
    args = kc.main_path_coll_point_args(ts, scene, smean, sstd, amean, astd)

    seen = []

    def spy(*a, **k):
        seen.append((a, k))
        return tq.get_coll_point(*a, **k)

    monkeypatch.setattr(penalties, "get_coll_point", spy)
    fut = interp_traj(scene.future_gt[..., :4] * sstd + smean, 3)
    lw = scene.lw * astd + amean
    penalties.env_coll_penalties(fut, lw, torch.ones(lw.shape[:2], dtype=bool),
                                 scene.map_idx, ts.packed, ts.dx)
    [(given, kw)] = seen
    assert not kw and len(given) == 5
    assert given[0] is args[0] and given[1] is args[1]
    assert args[2].shape == (2 * 3 * 12, 4)
    for got, want in zip(given[2:], args[2:5]):
        assert torch.equal(got, want)
    L, W = tq.COLL_POINT_GRID
    assert torch.equal(args[5], tq.linspace(-1.0, 1.0, L, "cpu"))
    assert torch.equal(args[6], tq.linspace(-1.0, 1.0, W, "cpu"))
    assert args[7] == 0


def test_on_layer_and_line_layer(stores):
    js, ts = stores
    rng = np.random.default_rng(9)
    cars, lw, mapix = _cars(rng, 32, 6.0, True, 128.0)
    np.testing.assert_array_equal(
        n(tq.check_on_layer(ts.drivable(), ts.dx, t(cars), t(lw), t(mapix))),
        n(jq.check_on_layer(js.drivable(), js.dx, jnp.asarray(cars),
                            jnp.asarray(lw), jnp.asarray(mapix))))
    start = rng.uniform(0, 128, (32, 2)).astype(np.float32)
    end = rng.uniform(0, 128, (32, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tq.check_line_layer(ts.drivable(), ts.dx, t(start), t(end),
                              t(mapix))),
        n(jq.check_line_layer(js.drivable(), js.dx, jnp.asarray(start),
                              jnp.asarray(end), jnp.asarray(mapix))))


# the widest raster of the nuScenes-extent store (queenstown's 3687.1 m)
NUSC_W = 14748


@pytest.mark.parametrize("case", ["ties", "edges"])
def test_crop_tie_cases_put_samples_on_ties(case):
    """K1's tie cases really sample on rounding ties: under the plain
    version, many quotients g / dx lie within 1 ulp of a half-integer."""
    raster = kc.crop_edge_raster("cpu")
    pos, mapix, bounds, L, Wc, _ = kc.crop_edge_cases()[case]
    lo, wo = tq.crop_offsets(bounds, L, Wc)
    pos = torch.from_numpy(pos)
    xys = tq.rotate_grid(lo[None, :, None], wo[None, None, :], pos[:, :2],
                         pos[:, 2:4])
    q = xys / raster[1][torch.from_numpy(mapix)][:, None, None, :]
    off = (q - torch.floor(q) - 0.5).abs()
    ulp = torch.nextafter(q.abs(), torch.tensor(np.inf)) - q.abs()
    assert int((off <= ulp).sum()) > q.numel() // 2


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("case", ["ties", "edges", "headings", "bad_poses"])
def test_crop_edge_cases_match_jax(case, layout):
    """The port's plain crop, K1's oracle, equals strive_tpu's crop bit for
    bit in all 8 channels on K1's edge cases: on exact ties (every op of
    the sample exact) both round half to even, and zero, tiny, huge and
    infinite headings and NaN or infinite positions go where strive_tpu's
    crop sends them."""
    packed, dx = kc.crop_edge_raster("cpu")
    pos, mapix, bounds, L, Wc, _ = kc.crop_edge_cases()[case]
    raster = (packed[:, None] >> torch.arange(8, dtype=torch.uint8)[
        None, :, None, None]) & 1
    want = j_crop(jnp.asarray(n(raster)), jnp.asarray(n(dx)),
                  jnp.asarray(pos), jnp.asarray(mapix.astype(np.int32)),
                  bounds, L=L, W=Wc, packed=jnp.asarray(n(packed)),
                  layout=layout)
    lo, wo = tq.crop_offsets(bounds, L, Wc)
    got = crop_kernel.map_crop_plain(packed, dx, t(pos), t(mapix), lo, wo, 8,
                                     layout)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("d", [0.25, 0.1])
def test_k1_quotient_model_matches_ieee_division(d):
    """K1's division (a product by RN(1/dx) and residual corrections,
    modelled in numpy) rounds to the same pixel as the IEEE quotient, and
    makes the same inside decision, on every float32 g within 64 ulp of
    each half-integer tie over [-2, W + 1] pixels of the widest nuScenes
    raster, and on 2^20 random g there."""
    g = kc.quotient_sweep_g(d, NUSC_W)
    want = np.rint(g / np.float32(d))
    got = kc.k1_rounded_quotient(g, d)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((got >= 0) & (got < NUSC_W),
                                  (want >= 0) & (want < NUSC_W))
    if d == 0.1:  # the sweep tells a bare product from the quotient
        naive = np.rint(g * (np.float32(1) / np.float32(d)))
        assert (naive != want).sum() > 1000


def test_k1_quotient_model_is_the_kernels():
    """The model takes as many residual corrections as crop.cu does, and
    its fused multiply-add rounds once."""
    src = (build.CSRC / "crop.cu").read_text()
    assert (f"constexpr int kQuotientSteps = {kc.K1_QUOTIENT_STEPS};"
            in src)
    one = np.float32(1 + 2 ** -12)
    # (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24: two roundings would lose 2^-24
    assert kc.fma32(one, one, np.float32(-1)) == np.float32(2 ** -11
                                                            + 2 ** -24)


def test_wrappers_refuse_cpu_tensors(stores):
    """No fallback inside a wrapper: it takes CUDA tensors or raises."""
    _, ts = stores
    pos = t(_poses(np.random.default_rng(0), 2, 20.0, 110.0))
    mapix = torch.zeros(2, dtype=torch.long)
    lo, wo = tq.crop_offsets(BOUNDS, 256, 256)
    with pytest.raises(ValueError, match="CUDA"):
        crop_kernel.map_crop(ts.packed, ts.dx, pos, mapix, lo, wo, 3)
    with pytest.raises(ValueError, match="CUDA"):
        crop_kernel.footprint_coll_point(
            ts.packed, ts.dx, pos, torch.ones(2, 2), mapix,
            tq.linspace(-1.0, 1.0, 39), tq.linspace(-1.0, 1.0, 16))
