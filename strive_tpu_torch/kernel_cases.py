"""The inputs that hold K1 ``map_crop``, K2 ``footprint_coll_point``, K4b
``window_take``, K5c ``window_sums`` and K5d ``onehot_rows`` to their plain
versions, shared by
``chip_smoke.py``, ``tools/kernel_variants.py`` and the tests: the main
path's K2 inputs, K1 and K2 at the shapes the scenario-generation pipeline
gives them (prior sampling, the solution loss) and the refine and training
paths give them (a decode step of B scenes, the refine loss, the training
loss's ego prior), K1 and K2 on a store of nuScenes' four map extents
(:func:`nusc_store`, :func:`nusc_pose_cases`: per-map ``dx`` that is not
0.25, maps of unequal size zero-padded to the largest, Singapore
flipped), the kernels' edge cases, the check of K2's contract
(:func:`coll_point_error`), and K5d's blocks modelled in numpy
(:func:`onehot_blocks`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry import interp_traj
from .maps import crop_kernel, queries
from .maps.store import DEFAULT_BOUNDS, NUSC_MAP_SIZES


def main_path_coll_point_args(store, scene, state_mean, state_std, att_mean,
                              att_std):
    """K2's arguments as the main path's environment-collision loss gives
    them (``losses/penalties.py``): every agent's future poses, un-normalized
    and interpolated x3, its length and width, its map, and the 39x16 grid.

    :param scene: a ``pad_scene_arrays`` batch on ``store``'s device
    :param state_mean, state_std: (4,) tensors of the pose normalizer
    :param att_mean, att_std: (2,) tensors of the length/width normalizer
    """
    fut = interp_traj(scene.future_gt[..., :4] * state_std + state_mean, 3)
    B, NA, T3 = fut.shape[:3]
    lw = scene.lw * att_std + att_mean
    lw = lw[:, :, None, :].expand(B, NA, T3, 2).reshape(-1, 2).contiguous()
    mapix = scene.map_idx[:, None, None].expand(B, NA, T3).reshape(-1)
    L, W = queries.COLL_POINT_GRID
    return (store.packed, store.dx, fut.reshape(-1, 4).contiguous(), lw,
            mapix.contiguous(), queries.linspace(-1.0, 1.0, L, fut.device),
            queries.linspace(-1.0, 1.0, W, fut.device), 0)


def main_path_k2(device):
    """``(store, args)``: K2's inputs at the main path's shape in
    ``chip_smoke.py``, B=4 scenes x NA=8 agents x 36 interpolated poses
    (1152 cars) on 2 synthetic maps of 2048 px x 4 channels at 4 px/m."""
    store, scene, stats = _full_width_scene(device, 12, NA=8)
    return store, main_path_coll_point_args(store, scene, *stats)


def main_path_crop_args(store, scene, state_mean, state_std):
    """K1's arguments as the main path's first crop gives them: every
    agent's last past pose, un-normalized, its map, 256 px with the
    default bounds, all of the store's channels, NHWC.

    :param scene: a ``pad_scene_arrays`` batch on ``store``'s device
    :param state_mean, state_std: (4,) tensors of the pose normalizer
    """
    pos = (scene.past[:, :, -1, :4] * state_std + state_mean).reshape(-1, 4)
    mapix = scene.map_idx.repeat_interleave(scene.past.shape[1])
    lo, wo = queries.crop_offsets(DEFAULT_BOUNDS, 256, 256, pos.device)
    return (store.packed, store.dx, pos.contiguous(), mapix.contiguous(), lo,
            wo, store.C, "nhwc")


def main_path_k1(device):
    """K1's arguments at the main path's shape in ``chip_smoke.py``, B=4
    scenes x NA=8 agents (32 poses) on 2 synthetic maps of 2048 px x 4
    channels at 4 px/m."""
    store, scene, (smean, sstd, _, _) = _full_width_scene(device, 12, NA=8)
    return main_path_crop_args(store, scene, smean, sstd)


def _full_width_scene(device, FT, NA=16, B=4):
    """The full-width store (2 maps x 2048 px x 4 channels at 4 px/m) and B
    synthetic scenes of NA agents on it, with the pose and size
    normalizers' statistics as tensors."""
    from .data.synthetic import synthetic_scene_list
    from .maps.store import synthetic_map_store
    from .normalize import att_normalizer_for, state_normalizer_for
    from .scene import pad_scene_arrays

    cats = ("car", "truck")
    store = synthetic_map_store(num_maps=2, size_px=2048, channels=4,
                                pix_per_m=4.0, device=device)
    scene = pad_scene_arrays(synthetic_scene_list(
        num_scenes=B, num_maps=2, map_size_px=2048, PT=4, FT=FT,
        min_agents=NA, max_agents=NA), NA, 2, device=device)
    sn, an = state_normalizer_for(cats), att_normalizer_for(cats)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return store, scene, (t(sn.mean_np[:4]), t(sn.std_np[:4]),
                          t(an.mean_np), t(an.std_np))


def sampling_crop_args(device, NS=20, NA=16, L=256, seed=0):
    """K1's arguments at prior sampling's shape: one rollout step of
    ``sample_batched`` crops 1 scene x NS samples x NA agents (320 poses at
    the production config) in one launch, 256 px with the default bounds,
    on the full-width store. The poses are a synthetic scene's futures,
    one step a sample, moved by up to a few meters."""
    store, scene, (smean, sstd, _, _) = _full_width_scene(device, 12, NA, 1)
    rng = np.random.default_rng(seed)
    fut = scene.future_gt[0, :, :, :4] * sstd + smean          # (NA, FT, 4)
    steps = torch.as_tensor(np.arange(NS) % fut.shape[1], device=device)
    pos = fut[:, steps].transpose(0, 1).reshape(NS * NA, 4).clone()
    pos[:, :2] += torch.as_tensor(rng.normal(0, 2.0, (NS * NA, 2)),
                                  dtype=torch.float32, device=device)
    mapix = scene.map_idx.repeat_interleave(NS * NA)
    lo, wo = queries.crop_offsets(DEFAULT_BOUNDS, L, L, device)
    return (store.packed, store.dx, pos.contiguous(), mapix.contiguous(), lo,
            wo, store.C, "nhwc")


def solution_k2(device, B=4, sol_future_len=16):
    """``(store, args)``: K2's inputs at the solution loss's shape
    (``avoid_coll_loss`` with ``single_veh_idx=0``): one car a scene, B
    scenes, its ``sol_future_len`` poses interpolated x3 (192 cars at the
    production config), on the full-width store."""
    store, scene, stats = _full_width_scene(device, sol_future_len, 16, B)
    ego = dataclasses.replace(scene, **{
        k: getattr(scene, k)[:, :1]
        for k in ("past", "past_vis", "sem", "lw", "mask", "future",
                  "future_vis", "past_gt", "future_gt")})
    return store, main_path_coll_point_args(store, ego, *stats)


def decode_crop_args(device, B, NA=16, L=256):
    """K1's arguments at one decode step of B scenes x NA agents (every
    pose of the step in one launch), 256 px with the default bounds, on
    the full-width store: training's posterior and prior decodes (B=8, 128
    poses at ``configs/train_synth_prod.cfg``) and refine's (B=10, 160
    poses at ``configs/refine_traffic_optim.cfg``). The poses are the
    scenes' first future step."""
    store, scene, (smean, sstd, _, _) = _full_width_scene(device, 12, NA, B)
    pos = (scene.future_gt[:, :, 0, :4] * sstd + smean).reshape(B * NA, 4)
    mapix = scene.map_idx.repeat_interleave(NA)
    lo, wo = queries.crop_offsets(DEFAULT_BOUNDS, L, L, device)
    return (store.packed, store.dx, pos.contiguous(), mapix.contiguous(), lo,
            wo, store.C, "nhwc")


def refine_k2(device, B=10, NA=16, samp_future_len=16):
    """``(store, args)``: K2's inputs at the refine loss's shape
    (``avoid_coll_loss`` over every agent): B scenes x NA agents x their
    ``samp_future_len`` poses interpolated x3 (7,680 cars at
    ``configs/refine_traffic_optim.cfg``), on the full-width store."""
    store, scene, stats = _full_width_scene(device, samp_future_len, NA, B)
    return store, main_path_coll_point_args(store, scene, *stats)


def shard_args(device, ranks, B=4, NA=16, FT=12):
    """K1's and K2's arguments at one rank's rows of a batch of B scenes x
    NA agents split over ``ranks`` (``adv_scenario_gen --mesh_devices``;
    B=4 x NA=16 at ``configs/adv_gen_synth_hc_prod.cfg``): a decode step of
    B / ranks x NA poses, and the adversarial loss's B / ranks x NA x 3 FT
    interpolated cars. Over 2 ranks these are the main path's 32 poses and
    1,152 cars; over 4, 16 poses and 576 cars."""
    b = B // ranks
    return decode_crop_args(device, b, NA), refine_k2(device, b, NA, FT)[1]


def training_k2(device, B=8, FT=12):
    """``(store, args)``: K2's inputs at the training loss's shape (the
    ego-only environment prior of ``traffic_model_loss``, no
    interpolation): the ego of B scenes at its FT prior-sample poses (96
    cars at ``configs/train_synth_prod.cfg``), on the full-width store."""
    store, scene, (smean, sstd, amean, astd) = _full_width_scene(device, FT,
                                                                 16, B)
    ego = (scene.future_gt[:, 0, :, :4] * sstd + smean).reshape(B * FT, 4)
    lw = (scene.lw[:, 0] * astd + amean)[:, None].expand(B, FT, 2)
    mapix = scene.map_idx.repeat_interleave(FT)
    L, W = queries.COLL_POINT_GRID
    return store, (store.packed, store.dx, ego.contiguous(),
                   lw.reshape(-1, 2).contiguous(), mapix.contiguous(),
                   queries.linspace(-1.0, 1.0, L, device),
                   queries.linspace(-1.0, 1.0, W, device), 0)


def nusc_store(device, pix_per_m=4.0):
    """The four nuScenes maps at their extents (``NUSC_MAP_SIZES``) with the
    synthetic content of ``data.synthetic_etl``, rasterized as the ETL does
    (``rasterize_maps``: 4 channels, Singapore flipped, each map's ``dx`` =
    extent / round(extent x pix_per_m), zero-padded to the largest): at 4
    px/m, 4 x 4 x 14,748 x 12,914 uint8 (3.05 GB) and a 0.76 GB packed
    raster on ``device``."""
    from .data.synthetic_etl import SPACING_M, SyntheticNuscMap
    from .maps.store import DEFAULT_LAYERS, MapStore
    from .scripts.preprocess_nuscenes import rasterize_maps

    maps = {m: SyntheticNuscMap(NUSC_MAP_SIZES[m], SPACING_M)
            for m in NUSC_MAP_SIZES}
    raster, dx, names = rasterize_maps(maps, list(DEFAULT_LAYERS), pix_per_m)
    return MapStore.from_raster(torch.from_numpy(raster).to(device),
                                torch.from_numpy(dx).to(device), names)


def nusc_pose_cases(store, per=8, seed=0):
    """Poses on every map of a :func:`nusc_store`-like store, as numpy:
    ``{kind: (pos (P, 4) f32, mapix (P,) i64)}`` with random headings.

    - ``interior``: inside the map's true extent;
    - ``edge``: within 3 m of the map's true right or top edge, either
      side of it (for the largest map, of the stacked raster's edge);
    - ``padding``: beyond the true extent of a map smaller than the
      stack, inside the stacked raster (zero bytes there);
    - ``off``: outside the stacked raster on every side.
    Map m holds extent / ``dx[m]`` pixels along each axis (``dx[m]`` =
    (H, W) meters per pixel); world x is divided by ``dx[m, 0]`` and y by
    ``dx[m, 1]``, so its true edge is at those pixel counts times them.
    """
    rng = np.random.default_rng(seed)
    dx = store.dx.detach().cpu().numpy().astype(np.float64)
    _, H, W = store.packed.shape
    out = {k: ([], []) for k in ("interior", "edge", "padding", "off")}

    def add(kind, m, xy):
        out[kind][0].append(xy)
        out[kind][1].append(np.full(len(xy), m))

    for m, name in enumerate(store.map_names):
        h_px, w_px = np.round(np.array(NUSC_MAP_SIZES[name]) / dx[m])
        xe, ye = w_px * dx[m, 0], h_px * dx[m, 1]      # the map's true edge
        xs, ys = W * dx[m, 0], H * dx[m, 1]            # the stack's edge
        u = rng.uniform(0.05, 0.95, (per, 2))
        add("interior", m, u * [xe, ye])
        near = rng.uniform(-3.0, 3.0, per)
        edge = np.stack([xe + near, u[:, 1] * ye], 1)
        edge[per // 2:] = np.stack([u[per // 2:, 0] * xe,
                                    ye + near[per // 2:]], 1)
        add("edge", m, edge)
        if xs - xe > 10.0:
            add("padding", m, np.stack([rng.uniform(xe + 5, xs - 5, per),
                                        u[:, 1] * ye], 1))
        if ys - ye > 10.0:
            add("padding", m, np.stack([u[:, 0] * xe,
                                        rng.uniform(ye + 5, ys - 5, per)], 1))
        off = np.stack([rng.uniform(-50, xs + 50, per),
                        rng.uniform(-50, ys + 50, per)], 1)
        side = np.arange(per) % 4
        off[side == 0, 0] = -rng.uniform(5, 50, (side == 0).sum())
        off[side == 1, 0] = xs + rng.uniform(5, 50, (side == 1).sum())
        off[side == 2, 1] = -rng.uniform(5, 50, (side == 2).sum())
        off[side == 3, 1] = ys + rng.uniform(5, 50, (side == 3).sum())
        add("off", m, off)
    cases = {}
    for kind, (xys, maps) in out.items():
        xy = np.concatenate(xys)
        th = rng.uniform(-np.pi, np.pi, len(xy))
        pos = np.concatenate([xy, np.stack([np.cos(th), np.sin(th)], 1)], 1)
        cases[kind] = (pos.astype(np.float32),
                       np.concatenate(maps).astype(np.int64))
    return cases


def nusc_kernel_args(store, cases, L=256, seed=0):
    """K1's arguments (both layouts, 4 channels, ``L`` px with the default
    bounds) and K2's (the 39x16 grid, bit 0, car sizes from 3 to 12 m)
    over every pose of :func:`nusc_pose_cases`:
    ``(k1_nhwc, k1_nchw, k2)``."""
    dev = store.packed.device
    pos = torch.from_numpy(np.concatenate([c[0] for c in cases.values()]))
    mapix = torch.from_numpy(np.concatenate([c[1] for c in cases.values()]))
    pos, mapix = pos.to(dev), mapix.to(dev)
    lo, wo = queries.crop_offsets(DEFAULT_BOUNDS, L, L, dev)
    k1 = (store.packed, store.dx, pos, mapix, lo, wo, 4)
    rng = np.random.default_rng(seed)
    P = pos.shape[0]
    lw = torch.from_numpy(np.stack([rng.uniform(3, 12, P),
                                    rng.uniform(1.5, 3, P)], 1)
                          .astype(np.float32)).to(dev)
    gl, gw = queries.COLL_POINT_GRID
    k2 = (store.packed, store.dx, pos, lw, mapix,
          queries.linspace(-1.0, 1.0, gl, dev),
          queries.linspace(-1.0, 1.0, gw, dev), 0)
    return (*k1, "nhwc"), (*k1, "nchw"), k2


# K1's residual corrections of the quotient (``kQuotientSteps`` in crop.cu)
K1_QUOTIENT_STEPS = 2


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as numpy arrays (numpy has no
    fma): the product is exact in float64, the float64 sum is rounded to
    odd (a TwoSum error term says which way it was inexact), and a
    round-to-odd value of 53 bits rounds to float32 as the exact sum
    would."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(np.int64)
    inexact = (err != 0) & ((bits & 1) == 0) & np.isfinite(s)
    # a step of one float64 ulp toward the exact sum
    bits = np.where(inexact, bits + np.where((err > 0) == (s > 0), 1, -1),
                    bits)
    return bits.view(np.float64).astype(np.float32)


def k1_rounded_quotient(g, d):
    """A numpy model of K1's ``rounded_quotient<true>`` (crop.cu): ``g``
    times ``r = RN(1/d)``, then ``K1_QUOTIENT_STEPS`` corrections ``v +
    RN(g - v*d)*r`` in fused multiply-adds, then ``rint``."""
    g = np.asarray(g, np.float32)
    d = np.float32(d)
    r = np.float32(1) / d
    v = g * r
    for _ in range(K1_QUOTIENT_STEPS):
        v = fma32(fma32(-v, d, g), r, v)
    return np.rint(v)


def quotient_sweep_g(d, W, ulps=64, n_random=2 ** 20, seed=0):
    """The float32 ``g`` of the CPU quotient sweep for ``d``: every float32
    within ``ulps`` of ``(k + 1/2) * d`` for each half-integer tie ``k +
    1/2`` over ``[-2, W + 1]`` pixels, and ``n_random`` uniform ``g`` of
    that range."""
    d = np.float32(d)
    tie = (np.arange(-2, W + 1) + 0.5) * np.float64(d)
    g0 = tie.astype(np.float32)
    step = np.arange(-ulps, ulps + 1)
    # float32 bits are ordered by magnitude: step away from zero on both sides
    bits = g0.view(np.int32).astype(np.int64)[:, None] + step
    near = bits.astype(np.int32).view(np.float32).reshape(-1)
    rng = np.random.default_rng(seed)
    far = rng.uniform(-2 * float(d), (W + 1) * float(d), n_random)
    return np.concatenate([near, far.astype(np.float32)])


def nusc_dx(pix_per_m=4.0):
    """(4, 2) float32: the ``dx`` of :func:`nusc_store`'s maps, as the ETL
    computes them (extent / round(extent x pix_per_m)), without the
    raster."""
    size = np.array([NUSC_MAP_SIZES[m] for m in NUSC_MAP_SIZES])
    return (size / np.round(size * pix_per_m)).astype(np.float32)


def crop_edge_raster(device, seed=0):
    """``(packed, dx)``: K1's edge-case raster, 3 maps of 300 x 200 random
    bytes (every bit of every pixel drawn alone, so a sample that reads a
    neighbour of its pixel changes the crop in most channels), with
    dx = (0.25, 0.25), (0.5, 0.25) and (0.1, 0.1) meters a pixel."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (3, 300, 200)).astype(np.uint8)
    dx = np.array([[0.25, 0.25], [0.5, 0.25], [0.1, 0.1]], np.float32)
    return torch.from_numpy(packed).to(device), torch.from_numpy(dx).to(device)


# the bounds of K1's tie cases: offsets of 0.25 m at L = 65, exact in float32
TIE_BOUNDS = (-8.0, -8.0, 8.0, 8.0)


def crop_edge_cases(seed=0):
    """K1's edge cases on :func:`crop_edge_raster` (H = 300, W = 200), as
    numpy: ``{name: (pos (N, 4) f32, mapix (N,) i64, bounds, L, Wc, C)}``.

    - ``ties``: axis-aligned headings, some not unit ((1, 0), (0, 1),
      (-1, 0), (0, -1), (2, 0), (0, -3)), at x, y = (k + 1/2) dx on maps 0
      and 1 with :data:`TIE_BOUNDS`: every sample's quotient is a
      half-integer, which rounds to even;
    - ``edges``: the same headings at the map's corners, (k + 1/2) dx
      from them: rounded coordinates -0, -1, W - 1 and W (H - 1, H);
    - ``headings``: headings of length 0 (both signs of zero), 1e-20, 300
      and 1e20, and unit ones, on all three maps;
    - ``bad_poses``: NaN positions, NaN headings and infinite positions
      (map indices stay in range: out of range, K1 clamps them, while
      strive_tpu's crop reads other maps' bytes, so no oracle holds them);
    - ``C{1,3,5,8}``: random poses on and off the maps with 1, 3, 5 and 8
      channels (the others take 4);
    - ``rows_300x37``, ``rows_514x5``, ``rows_1x3``: crops wider than a
      block (300 px; 514, even, for bf16's pixel pairs), and one column;
    - ``many_small``: 70,000 poses (over 65,535) of 8 x 8 crops.
    """
    rng = np.random.default_rng(seed)
    H, W = 300, 200
    dx = np.array([[0.25, 0.25], [0.5, 0.25], [0.1, 0.1]])
    heads = np.array([[1, 0], [0, 1], [-1, 0], [0, -1], [2, 0], [0, -3]],
                     np.float64)

    def poses(xy, h):
        return np.concatenate([xy, h], 1).astype(np.float32)

    def random(N, maps=3):
        m = rng.integers(0, maps, N)
        xy = rng.uniform(-0.2, 1.2, (N, 2)) * [W, H] * dx[m]
        th = rng.uniform(-np.pi, np.pi, N)
        return poses(xy, np.stack([np.cos(th), np.sin(th)], 1)), m

    cases = {}
    k = rng.integers(20, 180, (2 * len(heads), 2))
    m = np.repeat([0, 1], len(heads))
    xy = (k + 0.5) * dx[m]
    cases["ties"] = (poses(xy, np.tile(heads, (2, 1))), m, TIE_BOUNDS, 65,
                     65, 4)
    corners = np.array([[0, 0], [W, 0], [0, H], [W, H]], np.float64)
    xy = np.concatenate([corners * dx[mm] + (s + 0.5) * dx[mm]
                         for mm in (0, 1) for s in (-1, 0)])
    m = np.repeat([0, 0, 1, 1], 4)
    h = np.repeat(heads[:4], 4, axis=0)
    cases["edges"] = (poses(xy, h), m, TIE_BOUNDS, 65, 65, 4)
    lens = np.array([0.0, -0.0, 1e-20, 300.0, 1e20, 1.0])
    th = rng.uniform(-np.pi, np.pi, len(lens))
    h = np.stack([np.cos(th), np.sin(th)], 1) * lens[:, None]
    h[1] = [-0.0, -0.0]
    m = np.arange(len(lens)) % 3
    xy = rng.uniform(0.1, 0.9, (len(lens), 2)) * [W, H] * dx[m]
    cases["headings"] = (poses(xy, h), m, (-17.0, -38.5, 60.0, 38.5), 64, 64,
                         4)
    pos, m = random(8)
    pos[0] = np.nan
    pos[1, :2] = np.nan
    pos[2, 2:] = np.nan
    pos[3, :2] = [np.inf, -np.inf]
    pos[4, 2:] = [np.inf, 0.0]
    cases["bad_poses"] = (pos, m.astype(np.int64), (-17.0, -38.5, 60.0, 38.5),
                          32, 32, 4)
    for C in (1, 3, 5, 8):
        pos, m = random(6)
        cases[f"C{C}"] = (pos, m, (-17.0, -38.5, 60.0, 38.5), 40, 40, C)
    for L, Wc in ((37, 300), (5, 514), (3, 1)):
        pos, m = random(4)
        cases[f"rows_{Wc}x{L}"] = (pos, m, (-10.0, -20.0, 10.0, 20.0), L, Wc,
                                   4)
    pos, m = random(70000)
    cases["many_small"] = (pos, m, (-2.0, -2.0, 2.0, 2.0), 8, 8, 4)
    return {k: (p, np.asarray(mm, np.int64), b, L, Wc, C)
            for k, (p, mm, b, L, Wc, C) in cases.items()}


def crop_edge_args(raster, case, layout, device):
    """``map_crop``'s arguments for one :func:`crop_edge_cases` entry on
    ``raster`` = :func:`crop_edge_raster`'s ``(packed, dx)``."""
    pos, mapix, bounds, L, Wc, C = case
    lo, wo = queries.crop_offsets(bounds, L, Wc, device)
    return (*raster, torch.from_numpy(pos).to(device),
            torch.from_numpy(mapix).to(device), lo, wo, C, layout)


def coll_point_cases(size_px, pix_per_m=4.0, seed=0):
    """K2's edge cases on a ``synthetic_map_store`` of 2 maps of ``size_px``
    (whose centre square is drivable), as numpy:
    ``{name: (cars (P, 4) f32, lw (P, 2) f32, mapix (P,) i64, grid)}``.

    - ``grid_7x5``, ``grid_64x40``: 24 cars over the maps and past their
      edges, on grids that are no multiple of any thread count;
    - ``off_map``: 2 cars wholly off the map (every sample reads pixel
      (0, 0));
    - ``on_road``: 2 cars wholly on drivable ground (``valid`` false,
      ``frac`` 0);
    - ``one_car``: P = 1.
    """
    rng = np.random.default_rng(seed)
    extent = size_px / pix_per_m

    def cars(xy, grid):
        P = len(xy)
        th = rng.uniform(-np.pi, np.pi, P)
        pose = np.concatenate([xy, np.stack([np.cos(th), np.sin(th)], 1)], 1)
        lw = np.stack([rng.uniform(3, 10, P), rng.uniform(1.5, 3, P)], 1)
        return (pose.astype(np.float32), lw.astype(np.float32),
                rng.integers(0, 2, P).astype(np.int64), grid)

    def spread(P):
        return rng.uniform(-0.1 * extent, 1.1 * extent, (P, 2))

    grid = queries.COLL_POINT_GRID
    return {
        "grid_7x5": cars(spread(24), (7, 5)),
        "grid_64x40": cars(spread(24), (64, 40)),
        "off_map": cars(np.array([[-10.0, -10.0], [11.0, 0.5]]) * extent,
                        grid),
        "on_road": cars(extent * (0.5 + rng.uniform(-0.1, 0.1, (2, 2))),
                        grid),
        "one_car": cars(spread(1), grid),
    }


def coll_point_args(store, case, device):
    """``footprint_coll_point``'s arguments for one ``coll_point_cases``
    entry on ``store`` (bit 0, the drivable layer)."""
    cars, lw, mapix, (L, W) = case
    return (store.packed, store.dx, torch.from_numpy(cars).to(device),
            torch.from_numpy(lw).to(device),
            torch.from_numpy(mapix).to(device),
            queries.linspace(-1.0, 1.0, L, device),
            queries.linspace(-1.0, 1.0, W, device), 0)


def coll_point_error(args):
    """Run K2 and its plain version on ``args``; raise unless ``valid`` and
    ``frac`` are equal and ``coll_pt`` within 2e-6 x the largest
    coordinate. :return: coll_pt's largest difference"""
    got = crop_kernel.footprint_coll_point(*args)
    want = crop_kernel.footprint_coll_point_plain(*args)
    if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
        raise AssertionError("footprint valid/frac differ from plain")
    cars, lw = args[2], args[3]
    scale = float(cars[:, :2].abs().amax()
                  + lw.amax() * cars[:, 2:].abs().amax())
    err = float((got[0] - want[0]).abs().amax())
    if err > 2e-6 * scale:
        raise AssertionError(f"coll_pt differs by {err} (tol {2e-6 * scale})")
    return err


def take_cases(seed=0):
    """K4b's edge cases as numpy, ``{name: (wins (N, S) i32, idx (N, Q)
    i32)}``, window values in [0, 256) so that uint8 holds them too: rows
    shorter than a vector and rows that start off the vector grid (N = 1,
    Q in {1, 3, 5, 1001}; N = 5, Q = 1001), indices at both ends of [0, S)
    and far outside it, and N = 70,000 > 65,535 rows of Q = 3."""
    rng = np.random.default_rng(seed)
    out = {}
    for N, Q in ((1, 1), (1, 3), (1, 5), (1, 1001), (5, 1001), (70000, 3)):
        S = 7 if N > 65535 else 1000
        wins = rng.integers(0, 256, (N, S)).astype(np.int32)
        idx = rng.integers(-3, S + 3, (N, Q))
        wild = rng.random((N, Q)) < 0.25
        idx[wild] = rng.integers(-2 ** 31, 2 ** 31, int(wild.sum()))
        ends = [-1, 0, S - 1, S][:idx.size]
        idx.reshape(-1)[:len(ends)] = ends
        out[f"N{N}_Q{Q}"] = (wins, idx.astype(np.int32))
    return out


def _wide_int32(rng, shape):
    """int32 values of 2^28 to 2^31, the first half of the rows negative:
    window sums wrap past 2^31 both ways."""
    x = rng.integers(2 ** 28, 2 ** 31, shape).astype(np.int32)
    x[:shape[0] // 2] *= -1
    return x


def sums_cases(seed=0):
    """K5c's edge cases as numpy, ``{name: (src (R, C) uint8 or int32,
    row0 (G, K) i32, col0 (G, K) i32, sign (K,) i32, WR, WC)}``, one for
    each of the kernel's paths and edges:

    - ``uint8``, ``int32``: 37 outputs x 3 windows of 64x192 with signs
      (1, -1, 3) and starts that clamp or wrap; the int32 sums wrap past
      2^31 both ways;
    - ``res_{u8,i32}_WC{n}``: 16 windows of each WC in {1, 3, 15, 16, 17,
      61, 192, C} whose first columns take every residue 0-15, on rows of
      a multiple of 16 bytes (16-byte vectors);
    - ``WR1``, ``WR3``, ``WRR``: one row, three rows and every row; on C =
      1000 uint8 and C = 333 int32 (rows of a multiple of 4 bytes only:
      4-byte words);
    - ``G1_K5``: one output of five windows with signs (1, -1, 2, -3, 7) on
      C = 1001 uint8 (rows of neither: single bytes);
    - ``wrap_C333``: int32 sums that wrap both ways on the word path;
    - ``G4_wide``: 4 outputs of 2 windows, a wide block each on a card of
      4 SMs or more; ``G300``: 300 outputs, more than an H100 has SMs, in
      the narrow blocks; ``K0``: 3 outputs of no window (0 each).
    """
    rng = np.random.default_rng(seed)

    def starts(G, K, R, C):
        return (rng.integers(-R, 2 * R, (G, K)).astype(np.int32),
                rng.integers(-C, 2 * C, (G, K)).astype(np.int32))

    def u8(R, C):
        return rng.integers(0, 256, (R, C)).astype(np.uint8)

    out = {}
    sign3 = np.array([1, -1, 3], np.int32)
    for name, src in (("uint8", u8(300, 1000)),
                      ("int32", _wide_int32(rng, (256, 640)))):
        R, C = src.shape
        row0, col0 = starts(37, 3, R, C)
        row0[0], col0[0] = [R - 64, 0, R // 2 - 32], [C - 192, 1, 5]
        out[name] = (src, row0, col0, sign3, 64, 192)
    for tag, src in (("u8", u8(80, 1024)),
                     ("i32", rng.integers(-2 ** 31, 2 ** 31, (80, 640))
                      .astype(np.int32))):
        R, C = src.shape
        for WC in (1, 3, 15, 16, 17, 61, 192, C):
            row0 = rng.integers(0, R - 7, (16, 1)).astype(np.int32)
            col0 = (16 * rng.integers(0, (C - WC) // 16 + 1, 16)
                    + np.arange(16))[:, None].astype(np.int32)
            out[f"res_{tag}_WC{WC}"] = (src, row0, col0,
                                        np.ones(1, np.int32), 7, WC)
    sign2 = np.array([2, -1], np.int32)
    for src in (u8(120, 1000), _wide_int32(rng, (120, 333))):
        R, C = src.shape
        tag = "u8" if src.dtype == np.uint8 else "i32"
        for WR, G in ((1, 6), (3, 2), (R, 3)):
            row0, col0 = starts(G, 2, R, C)
            out[f"WR{'R' if WR == R else WR}_{tag}"] = (src, row0, col0,
                                                       sign2, WR, 150)
    src = u8(90, 1001)
    row0, col0 = starts(1, 5, 90, 1001)
    out["G1_K5"] = (src, row0, col0, np.array([1, -1, 2, -3, 7], np.int32),
                    40, 100)
    src = _wide_int32(rng, (200, 333))
    row0, col0 = starts(5, 2, 200, 333)
    out["wrap_C333"] = (src, row0, col0, np.array([1, -1], np.int32), 100,
                        300)
    src = u8(256, 1024)
    row0, col0 = starts(4, 2, 256, 1024)
    out["G4_wide"] = (src, row0, col0, np.array([1, -1], np.int32), 64,
                         192)
    row0, col0 = starts(300, 1, 256, 1024)
    out["G300"] = (src, row0, col0, np.ones(1, np.int32), 16, 61)
    none = np.zeros((3, 0), np.int32)
    out["K0"] = (src, none, none, np.zeros(0, np.int32), 16, 61)
    return out


def sums_args(case, device):
    """``window_sums``' arguments for one ``sums_cases`` entry."""
    src, row0, col0, sign, WR, WC = case
    return (torch.from_numpy(src).to(device), torch.from_numpy(row0).to(device),
            torch.from_numpy(col0).to(device),
            torch.from_numpy(sign).to(device), WR, WC)


def bisect_path_args(device):
    """K5's arguments at the gather-probe path's shape, ``{kernel: args}``:
    the 2048 window origins (32 agents x 64 tiles) of
    ``probe_onehot_crop.py``'s 64x192 window on its (2048, 1024) uint8
    raster for K5b and K5c (one window an output), each tile's
    window-local rows for K5d, and K5a on (8192, 1024) f32 in groups of 8
    rows (the bytes of K1's output)."""
    from .probes import bisect_kernels as bk
    from .probes import onehot_crop as oc

    probe = oc.PROBES["dma"]
    x = oc._inputs(probe, device)
    N, L, W = probe["N"], probe["L"], probe["W"]
    tiles = [oc.tileize(x[k], N, L, W) for k in ("py", "px", "outside")]
    row0, col0, ly, _ = oc.tile_windows(*tiles, x["mapix"], probe["H"],
                                        probe["Wp"], x["flat"].shape[0],
                                        "dma")
    WR, WC = oc.WINDOWS["dma"]
    flat = x["flat"]
    r, c = row0.reshape(-1).contiguous(), col0.reshape(-1).contiguous()
    w = bk.window_convert_plain(flat, r, c, WR, WC, torch.float32).to(
        torch.bfloat16)
    rng = np.random.default_rng(8)
    xs = torch.from_numpy(rng.standard_normal((8192, 1024)).astype(
        np.float32)).to(device)
    fs = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).to(
        device)
    one = torch.ones(1, dtype=torch.int32, device=device)
    return {"scale_rows": (xs, fs, 8),
            "window_convert": (flat, r, c, WR, WC, torch.int32),
            "window_sums": (flat, r[:, None].contiguous(),
                            c[:, None].contiguous(), one, WR, WC),
            "onehot_rows": (w, ly.reshape(-1, ly.shape[-1]).contiguous())}


def onehot_cases(seed=0):
    """K5d's edge cases, ``{name: {"w": (T, R, C) float32 of bf16 values,
    "idx": (T, P) int32, "offset": int32 elements before idx in its
    buffer}}``: the bisect scripts' shape (one channel a block), groups
    that do not divide C (7 of 192 channels a block on 132 SMs at
    T5_P1000, 3 of 50 at C50_P4099), a tail of 1-3 points (P % 4 != 0,
    one float a store), more than 65,535 tiles on grid x, idx off its 16
    bytes, a w[t] past 48 KB of shared memory; indices -1, 0, R - 1, R and
    int32's extremes."""
    rng = np.random.default_rng(seed)

    def case(T, R, C, P, offset=0):
        w = rng.standard_normal((T, R, C)).astype(np.float32)
        idx = rng.integers(-3, R + 3, (T, P)).astype(np.int32)
        edge = np.array([-1, 0, R - 1, R, -2 ** 31, 2 ** 31 - 1], np.int32)
        idx[:, :min(P, 6)] = edge[:min(P, 6)]
        return {"w": w, "idx": idx, "offset": offset}

    return {"scripts_T1": case(1, 64, 192, 1024),
            "T5_P1000": case(5, 64, 192, 1000),
            "C50_P4099": case(2, 64, 50, 4099),
            "P1_C1": case(3, 1, 1, 1),
            "T70000_P6": case(70000, 3, 5, 6),
            "T70000_P8": case(70000, 2, 3, 8),
            "idx_off16": case(3, 64, 24, 1024, offset=1),
            "R20000": case(1, 20000, 4, 8)}


def onehot_args(case, device):
    """``onehot_rows``' arguments (w bf16, idx) for one ``onehot_cases``
    entry, idx ``offset`` int32 elements into its buffer."""
    w = torch.from_numpy(case["w"]).to(device).to(torch.bfloat16)
    T, P = case["idx"].shape
    buf = torch.empty(case["offset"] + T * P, dtype=torch.int32,
                      device=device)
    idx = buf[case["offset"]:].view(T, P)
    idx.copy_(torch.from_numpy(case["idx"]))
    return w, idx


def onehot_blocks(w, idx, launch, vec):
    """K5d as its blocks split the work (csrc/bisect.cu
    ``onehot_rows_kernel``), in numpy: block (t, band, group) stages
    channels [group * cg, + cg) of w[t], each of its ONEHOT_THREADS threads
    takes ONEHOT_POINTS consecutive points of the band (all whole where
    ``vec``; else those below P) and writes them for each staged channel.

    :param w: (T, R, C) float32; idx: (T, P) int32
    :param launch: :func:`probes.bisect_kernels.onehot_launch`'s result
    :return: out (T, C, P) float32 (NaN where no thread wrote), and the
        number of writes of each output element
    """
    from .probes import bisect_kernels as bk

    T, R, C = w.shape
    P = idx.shape[1]
    out = np.full((T, C, P), np.nan, np.float32)
    writes = np.zeros((T, C, P), np.int32)
    cg, (_, bands, groups) = launch["cg"], launch["grid"]
    lanes = np.arange(bk.ONEHOT_POINTS)
    for z in range(groups):
        c0 = z * cg
        staged = w[:, :, c0:c0 + min(cg, C - c0)]  # (T, R, cn)
        for y in range(bands):
            p0 = (y * bk.ONEHOT_THREADS + np.arange(bk.ONEHOT_THREADS)) \
                * bk.ONEHOT_POINTS
            p0 = p0[p0 < P]  # the threads past P return
            p = (p0[:, None] + lanes).reshape(-1)
            if vec and (p >= P).any():
                raise AssertionError("a 16-byte quad crosses P")
            p = p[p < P]
            j = idx[:, p].astype(np.int64)  # (T, n)
            ok = (j >= 0) & (j < R)
            rows = staged[np.arange(T)[:, None], np.clip(j, 0, R - 1)]
            vals = np.where(ok[..., None], rows, np.float32(0))  # (T, n, cn)
            out[:, c0:c0 + staged.shape[2], p] = vals.transpose(0, 2, 1)
            writes[:, c0:c0 + staged.shape[2], p] += 1
    return out, writes
