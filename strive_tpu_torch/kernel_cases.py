"""The inputs that hold K2 ``footprint_coll_point`` and K4b ``window_take``
to their plain versions, shared by ``chip_smoke.py`` and the tests: the
main path's K2 inputs, both kernels' edge cases, and the check of K2's
contract (:func:`coll_point_error`)."""

from __future__ import annotations

import numpy as np
import torch

from .geometry import interp_traj
from .maps import crop_kernel, queries


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
    from .data.synthetic import synthetic_scene_list
    from .maps.store import synthetic_map_store
    from .normalize import att_normalizer_for, state_normalizer_for
    from .scene import pad_scene_arrays

    B, NA, cats = 4, 8, ("car", "truck")
    store = synthetic_map_store(num_maps=2, size_px=2048, channels=4,
                                pix_per_m=4.0, device=device)
    scene = pad_scene_arrays(synthetic_scene_list(
        num_scenes=B, num_maps=2, map_size_px=2048, PT=4, FT=12,
        min_agents=NA, max_agents=NA), NA, 2, device=device)
    sn, an = state_normalizer_for(cats), att_normalizer_for(cats)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return store, main_path_coll_point_args(
        store, scene, t(sn.mean_np[:4]), t(sn.std_np[:4]), t(an.mean_np),
        t(an.std_np))


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
