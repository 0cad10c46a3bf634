"""The rotated-crop gather, tile by tile from a staged raster window (K3).

Counterpart of ``scripts/probe_onehot_crop.py`` (window "dma": per 32x32
crop tile a 64x192 window at an origin aligned to 8 rows / 128 columns) and
``scripts/probe_onehot_crop2.py`` (window "quadrant": a 128x256 window of
2x2 blocks of 64x128 at block indices (rb, cb)). Each builds the scripts'
synthetic rotated indices, gathers them through K3 (``crop_tiles``) and
holds the result bit for bit against the direct path, the scripts'
``xla_path``: one flat take with clip (K4b ``take`` over the whole raster).

    python -m strive_tpu_torch.probes.onehot_crop [--device cpu]

prints, per window, whether the two agree and the ms and G elem/s of the
direct path (index arithmetic + K4b), K4b alone on the precomputed index,
the whole kernel path (index prologue, K3, untileize, the off-map fix-up)
and K3 alone.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import gelem_s
from . import window_kernels as wk
from ..utils import timing

TILE = 32
PTS = TILE * TILE
# window: (rows, cols); "quadrant" windows are 2x2 blocks of BLOCK
WINDOWS = {"dma": (64, 192), "quadrant": (128, 256)}
BLOCK = (64, 128)
# the scripts' sizes: (M, H, Wp) raster, N agents, L x W crops, and the
# ranges of the crop centers in pixels
PROBES = {
    "dma": dict(M=2, H=1024, Wp=1024, N=32, L=256, W=256,
                cx=(200, 800), cy=(200, 800)),      # probe_onehot_crop.py:134
    "quadrant": dict(M=2, H=1024, Wp=1152, N=32, L=256, W=256,
                     cx=(200, 900), cy=(200, 800)),  # probe_onehot_crop2.py:132
}
REPS = 20


def synthetic_crop(M, H, Wp, N, L, W, cx, cy, seed=0):
    """The scripts' raster and rotated crop indices, drawn in their order
    (``probe_onehot_crop.py:133-155``): per agent a random center and
    heading, a 0.302 m crop step on a 0.25 m/px raster; off-map samples
    are flagged and moved to pixel (0, 0).

    :return: numpy (packed (M, H, Wp) uint8, py, px (N, L, W) int32,
        outside (N, L, W) bool, mapix (N,) int32)
    """
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (M, H, Wp)).astype(np.uint8)
    theta = rng.uniform(0, 2 * np.pi, N)
    cx = rng.uniform(cx[0], cx[1], N)
    cy = rng.uniform(cy[0], cy[1], N)
    ii, jj = np.meshgrid(np.arange(L), np.arange(W), indexing="ij")
    scale = 0.302 / 0.25
    cos, sin = np.cos(theta)[:, None, None], np.sin(theta)[:, None, None]
    px = np.round(cx[:, None, None] + scale * (
        (ii - L / 2) * cos - (jj - W / 2) * sin)).astype(np.int32)
    py = np.round(cy[:, None, None] + scale * (
        (ii - L / 2) * sin + (jj - W / 2) * cos)).astype(np.int32)
    outside = (px < 0) | (px >= Wp) | (py < 0) | (py >= H)
    px = np.where(outside, 0, px)
    py = np.where(outside, 0, py)
    mapix = rng.integers(0, M, N).astype(np.int32)
    return packed, py, px, outside, mapix


def tileize(idx, N, L, W):
    """(N, L, W) -> (N, T, PTS), tile-major (T = (L/32) * (W/32))."""
    tr, tc = L // TILE, W // TILE
    return (idx.reshape(N, tr, TILE, tc, TILE).permute(0, 1, 3, 2, 4)
            .reshape(N, tr * tc, PTS))


def untileize(vals, N, L, W):
    """(N, T, PTS) -> (N, L, W), the inverse of :func:`tileize`."""
    tr, tc = L // TILE, W // TILE
    return (vals.reshape(N, tr, tc, TILE, TILE).permute(0, 1, 3, 2, 4)
            .reshape(N, L, W))


def tile_windows(py_t, px_t, o_t, mapix, H, Wp, MH, window):
    """Each tile's window origin and its window-local indices, as the
    scripts compute them (``probe_onehot_crop.py:169-181`` for "dma",
    ``probe_onehot_crop2.py:108-123`` for "quadrant"): the window starts
    at the tile's smallest on-map pixel, aligned down and clamped so it
    lies in the raster; indices are clamped into the window.

    :param py_t, px_t: (N, T, PTS) int32 map pixels; o_t (N, T, PTS) off-map
    :return: row0, col0 (N, T) int32 in the (MH, Wp) raster; ly, lx
        (N, T, PTS) int32
    """
    WR, WC = WINDOWS[window]
    big = 1 << 30
    rows = py_t if window == "dma" else mapix[:, None, None] * H + py_t
    py_min = torch.where(o_t, big, rows).amin(dim=2)
    px_min = torch.where(o_t, big, px_t).amin(dim=2)
    py_min = torch.where(py_min == big, 0, py_min)
    px_min = torch.where(px_min == big, 0, px_min)
    if window == "dma":
        y0 = (py_min & ~7).clamp(0, H - WR)
        x0 = (px_min & ~127).clamp(0, Wp - WC)
        row0, col0 = mapix[:, None] * H + y0, x0
        ly = (py_t - y0[..., None]).clamp(0, WR - 1)
    else:
        br, bc = BLOCK
        rb = torch.div(py_min, br, rounding_mode="floor").clamp(0, MH // br - 2)
        cb = torch.div(px_min, bc, rounding_mode="floor").clamp(0, Wp // bc - 2)
        row0, col0 = rb * br, cb * bc
        ly = (rows - row0[..., None]).clamp(0, WR - 1)
    lx = (px_t - col0[..., None]).clamp(0, WC - 1)
    return row0.int(), col0.int(), ly.int(), lx.int()


def kernel_crop(flat, py, px, mapix, outside, H, Wp, N, L, W, window="dma"):
    """The crop through K3: per-tile window origins, the tiled gather,
    untileize, and the map's pixel (0, 0) where a sample is off-map.

    :param flat: (M*H, Wp) uint8 raster
    :param py, px: (N, L, W) int32 map pixels (0 where off-map)
    :param mapix: (N,) int32; outside: (N, L, W) bool
    :return: (N, L, W) int32 byte values
    """
    tiles = [tileize(a, N, L, W) for a in (py, px, outside)]
    row0, col0, ly, lx = tile_windows(*tiles, mapix, H, Wp, flat.shape[0],
                                      window)
    vals = wk.crop_tiles(flat, row0, col0, ly, lx, *WINDOWS[window])
    vals = untileize(vals, N, L, W).int()
    origin = flat[mapix.long() * H, 0].int()
    return torch.where(outside, origin[:, None, None], vals)


def direct_index(py, px, mapix, H, Wp):
    """(1, N*L*W) int32 index of each sample in the flattened raster."""
    return (mapix[:, None, None] * (H * Wp) + py * Wp + px).reshape(1, -1)


def direct_path(flat, py, px, mapix, H, Wp):
    """The scripts' ``xla_path``: one flat take with clip over the raster
    (K4b on the CUDA path). :return: (N, L, W) uint8"""
    idx = direct_index(py, px, mapix, H, Wp)
    return wk.take(flat.reshape(1, -1), idx).reshape(py.shape)


def _inputs(probe, device):
    packed, py, px, outside, mapix = synthetic_crop(**probe)
    M, H, Wp = packed.shape
    return dict(flat=torch.from_numpy(packed.reshape(M * H, Wp)).to(device),
                py=torch.from_numpy(py).to(device),
                px=torch.from_numpy(px).to(device),
                mapix=torch.from_numpy(mapix).to(device),
                outside=torch.from_numpy(outside).to(device))


def run(device="cuda"):
    """Both windows at the scripts' sizes: bit-exactness against the direct
    path, and the ms and G elem/s of each path (device time on a CUDA
    device, host time on the CPU). Per window it calls K3 and K4b once
    each to check, then times two paths through each, ``REPS`` at a time
    (``timing.calls``). Raises on any mismatch.

    :return: {"device", window: {...}}
    """
    device = torch.device(device)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for window, probe in PROBES.items():
        x = _inputs(probe, device)
        H, Wp, N, L, W = (probe[k] for k in ("H", "Wp", "N", "L", "W"))
        direct = lambda: direct_path(x["flat"], x["py"], x["px"], x["mapix"],
                                     H, Wp)
        kernel = lambda: kernel_crop(**x, H=H, Wp=Wp, N=N, L=L, W=W,
                                     window=window)
        tiles = [tileize(x[k], N, L, W) for k in ("py", "px", "outside")]
        args = (x["flat"], *tile_windows(*tiles, x["mapix"], H, Wp,
                                         x["flat"].shape[0], window),
                *WINDOWS[window])
        k3 = lambda: wk.crop_tiles(*args)
        idx = direct_index(x["py"], x["px"], x["mapix"], H, Wp)
        take = lambda: wk.take(x["flat"].reshape(1, -1), idx)
        ref, got = direct(), kernel()
        if not torch.equal(ref.int(), got):
            bad = int((ref.int() != got).sum())
            raise AssertionError(f"{window}: {bad} of {got.numel()} values "
                                 "differ from the direct path")
        n = N * L * W
        res = {"bit_exact": True, "elements": n}
        for name, fn in (("direct", direct), ("direct_take", take),
                         ("kernel_path", kernel), ("k3", k3)):
            ms = timing.device_ms(fn, REPS, device)
            res[f"{name}_ms"], res[f"{name}_gelem_s"] = ms, gelem_s(n, ms)
        out[window] = res
    return out


def format_lines(result):
    """The scripts' report lines for one :func:`run` result."""
    lines = []
    for window in (k for k in result if k != "device"):
        r = result[window]
        lines.append(f"[{window} window] bit-exact: {r['bit_exact']}")
        for name, label in (("direct", "direct"),
                            ("direct_take", "K4b alone"),
                            ("kernel_path", "kernel"), ("k3", "K3 alone")):
            lines.append(f"{label:9s}: {r[f'{name}_ms']:8.3f} ms   "
                         f"{r[f'{name}_gelem_s']:7.2f} G elem/s")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    print(f"device: {result['device']}")
    print("\n".join(format_lines(result)))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
