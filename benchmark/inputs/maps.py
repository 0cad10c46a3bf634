"""The raster of nuScenes' four maps at their extents, made on the device.

A frozen copy of the content that ``strive_tpu_torch.data.synthetic_etl``
writes in nuScenes' ETL format: over each map's extent a grid of road
bands every ``spacing_m`` (each band holds a lane pair: the +x lane at
y = k * spacing, the -x lane spacing / 4 below it; likewise in x), a
carpark square in every other block and two divider lines inside each
band. As the ETL does (the reference's ``map_env.py:79-166``): the road
layers are channel 0, each other layer a channel of its own, a map is
``round(extent * pix_per_m)`` pixels with ``dx`` = extent / pixels, the
Singapore maps are flipped about x, and every map is zero-padded to the
largest. The content depends on no seed.
"""

from __future__ import annotations

import numpy as np
import torch

ROAD_HALF_M = 5.0  # road margin beyond the outer lanes of a band (m)
ROAD_LAYERS = ("drivable_area", "road_segment", "lane")


def sizes(store):
    """[(H px, W px)] and (M, 2) float32 dx of the store's maps."""
    px, dxs = [], []
    for name in store["maps"]:
        msize = np.array(store["extents_m"][name])
        p = np.round(msize * store["pix_per_m"]).astype(np.int32)
        px.append((int(p[0]), int(p[1])))
        dxs.append(msize / p)
    return px, np.stack(dxs).astype(np.float32)


def _bands(extent, spacing):
    return [(k - spacing / 4 - ROAD_HALF_M, k + ROAD_HALF_M)
            for k in np.arange(spacing, extent, spacing)]


def _paint(img, size_m, layers, spacing):
    """Fill one map's (C, H, W) uint8 ``img`` (devkit frame)."""
    _, H, W = img.shape
    sy, sx = H / size_m[0], W / size_m[1]

    def rows(lo, hi):
        return slice(max(int(lo * sy), 0), max(int(hi * sy), 0))

    def cols(lo, hi):
        return slice(max(int(lo * sx), 0), max(int(hi * sx), 0))

    road = [l for l in layers if l in ROAD_LAYERS]
    other = [l for l in layers if l not in ROAD_LAYERS]
    S = spacing
    if road:
        for lo, hi in _bands(size_m[0], S):
            img[0, rows(lo, hi), :] = 1
        for lo, hi in _bands(size_m[1], S):
            img[0, :, cols(lo, hi)] = 1
    for i, layer in enumerate(other):
        m = img[(1 if road else 0) + i]
        if layer == "carpark_area":
            for a, ky in enumerate(np.arange(S, size_m[0], S)):
                for b, kx in enumerate(np.arange(S, size_m[1], S)):
                    if (a + b) % 2 == 0:
                        m[rows(ky + 2 * ROAD_HALF_M,
                               ky + 2 * ROAD_HALF_M + S / 4),
                          cols(kx + 2 * ROAD_HALF_M,
                               kx + 2 * ROAD_HALF_M + S / 4)] = 1
        else:  # a divider line inside every band
            off = -S / 8 if layer == "road_divider" else 1.5
            for k in np.arange(S, size_m[0], S):
                m[rows(k + off, k + off + 0.5), :] = 1
            for k in np.arange(S, size_m[1], S):
                m[:, cols(k + off, k + off + 0.5)] = 1


def raster(store, device):
    """:return: (M, C, maxH, maxW) uint8 raster and (M, 2) float32 dx, on
    ``device``."""
    px, dx = sizes(store)
    layers = store["layers"]
    C = (1 if any(l in ROAD_LAYERS for l in layers) else 0) + sum(
        l not in ROAD_LAYERS for l in layers)
    H, W = max(p[0] for p in px), max(p[1] for p in px)
    out = torch.zeros((len(px), C, H, W), dtype=torch.uint8, device=device)
    for mi, name in enumerate(store["maps"]):
        h, w = px[mi]
        img = out[mi, :, :h, :w]
        _paint(img, store["extents_m"][name], layers, store["spacing_m"])
        if store["flip_singapore"] and name.startswith("singapore"):
            img.copy_(torch.flip(img, dims=[1]))
    return out, torch.from_numpy(dx).to(device)


def lanes(extent, spacing):
    """The lane grid of a map in the devkit frame: [(start xy, unit
    direction, length)], four lanes a band."""
    out = []
    for k in np.arange(spacing, extent, spacing):
        out += [((0.0, k), (1.0, 0.0), extent),
                ((extent, k - spacing / 4), (-1.0, 0.0), extent),
                ((k, 0.0), (0.0, 1.0), extent),
                ((k - spacing / 4, extent), (0.0, -1.0), extent)]
    return out
