"""Rasterized map store.

Port of ``strive_tpu/maps/store.py``: ``raster (M, C, H, W)`` uint8 on the
device, the per-map meters-per-pixel table ``dx (M, 2)``, and the
bit-packed raster ``packed (M, H, W)`` (bit c = channel c) that the crop
and footprint kernels read. Unlike the TPU store, ``packed`` carries no
block-alignment padding: the CUDA kernels gather bytes directly. The
nuScenes maps (``NUSC_MAP_SIZES``) are stacked zero-padded to the largest
extent, each with its own ``dx`` (``scripts/preprocess_nuscenes.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# default observation bounds [low_l, low_w, high_l, high_w] in meters
# (reference utils/config.py:56-57)
DEFAULT_BOUNDS = (-17.0, -38.5, 60.0, 38.5)

NUSC_MAP_SIZES = {  # meters (H, W); reference map_env.py:14-19
    "singapore-onenorth": (2025.0, 1585.6),
    "singapore-hollandvillage": (2922.9, 2808.3),
    "singapore-queenstown": (3687.1, 3228.6),
    "boston-seaport": (2118.1, 2979.5),
}

ROAD_LAYERS = ("drivable_area", "road_segment", "lane")
DEFAULT_LAYERS = ("drivable_area", "carpark_area", "road_divider", "lane_divider")


def num_channels(layers=DEFAULT_LAYERS):
    """Crop channels of a layer list: the road layers share channel 0, every
    other layer has its own (reference ``map_env.py:63-77``)."""
    road = [l for l in layers if l in ROAD_LAYERS]
    other = [l for l in layers if l not in ROAD_LAYERS]
    return (1 if road else 0) + len(other)


@dataclasses.dataclass
class MapStore:
    """Rasterized maps + resolution table.

    ``dx[m] = (meters/pixel along H, meters/pixel along W)``; following the
    reference (``nuscenes_utils.py:254``), world x is divided by
    ``dx[m, 0]`` and world y by ``dx[m, 1]``.
    """

    raster: torch.Tensor  # (M, C, H, W) uint8
    dx: torch.Tensor      # (M, 2) float32
    packed: torch.Tensor  # (M, H, W) uint8 bitfield
    map_names: Tuple[str, ...] = ()  # by map index

    @property
    def M(self):
        return self.raster.shape[0]

    @property
    def C(self):
        return self.raster.shape[1]

    def drivable(self):
        """(M, H, W) road layer (channel 0)."""
        return self.raster[:, 0]

    @classmethod
    def from_raster(cls, raster, dx, map_names=()):
        return cls(raster=raster, dx=dx, packed=pack_raster(raster),
                   map_names=tuple(map_names))


def pack_raster(raster):
    """(M, C, H, W) binary uint8 -> (M, H, W) uint8 bitfield, bit c = channel c."""
    M, C, H, W = raster.shape
    if C > 8:
        raise ValueError("bit-packing supports at most 8 channels")
    shifts = torch.tensor([1 << c for c in range(C)], dtype=torch.uint8,
                          device=raster.device)
    return torch.sum(raster.to(torch.uint8) * shifts[None, :, None, None],
                     dim=1, dtype=torch.uint8)


def synthetic_map_store(num_maps=2, size_px=512, channels=3, pix_per_m=4.0,
                        seed=0, device="cuda") -> MapStore:
    """Procedurally generated maps, identical to strive_tpu's for a seed.

    Channel 0 is a 'drivable' grid of roads; other channels hold sparse
    divider-like stripes.
    """
    rng = np.random.default_rng(seed)
    rasters = np.zeros((num_maps, channels, size_px, size_px), np.uint8)
    for m in range(num_maps):
        driv = np.zeros((size_px, size_px), np.uint8)
        band_w = size_px // 10
        for _ in range(4):
            r = int(rng.integers(0, size_px - band_w))
            driv[r: r + band_w, :] = 1
            c = int(rng.integers(0, size_px - band_w))
            driv[:, c: c + band_w] = 1
        driv[size_px // 4: 3 * size_px // 4, size_px // 4: 3 * size_px // 4] = 1
        rasters[m, 0] = driv
        for c in range(1, channels):
            stripes = np.zeros((size_px, size_px), np.uint8)
            for _ in range(3):
                r = int(rng.integers(0, size_px - 2))
                stripes[r: r + 2, :] = 1
            rasters[m, c] = stripes & driv
    dx = np.full((num_maps, 2), 1.0 / pix_per_m, np.float32)
    return MapStore.from_raster(torch.from_numpy(rasters).to(device),
                                torch.from_numpy(dx).to(device),
                                tuple(f"synthetic-{i}" for i in range(num_maps)))


def upsample_store(store: MapStore, factor: int) -> MapStore:
    """Nearest-neighbour upsample (``strive_tpu/maps/store.py:157-173``):
    the same content in ``factor`` x finer pixels; ``dx`` shrinks by
    ``factor`` so world-coordinate queries stay correct."""
    if factor <= 1:
        return store
    r = store.raster.repeat_interleave(factor, dim=-2).repeat_interleave(
        factor, dim=-1)
    return MapStore.from_raster(r, store.dx / float(factor), store.map_names)
