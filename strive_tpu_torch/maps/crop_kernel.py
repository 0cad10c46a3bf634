"""Wrappers of the Hopper map kernels of ``csrc/crop.cu``, and their plain versions.

K1 ``map_crop`` replaces ``strive_tpu/maps/crop_kernel.py::get_map_crop_kernel``
and K2 ``footprint_coll_point`` replaces
``strive_tpu/maps/crop_kernel.py::get_footprint_vals_kernel`` plus the
``_coll_point_from_pix`` reduction. The design notes and bounds are in the
CUDA source.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream, raises
if the launch failed, and adds one to ``LAUNCHES[name]``. Each plain
version (same signature, any device) is the function the kernel must match:
the CPU path of ``queries.get_map_crop`` / ``queries.get_coll_point`` and
the oracle of the CUDA tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import launch
from ..utils.launch import INT as _I, PTR as _P
from . import queries

SOURCE = "crop"

# launches per kernel, counted where the kernel is launched and nowhere else
LAUNCHES = {"map_crop": 0, "footprint_coll_point": 0}

_LIB = launch.Library(SOURCE, {
    # packed, M, H, W, dx, pos, mapix, lo, wo, N, L, Wc, C, nhwc, bf16, out,
    # stream
    "strive_map_crop": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _P, _P],
    # packed, M, H, W, dx, cars, lw, mapix, lin_l, lin_w, P, L, Wg, bit,
    # coll_pt, valid, frac, stream
    "strive_footprint_coll_point": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _P, _P, _P, _P],
    # d, pos_n, neg_n, mismatches, stream
    "strive_crop_quotient_sweep": [ctypes.c_float, ctypes.c_ulonglong,
                                   ctypes.c_ulonglong, _P, _P],
})


def _check_raster(packed, dx, device):
    launch.check("packed", packed, torch.uint8, 3, device)
    launch.check("dx", dx, torch.float32, 2, device, last=2)
    if dx.shape[0] != packed.shape[0]:
        raise ValueError("dx must have one row per map")


# the output types K1 writes
CROP_DTYPES = (torch.float32, torch.bfloat16)


def map_crop(packed, dx, pos, mapix, lo, wo, num_channels, layout="nhwc",
             dtype=torch.float32):
    """K1: oriented crops of the bit-packed raster, bits unpacked to 0/1 in
    float32 or bfloat16 (both exact).

    :param packed: (M, H, W) uint8, bit c = channel c
    :param dx: (M, 2) float32 meters per pixel
    :param pos: (N, 4) float32 UNNORMALIZED (x, y, hx, hy)
    :param mapix: (N,) int64 map of each pose
    :param lo, wo: (L,), (W,) float32 offsets (``queries.crop_offsets``)
    :param num_channels: C <= 8 channels to unpack
    :param dtype: of the output, one of ``CROP_DTYPES``
    :return: (N, L, W, C) for 'nhwc', (N, C, L, W) for 'nchw'; ``dtype``
    """
    device = pos.device
    _check_raster(packed, dx, device)
    launch.check("pos", pos, torch.float32, 2, device, last=4)
    launch.check("mapix", mapix, torch.int64, 1, device)
    launch.check("lo", lo, torch.float32, 1, device)
    launch.check("wo", wo, torch.float32, 1, device)
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"unknown layout {layout}")
    if dtype not in CROP_DTYPES:
        raise ValueError(f"map_crop writes float32 or bfloat16, not {dtype}")
    C = int(num_channels)
    if not 1 <= C <= 8:
        raise ValueError("num_channels must be in [1, 8]")
    N, L, Wc = pos.shape[0], lo.shape[0], wo.shape[0]
    if mapix.shape[0] != N:
        raise ValueError("mapix must have one entry per pose")
    if N * L * Wc >= 2 ** 31:
        raise ValueError("map_crop takes fewer than 2^31 crop pixels")
    shape = (N, L, Wc, C) if layout == "nhwc" else (N, C, L, Wc)
    out = torch.empty(shape, dtype=dtype, device=device)
    if N * L * Wc == 0:
        return out
    M, H, W = packed.shape
    _LIB.launch(
        "strive_map_crop", packed.data_ptr(), M, H, W, dx.data_ptr(),
        pos.data_ptr(), mapix.data_ptr(), lo.data_ptr(), wo.data_ptr(), N, L,
        Wc, C, int(layout == "nhwc"), int(dtype == torch.bfloat16),
        out.data_ptr(), launch.stream(device))
    LAUNCHES["map_crop"] += 1
    return out


def map_crop_plain(packed, dx, pos, mapix, lo, wo, num_channels,
                   layout="nhwc", dtype=torch.float32):
    """Plain PyTorch version of :func:`map_crop` (any device)."""
    return queries.crop_plain(packed, dx, pos, mapix, lo, wo, num_channels,
                              layout, dtype)


def quotient_mismatches(d, lo_px, hi_px, device):
    """K1's division on the card against the IEEE quotient: the number of
    float32 ``g`` whose quotient ``g / d`` lies in ``[lo_px, hi_px]``
    pixels (``lo_px <= 0 < hi_px``) for which K1's ``rint(g / d)`` differs
    from ``rint`` of ``__fdiv_rn(g, d)``; every such ``g`` is tried. Not a
    launch of K1: ``LAUNCHES`` is left alone.

    :param d: a float32 meters per pixel, ``d > 0``
    :return: (mismatches, number of ``g`` tried)
    """
    d = np.float32(d)
    if not d > 0:
        raise ValueError("quotient_mismatches takes d > 0")
    # the float32 g of [lo_px * d, hi_px * d], widened by an ulp each way
    g_lo = np.nextafter(np.float32(np.float64(lo_px) * d), np.float32(-np.inf))
    g_hi = np.nextafter(np.float32(np.float64(hi_px) * d), np.float32(np.inf))
    pos_n = int(g_hi.view(np.uint32)) + 1 if g_hi >= 0 else 0
    neg_n = int((-g_lo).view(np.uint32)) + 1 if g_lo < 0 else 0
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _LIB.launch("strive_crop_quotient_sweep", float(d), pos_n, neg_n,
                count.data_ptr(), launch.stream(device))
    return int(count.item()), pos_n + neg_n


def footprint_coll_point(packed, dx, cars, lw, mapix, lin_l, lin_w, bit=0):
    """K2: mean off-road point of each car's footprint grid, fused.

    :param packed: (M, H, W) uint8; ``bit`` is the drivable layer
    :param cars: (P, 4) float32 UNNORMALIZED (x, y, hx, hy)
    :param lw: (P, 2) float32 footprint length and width (meters)
    :param mapix: (P,) int64
    :param lin_l, lin_w: (L,), (W,) float32 ``linspace(-1, 1, .)`` tables
    :return: coll_pt (P, 2) float32, valid (P,) bool, frac (P,) float32
    """
    device = cars.device
    _check_raster(packed, dx, device)
    launch.check("cars", cars, torch.float32, 2, device, last=4)
    launch.check("lw", lw, torch.float32, 2, device, last=2)
    launch.check("mapix", mapix, torch.int64, 1, device)
    launch.check("lin_l", lin_l, torch.float32, 1, device)
    launch.check("lin_w", lin_w, torch.float32, 1, device)
    P, L, Wg = cars.shape[0], lin_l.shape[0], lin_w.shape[0]
    if lw.shape[0] != P or mapix.shape[0] != P:
        raise ValueError("lw and mapix must have one row per car")
    if not 0 <= int(bit) < 8:
        raise ValueError("bit must be in [0, 8)")
    if P >= 2 ** 31 or not 0 < L * Wg < 2 ** 30:
        raise ValueError("footprint_coll_point takes fewer than 2^31 cars "
                         "and a grid of 1 to 2^30 samples")
    coll_pt = torch.empty((P, 2), dtype=torch.float32, device=device)
    valid = torch.empty((P,), dtype=torch.bool, device=device)
    frac = torch.empty((P,), dtype=torch.float32, device=device)
    if P == 0:
        return coll_pt, valid, frac
    M, H, W = packed.shape
    _LIB.launch(
        "strive_footprint_coll_point", packed.data_ptr(), M, H, W,
        dx.data_ptr(), cars.data_ptr(), lw.data_ptr(), mapix.data_ptr(),
        lin_l.data_ptr(), lin_w.data_ptr(), P, L, Wg, int(bit),
        coll_pt.data_ptr(), valid.data_ptr(), frac.data_ptr(),
        launch.stream(device))
    LAUNCHES["footprint_coll_point"] += 1
    return coll_pt, valid, frac


def footprint_coll_point_plain(packed, dx, cars, lw, mapix, lin_l, lin_w,
                               bit=0):
    """Plain PyTorch version of :func:`footprint_coll_point` (any device)."""
    return queries.coll_point_plain(packed, dx, cars, lw, mapix, lin_l, lin_w,
                                    bit=bit)
