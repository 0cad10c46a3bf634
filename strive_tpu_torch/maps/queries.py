"""Map crop sampling and occupancy queries.

Port of ``strive_tpu/maps/queries.py`` (reference
``datasets/nuscenes_utils.py:205-390``). Semantics preserved exactly:
rotated meter-space grid, round-to-nearest pixel (half to even), integer
gather, out-of-bounds (or NaN-pose) samples read the map's pixel (0, 0),
world x scaled by dx[m, 0] and y by dx[m, 1], rows indexed with pixel-y.

``get_map_crop`` and ``get_coll_point`` dispatch on the device of their
inputs: a CUDA tensor goes to the hand-written kernels of
``crop_kernel.py`` (or raises), a CPU tensor to the plain versions here,
which are also the kernels' oracles.

Out-of-bounds is judged on the rounded float pixel coordinate, before any
integer conversion, so that it agrees bit for bit with the CUDA kernels for
every float input (for in-range values it is the same test as the JAX
package's integer compare).
"""

from __future__ import annotations

import numpy as np
import torch

# static footprint grid sizes (see strive_tpu/maps/queries.py docstring)
ON_LAYER_GRID = (20, 8)
COLL_POINT_GRID = (39, 16)
LINE_SAMPLES = 128

_LINSPACE = {}  # (start, stop, num, device) -> read-only table


def linspace(start, stop, num, device="cpu"):
    """float32 ``start*(1 - i/div) + stop*(i/div)``, last value exactly stop.

    The formula of ``jnp.linspace``. XLA may rewrite it when it fuses, so
    values can differ from the JAX package by an ulp. The table is computed
    on the host (CUDA would divide by ``div`` through its reciprocal) and
    cached per device, so every device gets the same bits and the crop
    kernel and the plain crop read one table.
    """
    key = (float(start), float(stop), int(num), str(torch.device(device)))
    table = _LINSPACE.get(key)
    if table is None:
        f32 = np.float32
        if num == 1:
            vals = np.array([start], f32)
        else:
            div = num - 1
            step = np.arange(div, dtype=f32) / f32(div)
            vals = np.append(f32(start) * (f32(1) - step) + f32(stop) * step,
                             f32(stop)).astype(f32)
        table = torch.from_numpy(vals).to(device)
        _LINSPACE[key] = table
    return table


def crop_offsets(bounds, L, W, device="cpu"):
    """(L,) length-wise and (W,) width-wise crop offsets in meters."""
    return (linspace(bounds[0], bounds[2], L, device),
            linspace(bounds[1], bounds[3], W, device))


def rotate_grid(lwise, wwise, xy, h):
    """World coords ``(lwise*hc - wwise*hs) + x``, ``(lwise*hs + wwise*hc) + y``.

    :param lwise: (B or 1, L, 1) offsets along the heading
    :param wwise: (B or 1, 1, W) offsets across the heading
    :param xy, h: (B, 2) centers and heading vectors
    :return: (B, L, W, 2)
    """
    hcos = h[:, 0][:, None, None]
    hsin = h[:, 1][:, None, None]
    gx = lwise * hcos - wwise * hsin + xy[:, 0][:, None, None]
    gy = lwise * hsin + wwise * hcos + xy[:, 1][:, None, None]
    return torch.stack(torch.broadcast_tensors(gx, gy), dim=-1)


def gen_car_coords(xy, h, L, W, bounds=None, ls=None, ws=None):
    """World-space sample grid aligned with each agent.

    :param xy: (B, 2) centers
    :param h: (B, 2) heading vectors (hx, hy)
    :param bounds: [low_l, low_w, high_l, high_w] meters, or
    :param ls, ws: (B,) per-agent footprint extents
    :return: (B, L, W, 2) world xy coords
    """
    if bounds is not None:
        lo, wo = crop_offsets(bounds, L, W, xy.device)
        lwise, wwise = lo[None, :, None], wo[None, None, :]
    else:
        lwise = (linspace(-1.0, 1.0, L, xy.device)[None, :, None]
                 * (ls / 2.0)[:, None, None])
        wwise = (linspace(-1.0, 1.0, W, xy.device)[None, None, :]
                 * (ws / 2.0)[:, None, None])
    return rotate_grid(lwise, wwise, xy, h)


def _pixel_index(H, W, dx, xys, mapixes):
    """(map, row, col) indices of world coords; off-map -> pixel (0, 0).

    :param dx: (M, 2)
    :param xys: (B, ..., 2) world coords
    :param mapixes: (B,) int map index per batch element
    :return: m (B, 1, ...), py, px (B, ...) int64
    """
    d = dx[mapixes]
    extra = (1,) * (xys.dim() - 2)
    px = torch.round(xys[..., 0] / d[:, 0].reshape((-1,) + extra))
    py = torch.round(xys[..., 1] / d[:, 1].reshape((-1,) + extra))
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    px = torch.where(inside, px, 0.0).long()
    py = torch.where(inside, py, 0.0).long()
    return mapixes.reshape((-1,) + extra).long(), py, px


def _pixel_lookup(maps, dx, xys, mapixes):
    """Gather map bytes at world coords: (M, H, W) maps -> (B, ...) uint8."""
    m, py, px = _pixel_index(maps.shape[1], maps.shape[2], dx, xys, mapixes)
    return maps[m, py, px]


def crop_plain(packed, dx, pos, mapixes, lo, wo, num_channels,
               layout="nchw", dtype=torch.float32):
    """Plain version of the map crop (the oracle of the ``map_crop`` kernel).

    :param packed: (M, H, W) uint8 bit-packed raster (bit c = channel c)
    :param pos: (B, 4) UNNORMALIZED (x, y, hx, hy)
    :param lo, wo: (L,), (W,) offsets from :func:`crop_offsets`
    :param dtype: of the output; its 0/1 values are exact in any float type
    :return: (B, C, L, W) ((B, L, W, C) for 'nhwc') of ``dtype``
    """
    xys = rotate_grid(lo[None, :, None], wo[None, None, :], pos[:, :2],
                      pos[:, 2:4])
    xys = torch.where(torch.isnan(xys), 0.0, xys)
    bits = _pixel_lookup(packed, dx, xys, mapixes)  # (B, L, W)
    shifts = torch.arange(num_channels, dtype=torch.uint8, device=pos.device)
    if layout == "nhwc":
        obs = (bits[..., None] >> shifts) & 1
    else:
        obs = (bits[:, None] >> shifts[None, :, None, None]) & 1
    return obs.to(dtype)


def get_map_crop(packed, dx, pos, mapixes, bounds, num_channels, L=256,
                 W=256, layout="nchw", dtype=torch.float32):
    """Oriented local map crop around each pose.

    :param packed: (M, H, W) uint8 bit-packed raster (bit c = channel c)
    :param pos: (B, 4) UNNORMALIZED (x, y, hx, hy)
    :param mapixes: (B,) int
    :param bounds: [low_l, low_w, high_l, high_w] meters
    :param num_channels: channels C to unpack
    :param layout: 'nchw' (reference layout) or 'nhwc' (channels-last)
    :param dtype: float32 or bfloat16 (the bf16 model's compute dtype)
    :return: (B, C, L, W) ((B, L, W, C) for 'nhwc') of ``dtype``
    """
    lo, wo = crop_offsets(bounds, L, W, pos.device)
    if pos.is_cuda:
        from . import crop_kernel

        return crop_kernel.map_crop(packed, dx, pos.contiguous(),
                                    mapixes.long().contiguous(), lo, wo,
                                    num_channels, layout, dtype)
    return crop_plain(packed, dx, pos, mapixes, lo, wo, num_channels, layout,
                      dtype)


def check_on_layer(drivables, dx, cars, lw, mapixes, grid=ON_LAYER_GRID):
    """Fraction of each car footprint on layer==1: (B,) float in [0, 1]."""
    L, W = grid
    xys = gen_car_coords(cars[:, :2], cars[:, 2:4], L, W, ls=lw[:, 0],
                         ws=lw[:, 1])
    pix = _pixel_lookup(drivables, dx, xys, mapixes)
    return torch.sum(pix.float(), dim=(1, 2)) / (L * W)


def check_line_layer(drivables, dx, start, end, mapixes,
                     num_samples=LINE_SAMPLES):
    """True where the segment start->end crosses a 0 (non-drivable) pixel."""
    w = linspace(0.0, 1.0, num_samples, start.device)[None, :, None]
    pts = start[:, None, :] * (1.0 - w) + end[:, None, :] * w
    pix = _pixel_lookup(drivables, dx, pts, mapixes)
    return torch.sum(pix == 0, dim=-1) > 0


def coll_point_plain(packed, dx, cars, lw, mapixes, lin_l, lin_w, bit=0):
    """Plain version of ``get_coll_point`` (the oracle of its kernel).

    :param packed: (M, H, W) bit-packed raster; drivable = bit ``bit``
    :param lin_l, lin_w: (L,), (W,) ``linspace(-1, 1, .)`` grid tables
    """
    L, W = lin_l.shape[0], lin_w.shape[0]
    lwise = lin_l[None, :, None] * (lw[:, 0] / 2.0)[:, None, None]
    wwise = lin_w[None, None, :] * (lw[:, 1] / 2.0)[:, None, None]
    xys_world = rotate_grid(lwise, wwise, cars[:, :2], cars[:, 2:4])
    pix = (_pixel_lookup(packed, dx, xys_world, mapixes) >> bit) & 1
    return _coll_point_from_pix(pix, xys_world, L, W)


def get_coll_point(packed, dx, cars, lw, mapixes, grid=COLL_POINT_GRID):
    """Mean position of non-drivable pixels inside each car footprint.

    :param packed: (M, H, W) bit-packed raster; bit 0 is the drivable layer
    :return coll_pt: (B, 2) world coords (zeros where no sample is off-road)
    :return valid: (B,) True only for cars *partially* off-road
    :return offroad_frac: (B,) fraction of footprint off-road
    """
    L, W = grid
    lin_l = linspace(-1.0, 1.0, L, cars.device)
    lin_w = linspace(-1.0, 1.0, W, cars.device)
    if cars.is_cuda:
        from . import crop_kernel

        return crop_kernel.footprint_coll_point(
            packed, dx, cars.contiguous(), lw.contiguous(),
            mapixes.long().contiguous(), lin_l, lin_w, 0)
    return coll_point_plain(packed, dx, cars, lw, mapixes, lin_l, lin_w)


def _coll_point_from_pix(pix, xys_world, L, W):
    non_drivable = (pix == 0).float()[..., None]  # (B, L, W, 1)
    num_nd = torch.sum(non_drivable, dim=(1, 2))  # (B, 1)
    coll_pt = (torch.sum(xys_world * non_drivable, dim=(1, 2))
               / torch.clamp(num_nd, min=1.0))
    total = float(L * W)
    valid = (num_nd[:, 0] > 0) & (num_nd[:, 0] < total)
    # a tensor divisor: CUDA divides by a Python scalar via its reciprocal
    return coll_pt, valid, num_nd[:, 0] / torch.full_like(num_nd[:, 0], total)
