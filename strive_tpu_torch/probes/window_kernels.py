"""Wrappers of the Hopper window kernels of ``csrc/window.cu``, their plain
versions, and one dispatcher per function.

- K3 ``window_crop_tiles`` replaces ``crop_onehot`` of
  ``scripts/probe_onehot_crop.py`` and ``scripts/probe_onehot_crop2.py``;
- K4a ``window_extract`` replaces ``extract_pallas`` of
  ``scripts/pallas_gather_probe2.py`` and the window-DMA kernel of
  ``scripts/pallas_gather_probe3.py``;
- K4b ``window_take`` replaces the kernels of ``make`` in
  ``scripts/pallas_gather_probe.py``.

The design notes and bounds are in the CUDA source. Each wrapper takes CUDA
tensors only: it checks them, allocates its output, launches on the current
stream, raises if the launch failed, and adds one to ``LAUNCHES[name]``.
Each plain version (same signature, any device) is the function its kernel
must match bit for bit. The dispatchers ``crop_tiles``, ``extract`` and
``take`` send CUDA tensors to the kernel and CPU tensors to the plain
version.

Window starts are taken as ``lax.dynamic_slice`` takes them
(:func:`slice_start`: a negative start counts from the end once, then the
start is clamped into ``[0, extent - window]``); indices are clamped into
their window as ``jnp.take(mode="clip")`` clamps them.
"""

from __future__ import annotations

import torch

from ..utils import launch
from ..utils.launch import INT as _I, PTR as _P

SOURCE = "window"

# launches per kernel, counted where the kernel is launched and nowhere else
LAUNCHES = {"window_crop_tiles": 0, "window_extract": 0, "window_take": 0}

_LIB = launch.Library(SOURCE, {
    # flat, R, Wp, row0, col0, ly, lx, tiles, P, WR, WC, out, stream
    "strive_window_crop_tiles": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P, _P],
    # raster, elem_size, R, Wp, row0, col0, N, WIN, out, stream
    "strive_window_extract": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P],
    # wins, elem_size, N, S, idx, Q, out, stream
    "strive_window_take": [_P, _I, _I, _I, _P, _I, _P, _P],
})
_DTYPES = (torch.uint8, torch.int32)
_SMEM_BYTES = 232448  # what one block may use on an H100


def slice_start(start, extent, win):
    """Window starts as ``lax.dynamic_slice`` takes them (int64)."""
    start = start.long()
    return torch.where(start < 0, start + extent, start).clamp(0, extent - win)


def _fits_int32(*counts):
    if any(c >= 2 ** 31 for c in counts):
        raise ValueError("the window kernels index with int32: fewer than "
                         "2^31 elements per array")


# --- K3: tiled window crop ------------------------------------------------

def window_crop_tiles(flat, row0, col0, ly, lx, WR, WC):
    """K3: per tile, gather bytes at window-local (ly, lx) from the WR x WC
    window of the raster at (row0, col0), as float32.

    :param flat: (R, Wp) uint8 raster; Wp a multiple of 16
    :param row0, col0: (N, T) int32 window origins (:func:`slice_start`)
    :param ly, lx: (N, T, P) int32 window-local indices, clamped into the
        window
    :return: (N, T, P) float32
    """
    device = ly.device
    launch.check("flat", flat, torch.uint8, 2, device)
    launch.check("row0", row0, torch.int32, 2, device)
    launch.check("col0", col0, torch.int32, 2, device)
    launch.check("ly", ly, torch.int32, 3, device)
    launch.check("lx", lx, torch.int32, 3, device)
    R, Wp = flat.shape
    N, T, P = ly.shape
    if lx.shape != ly.shape or row0.shape != (N, T) or col0.shape != (N, T):
        raise ValueError("row0/col0 must be (N, T) and lx the shape of ly")
    WR, WC = int(WR), int(WC)
    if not (0 < WR <= R and 0 < WC <= Wp):
        raise ValueError(f"window {WR}x{WC} does not fit the raster {R}x{Wp}")
    if Wp % 16 or flat.data_ptr() % 16:
        raise ValueError("the raster's rows must start on 16-byte boundaries "
                         f"(Wp = {Wp} must be a multiple of 16)")
    pitch = (WC + 30) // 16 * 16  # window row + the shift to 16-byte chunks
    if WR * pitch > _SMEM_BYTES:
        raise ValueError(f"window {WR}x{WC} exceeds a block's shared memory")
    _fits_int32(R * Wp, N * T * P)
    out = torch.empty((N, T, P), dtype=torch.float32, device=device)
    if N * T * P == 0:
        return out
    _LIB.launch("strive_window_crop_tiles", flat.data_ptr(), R, Wp,
                row0.data_ptr(), col0.data_ptr(), ly.data_ptr(), lx.data_ptr(),
                N * T, P, WR, WC, out.data_ptr(), launch.stream(device))
    LAUNCHES["window_crop_tiles"] += 1
    return out


def window_crop_tiles_plain(flat, row0, col0, ly, lx, WR, WC):
    """Plain PyTorch version of :func:`window_crop_tiles` (any device)."""
    R, Wp = flat.shape
    r0 = slice_start(row0, R, WR)[..., None]
    c0 = slice_start(col0, Wp, WC)[..., None]
    return flat[r0 + ly.clamp(0, WR - 1), c0 + lx.clamp(0, WC - 1)].float()


def crop_tiles(flat, row0, col0, ly, lx, WR, WC):
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    fn = window_crop_tiles if ly.is_cuda else window_crop_tiles_plain
    return fn(flat, row0, col0, ly, lx, WR, WC)


# --- K4a: window extract --------------------------------------------------

def window_extract(raster, row0, col0, WIN):
    """K4a: one WIN x WIN window of the raster per agent.

    :param raster: (R, Wp) uint8 or int32; an (M, H, W) raster goes in as
        (M*H, W) with ``row0 = m*H + y0`` (see ``gather.map_origins``)
    :param row0, col0: (N,) int32 starts (:func:`slice_start`)
    :param WIN: window side; ``WIN * element size`` a multiple of 16 bytes
    :return: (N, WIN, WIN) of the raster's dtype
    """
    device = row0.device
    launch.check("raster", raster, _DTYPES, 2, device)
    launch.check("row0", row0, torch.int32, 1, device)
    launch.check("col0", col0, torch.int32, 1, device)
    R, Wp = raster.shape
    N, WIN = row0.shape[0], int(WIN)
    if col0.shape != row0.shape:
        raise ValueError("row0 and col0 must have one entry per agent")
    if not 0 < WIN <= min(R, Wp):
        raise ValueError(f"window {WIN} does not fit the raster {R}x{Wp}")
    if WIN * raster.element_size() % 16:
        raise ValueError(f"a window row of {WIN} x {raster.element_size()} "
                         "bytes is not a whole number of 16-byte vectors")
    if N > 65535:
        raise ValueError("window_extract takes at most 65535 agents")
    _fits_int32(R * Wp, N * WIN * WIN)
    out = torch.empty((N, WIN, WIN), dtype=raster.dtype, device=device)
    if N == 0:
        return out
    _LIB.launch("strive_window_extract", raster.data_ptr(),
                raster.element_size(), R, Wp, row0.data_ptr(), col0.data_ptr(),
                N, WIN, out.data_ptr(), launch.stream(device))
    LAUNCHES["window_extract"] += 1
    return out


def window_extract_plain(raster, row0, col0, WIN):
    """Plain PyTorch version of :func:`window_extract` (any device)."""
    R, Wp = raster.shape
    ar = torch.arange(WIN, device=raster.device)
    rows = slice_start(row0, R, WIN)[:, None] + ar
    cols = slice_start(col0, Wp, WIN)[:, None] + ar
    return raster[rows[:, :, None], cols[:, None, :]]


def extract(raster, row0, col0, WIN):
    """K4a for CUDA tensors, its plain version for CPU tensors."""
    fn = window_extract if row0.is_cuda else window_extract_plain
    return fn(raster, row0, col0, WIN)


# --- K4b: window take -----------------------------------------------------

def window_take(wins, idx):
    """K4b: ``out[n, q] = wins[n, clamp(idx[n, q], 0, S - 1)]``, which is
    ``jnp.take(wins[n], idx[n], mode="clip")`` per agent.

    :param wins: (N, S) uint8 or int32 flattened windows
    :param idx: (N, Q) int32
    :return: (N, Q) of the windows' dtype
    """
    device = idx.device
    launch.check("wins", wins, _DTYPES, 2, device)
    launch.check("idx", idx, torch.int32, 2, device)
    (N, S), Q = wins.shape, idx.shape[1]
    if idx.shape[0] != N:
        raise ValueError("idx must have one row per window")
    if S == 0:
        raise ValueError("window_take takes non-empty windows")
    _fits_int32(N * S, N * Q)
    out = torch.empty((N, Q), dtype=wins.dtype, device=device)
    if N * Q == 0:
        return out
    _LIB.launch("strive_window_take", wins.data_ptr(), wins.element_size(), N,
                S, idx.data_ptr(), Q, out.data_ptr(), launch.stream(device))
    LAUNCHES["window_take"] += 1
    return out


def window_take_plain(wins, idx):
    """Plain PyTorch version of :func:`window_take` (any device)."""
    return torch.gather(wins, 1, idx.long().clamp(0, wins.shape[1] - 1))


def take(wins, idx):
    """K4b for CUDA tensors, its plain version for CPU tensors."""
    fn = window_take if idx.is_cuda else window_take_plain
    return fn(wins, idx)
