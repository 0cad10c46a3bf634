"""Wrappers of the Hopper kernels of ``csrc/bisect.cu`` (K5), their plain
versions, and one dispatcher per function.

The 19 ``v_*`` Pallas kernels of ``scripts/probe_mosaic_bisect.py``,
``probe_mosaic_bisect2.py`` and ``probe_mosaic_bisect3.py`` each bisect a
Mosaic construct; under the construct they compute four functions:

- K5a ``scale_rows``: ``out[r, c] = x[r, c] * f[r // G]``, f32 or i32;
- K5b ``window_convert``: ``out[n, i, j] = src[row0[n] + i, col0[n] + j]``
  converted, u8 -> i32, u8 -> f32 or f32 -> f32;
- K5c ``window_sums``: ``out[g] = sum_k sign[k] * sum(window(g, k))``,
  int32 modulo 2^32;
- K5d ``onehot_rows``: ``out[t, c, p] = float(w[t, idx[t, p], c])``, 0
  where the index is outside ``[0, R)``.

The design notes and bounds are in the CUDA source. Each wrapper takes CUDA
tensors only: it checks them, allocates its output, launches on the current
stream, raises if the launch failed, and adds one to ``LAUNCHES[name]``.
Each plain version (same signature, any device) is the function its kernel
must match bit for bit. The dispatchers ``scale``, ``convert``, ``sums`` and
``onehot`` send CUDA tensors to the kernel and CPU tensors to the plain
version. Window starts are taken as ``lax.dynamic_slice`` takes them
(:func:`window_kernels.slice_start`).
"""

from __future__ import annotations

import functools

import torch

from ..utils import launch
from ..utils.launch import INT as _I, PTR as _P
from .window_kernels import slice_start

SOURCE = "bisect"

# launches per kernel, counted where the kernel is launched and nowhere else
LAUNCHES = {"scale_rows": 0, "window_convert": 0, "window_sums": 0,
            "onehot_rows": 0}

_LIB = launch.Library(SOURCE, {
    # x, f, dtype, R, C, G, out, stream
    "strive_scale_rows": [_P, _P, _I, _I, _I, _I, _P, _P],
    # src, src_type, R, C, row0, col0, N, WR, WC, out_type, side_by_side,
    # out, stream
    "strive_window_convert": [_P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                              _P],
    # src, src_type, R, C, row0, col0, sign, G, K, WR, WC, out, stream
    "strive_window_sums": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                           _P],
    # w, idx, T, R, C, P, cg, pitch, out, stream
    "strive_onehot_rows": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
})
# dtype codes of the CUDA source
_CODE = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}
_CONVERSIONS = {(torch.uint8, torch.int32), (torch.uint8, torch.float32),
                (torch.float32, torch.float32)}
_SMEM_BYTES = 232448  # what one block may use on an H100


def _fits_int32(*counts):
    if any(c >= 2 ** 31 for c in counts):
        raise ValueError("the bisect kernels index with int32: fewer than "
                         "2^31 elements per array")


def _check_window(R, C, WR, WC):
    if not (0 < WR <= R and 0 < WC <= C):
        raise ValueError(f"window {WR}x{WC} does not fit the array {R}x{C}")


def wrap_int32(s):
    """An int64 tensor modulo 2^32, as int32 (what an int32 sum wraps to)."""
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


# --- K5a: row-group scale -------------------------------------------------

def scale_rows(x, f, G):
    """K5a: ``out[r, c] = x[r, c] * f[r // G]``; an f32 product rounds once,
    an i32 product wraps.

    :param x: (R, C) float32 or int32
    :param f: (R // G,) of x's dtype
    :param G: rows per group; divides R
    :return: (R, C) of x's dtype
    """
    device = x.device
    launch.check("x", x, (torch.float32, torch.int32), 2, device)
    launch.check("f", f, x.dtype, 1, device)
    (R, C), G = x.shape, int(G)
    if G <= 0 or R % G or f.shape[0] != R // G:
        raise ValueError(f"f must have one factor per group of {G} of the "
                         f"{R} rows")
    _fits_int32(R * C)
    out = torch.empty_like(x)
    if R * C == 0:
        return out
    _LIB.launch("strive_scale_rows", x.data_ptr(), f.data_ptr(),
                _CODE[x.dtype], R, C, G, out.data_ptr(),
                launch.stream(device))
    LAUNCHES["scale_rows"] += 1
    return out


def scale_rows_plain(x, f, G):
    """Plain PyTorch version of :func:`scale_rows` (any device)."""
    R, C = x.shape
    return (x.reshape(R // G, G, C) * f[:, None, None]).reshape(R, C)


def scale(x, f, G):
    """K5a for CUDA tensors, its plain version for CPU tensors."""
    fn = scale_rows if x.is_cuda else scale_rows_plain
    return fn(x, f, G)


# --- K5b: window convert --------------------------------------------------

def window_convert(src, row0, col0, WR, WC, out_dtype, side_by_side=False):
    """K5b: the WR x WC window of ``src`` at each (row0[n], col0[n]),
    converted to ``out_dtype``.

    :param src: (R, C) uint8 or float32
    :param row0, col0: (N,) int32 starts (:func:`slice_start`)
    :param out_dtype: int32 or float32 for uint8, float32 for float32
    :param side_by_side: lay the windows side by side in one (WR, N * WC)
        output (window n in columns n*WC to (n+1)*WC) instead of (N, WR, WC)
    """
    device = row0.device
    launch.check("src", src, (torch.uint8, torch.float32), 2, device)
    launch.check("row0", row0, torch.int32, 1, device)
    launch.check("col0", col0, torch.int32, 1, device)
    if (src.dtype, out_dtype) not in _CONVERSIONS:
        raise ValueError(f"window_convert does not convert {src.dtype} to "
                         f"{out_dtype}")
    (R, C), N, WR, WC = src.shape, row0.shape[0], int(WR), int(WC)
    if col0.shape != row0.shape:
        raise ValueError("row0 and col0 must have one entry per window")
    _check_window(R, C, WR, WC)
    if (WR + 15) // 16 > 65535:
        raise ValueError("window_convert takes windows of at most 2^20 rows")
    _fits_int32(R * C, N * WR * WC)
    shape = (WR, N * WC) if side_by_side else (N, WR, WC)
    out = torch.empty(shape, dtype=out_dtype, device=device)
    if N == 0:
        return out
    _LIB.launch("strive_window_convert", src.data_ptr(), _CODE[src.dtype], R,
                C, row0.data_ptr(), col0.data_ptr(), N, WR, WC,
                _CODE[out_dtype], int(side_by_side), out.data_ptr(),
                launch.stream(device))
    LAUNCHES["window_convert"] += 1
    return out


def window_convert_plain(src, row0, col0, WR, WC, out_dtype,
                         side_by_side=False):
    """Plain PyTorch version of :func:`window_convert` (any device)."""
    (R, C), N = src.shape, row0.shape[0]
    rows = slice_start(row0, R, WR)[:, None] + torch.arange(WR,
                                                            device=src.device)
    cols = slice_start(col0, C, WC)[:, None] + torch.arange(WC,
                                                            device=src.device)
    out = src[rows[:, :, None], cols[:, None, :]].to(out_dtype)
    return out.transpose(0, 1).reshape(WR, N * WC) if side_by_side else out


def convert(src, row0, col0, WR, WC, out_dtype, side_by_side=False):
    """K5b for CUDA tensors, its plain version for CPU tensors."""
    fn = window_convert if row0.is_cuda else window_convert_plain
    return fn(src, row0, col0, WR, WC, out_dtype, side_by_side)


# --- K5c: window sums -----------------------------------------------------

def window_sums(src, row0, col0, sign, WR, WC):
    """K5c: ``out[g] = sum_k sign[k] * sum(src[r:r+WR, c:c+WC])`` with
    (r, c) = (row0[g, k], col0[g, k]), modulo 2^32 as int32 (an int32 sum
    wraps; modular addition is exact in any order).

    One block an output reads the window rows in aligned pieces, masked
    at the window's edges: 16-byte vectors where ``C * src.element_size()``
    and ``src``'s address are multiples of 16, else 4-byte words where they
    are multiples of 4, else bytes. While G is at most the card's SM count
    the block is a wide one (its rows spread over more threads); the design
    note in ``csrc/bisect.cu`` says why.

    :param src: (R, C) uint8 or int32
    :param row0, col0: (G, K) int32 starts (:func:`slice_start`)
    :param sign: (K,) int32
    :return: (G,) int32
    """
    device = row0.device
    launch.check("src", src, (torch.uint8, torch.int32), 2, device)
    launch.check("row0", row0, torch.int32, 2, device)
    launch.check("col0", col0, torch.int32, 2, device)
    launch.check("sign", sign, torch.int32, 1, device)
    (R, C), (G, K), WR, WC = src.shape, row0.shape, int(WR), int(WC)
    if col0.shape != row0.shape or sign.shape[0] != K:
        raise ValueError("col0 must be (G, K) as row0 is, and sign (K,)")
    _check_window(R, C, WR, WC)
    _fits_int32(R * C, G * K)
    out = torch.empty(G, dtype=torch.int32, device=device)
    if G == 0:
        return out
    _LIB.launch("strive_window_sums", src.data_ptr(), _CODE[src.dtype], R, C,
                row0.data_ptr(), col0.data_ptr(), sign.data_ptr(), G, K, WR,
                WC, out.data_ptr(), launch.stream(device))
    LAUNCHES["window_sums"] += 1
    return out


def window_sums_plain(src, row0, col0, sign, WR, WC):
    """Plain PyTorch version of :func:`window_sums` (any device): the sums
    in int64, wrapped to int32."""
    R, C = src.shape
    rows = slice_start(row0, R, WR)[..., None] + torch.arange(
        WR, device=src.device)
    cols = slice_start(col0, C, WC)[..., None] + torch.arange(
        WC, device=src.device)
    win = src[rows[..., :, None], cols[..., None, :]]  # (G, K, WR, WC)
    return wrap_int32((win.long().sum((2, 3)) * sign.long()).sum(1))


def sums(src, row0, col0, sign, WR, WC):
    """K5c for CUDA tensors, its plain version for CPU tensors."""
    fn = window_sums if row0.is_cuda else window_sums_plain
    return fn(src, row0, col0, sign, WR, WC)


# --- K5d: one-hot row gather ----------------------------------------------

# K5d's launch: threads a block (csrc/bisect.cu kOnehotThreads), each taking
# ONEHOT_POINTS consecutive points; the most blocks along grid y and z; the
# shared memory a block gets without opting in
ONEHOT_THREADS = 256
ONEHOT_POINTS = 4
_GRID_YZ = 65535
_DEFAULT_SMEM_BYTES = 48 * 1024


def _smem_pitch(C):
    """Shared-memory row pitch in bf16 elements: >= C, an odd number of
    32-bit words (so 32 different rows fall in 32 different banks)."""
    pitch = C + C % 2
    return pitch + 2 if pitch // 2 % 2 == 0 else pitch


def onehot_launch(T, R, C, P, sms, cg=None):
    """K5d's launch for (T, R, C) ``w`` and (T, P) ``idx`` on a card of
    ``sms`` SMs: ``cg`` channels a block, unless given as few as keep every
    SM busy (one channel a block at the bisect scripts' T = 1, P = 1024,
    C = 192; every channel at the gather-probe path's 2048 tiles), within
    48 KB of shared memory and 65,535 groups; ``grid`` = (T, bands of
    ONEHOT_THREADS x ONEHOT_POINTS points, channel groups), as
    ``strive_onehot_rows`` launches it; ``pitch`` and ``smem``, the staged
    columns' row pitch (bf16 elements, passed to the kernel) and bytes.

    :param cg: a group of 1 to C channels (the launch-shape sweep and the
        CPU model of the blocks set it)
    :raise ValueError: where ``cg`` or the grid or the shared memory is out
        of range
    """
    bands = -(-P // (ONEHOT_THREADS * ONEHOT_POINTS))
    if cg is None:
        cg = min(C, max(1, C * T * bands // sms))
        if R:  # the pitch is at most cg + 3
            cg = min(cg, max(1, _DEFAULT_SMEM_BYTES // (2 * R) - 3))
        cg = max(cg, -(-C // _GRID_YZ))
    if not 1 <= cg <= C:
        raise ValueError(f"onehot_rows: a grid of {cg} of {C} channels a "
                         "block")
    pitch = _smem_pitch(cg)
    shape = {"cg": cg, "grid": (T, bands, -(-C // cg)), "pitch": pitch,
             "smem": R * pitch * 2}
    if max(shape["grid"][1:]) > _GRID_YZ:
        raise ValueError(f"onehot_rows: grid {shape['grid']} past "
                         f"{_GRID_YZ} blocks along y or z")
    if shape["smem"] > _SMEM_BYTES:
        raise ValueError(f"w[t]'s {R} rows exceed a block's shared memory")
    return shape


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def onehot_rows(w, idx):
    """K5d: ``out[t, c, p] = float(w[t, idx[t, p], c])`` where ``0 <= idx <
    R``, else 0: the function of ``w[t]^T @ onehot(idx[t])``, computed as a
    gather. It differs from the product only for non-finite w (0 * Inf is
    NaN in the product) and in the sign of a zero.

    :param w: (T, R, C) bfloat16
    :param idx: (T, P) int32
    :return: (T, C, P) float32
    """
    device = idx.device
    launch.check("w", w, torch.bfloat16, 3, device)
    launch.check("idx", idx, torch.int32, 2, device)
    (T, R, C), P = w.shape, idx.shape[1]
    if idx.shape[0] != T:
        raise ValueError("idx must have one row per w[t]")
    _fits_int32(T * R * C, T * C * P)
    if T * C * P == 0:
        return torch.empty((T, C, P), dtype=torch.float32, device=device)
    return _onehot_rows_at(w, idx, onehot_launch(T, R, C, P,
                                                 _sm_count(device)))


def _onehot_rows_at(w, idx, shape):
    """K5d launched at ``shape`` (:func:`onehot_launch`'s result) on checked
    tensors; ``tools/kernel_variants.py`` sweeps its groups through this."""
    (T, R, C), P = w.shape, idx.shape[1]
    out = torch.empty((T, C, P), dtype=torch.float32, device=idx.device)
    _LIB.launch("strive_onehot_rows", w.data_ptr(), idx.data_ptr(), T, R, C,
                P, shape["cg"], shape["pitch"], out.data_ptr(),
                launch.stream(idx.device))
    LAUNCHES["onehot_rows"] += 1
    return out


def onehot_rows_plain(w, idx):
    """Plain PyTorch version of :func:`onehot_rows` (any device)."""
    T, R, _ = w.shape
    t = torch.arange(T, device=w.device)[:, None]
    rows = w[t, idx.long().clamp(0, R - 1)].float()  # (T, P, C)
    valid = ((idx >= 0) & (idx < R))[..., None]
    return torch.where(valid, rows, 0.0).transpose(1, 2)


def onehot(w, idx):
    """K5d for CUDA tensors, its plain version for CPU tensors."""
    fn = onehot_rows if idx.is_cuda else onehot_rows_plain
    return fn(w, idx)
