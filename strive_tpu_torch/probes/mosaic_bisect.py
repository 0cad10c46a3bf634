"""The Mosaic-bisect probes through the K5 kernels.

Counterpart of ``scripts/probe_mosaic_bisect.py``, ``probe_mosaic_bisect2.py``
and ``probe_mosaic_bisect3.py``. Each ``v_*`` there is a minimal Pallas
kernel that bisects which Mosaic construct crashed one TPU toolchain; here
each variant builds its script's own inputs, computes the same function
through one K5 dispatcher of :mod:`.bisect_kernels`, and returns the output
in the script's shape with the script's ``want`` where it has one.

    python -m strive_tpu_torch.probes.mosaic_bisect [--device cpu]

prints the scripts' ``PASS  name  (correct=True)`` lines with the device ms
of each variant.
"""

from __future__ import annotations

import argparse
import json
from collections import namedtuple

import numpy as np
import torch

from . import bisect_kernels as bk
from ..utils import timing

REPS = 20

# a variant's call: the K5 kernel, its arguments, the script's output shape,
# and the script's `want` (None where the script checks nothing)
Case = namedtuple("Case", "kernel args shape want", defaults=(None,))
DISPATCH = {"scale_rows": bk.scale, "window_convert": bk.convert,
            "window_sums": bk.sums, "onehot_rows": bk.onehot}


def _i32(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


def _u8_arange(shape, device):
    """``jnp.arange(n, dtype=int32).astype(uint8)``: the values wrap mod 256."""
    n = int(np.prod(shape))
    return torch.arange(n, dtype=torch.int32, device=device).to(
        torch.uint8).reshape(shape)


# --- probe_mosaic_bisect.py -----------------------------------------------

def v_trivial(device):
    """:30, ``x * 2.0`` on a (128, 128) f32 block."""
    x = torch.ones((128, 128), dtype=torch.float32, device=device)
    f = torch.full((1,), 2.0, device=device)
    return Case("scale_rows", (x, f, 128), (128, 128))


def v_iota_compare_matmul(device):
    """:42, ``w^T @ onehot(idx)``: w (64, 192) bf16, idx (1, 1024)."""
    idx = torch.zeros((1, 1024), dtype=torch.int32, device=device)
    w = torch.ones((1, 64, 192), dtype=torch.bfloat16, device=device)
    return Case("onehot_rows", (w, idx), (192, 1024))


def v_u8_convert(device):
    """:60, u8 -> i32 -> bf16 -> f32 of a (64, 192) block, exact for bytes:
    the whole block as one window, u8 -> f32."""
    x = torch.ones((64, 192), dtype=torch.uint8, device=device)
    z = _i32([0], device)
    return Case("window_convert", (x, z, z, 64, 192, torch.float32),
                (64, 192))


def v_dma_static(device):
    """:73, a 64x192 DMA at (0, 0) of a 1024^2 u8 raster, to i32."""
    x = torch.ones((1024, 1024), dtype=torch.uint8, device=device)
    z = _i32([0], device)
    return Case("window_convert", (x, z, z, 64, 192, torch.int32), (64, 192))


def v_dma_dynamic(device):
    """:91, the same DMA at prefetched (8, 128)."""
    x = torch.ones((1024, 1024), dtype=torch.uint8, device=device)
    return Case("window_convert", (x, _i32([8], device), _i32([128], device),
                                   64, 192, torch.int32), (64, 192))


def v_fori_when_rem(device):
    """:116, rows in groups of 8 scaled by 2 and 3 in turn."""
    x = torch.ones((128, 128), dtype=torch.float32, device=device)
    f = torch.tensor([2.0, 3.0] * 8, device=device)
    return Case("scale_rows", (x, f, 8), (128, 128))


def v_dyn_outer_index(device):
    """:141, ``x[0, t] * 2.0`` for t < 4 of a (1, 4, 1, 1024) f32 array."""
    x = torch.ones((4, 1024), dtype=torch.float32, device=device)
    f = torch.full((1,), 2.0, device=device)
    return Case("scale_rows", (x, f, 4), (1, 4, 1, 1024))


def v_dma_dyn_in_fori(device):
    """:158, the sums of four 64x192 u8 windows at prefetched (0, 0)."""
    x = torch.ones((1024, 1024), dtype=torch.uint8, device=device)
    z = torch.zeros((4, 1), dtype=torch.int32, device=device)
    return Case("window_sums", (x, z, z, _i32([1], device), 64, 192), (1, 4))


# --- probe_mosaic_bisect2.py ----------------------------------------------

def _block_sums_want(x, rows, cols, WR, WC):
    """The scripts' ``jnp.sum(x[r*WR:(r+1)*WR, c*WC:(c+1)*WC],
    dtype=int32)`` per (r, c)."""
    return bk.wrap_int32(torch.stack([
        x[r * WR:(r + 1) * WR, c * WC:(c + 1) * WC].long().sum()
        for r, c in zip(rows, cols)]))


def v_prefetch_indexmap(device):
    """:34, sums of 64x128 blocks (rb, cb) of an i32 ``arange(1024^2)``;
    block (7, 0) sums past 2^31 and wraps."""
    x = torch.arange(1024 * 1024, dtype=torch.int32,
                     device=device).reshape(1024, 1024)
    rb, cb = [3, 0, 7, 2], [1, 5, 0, 4]
    row0 = _i32([[r * 64] for r in rb], device)
    col0 = _i32([[c * 128] for c in cb], device)
    return Case("window_sums", (x, row0, col0, _i32([1], device), 64, 128),
                (4,), _block_sums_want(x, rb, cb, 64, 128))


def v_prefetch_indexmap_u8(device):
    """:149, sums of 32x128 blocks of a seeded (2048, 1024) u8 raster."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2048, 1024)).astype(
        np.uint8)).to(device)
    rb, cb = [3, 17, 7, 31], [1, 5, 0, 4]
    row0 = _i32([[r * 32] for r in rb], device)
    col0 = _i32([[c * 128] for c in cb], device)
    return Case("window_sums", (x, row0, col0, _i32([1], device), 32, 128),
                (4,), _block_sums_want(x, rb, cb, 32, 128))


def v_same_array_two_specs(device):
    """:65, block rb minus block rb + 1 of the i32 ``arange``: two windows
    per output with signs +1 and -1 (both sums wrap)."""
    x = torch.arange(1024 * 1024, dtype=torch.int32,
                     device=device).reshape(1024, 1024)
    rb = [3, 0]
    row0 = _i32([[r * 64, (r + 1) * 64] for r in rb], device)
    col0 = torch.zeros((2, 2), dtype=torch.int32, device=device)
    want = bk.wrap_int32(
        _block_sums_want(x, rb, [0, 0], 64, 128).long()
        - _block_sums_want(x, [r + 1 for r in rb], [0, 0], 64, 128).long())
    return Case("window_sums",
                (x, row0, col0, _i32([1, -1], device), 64, 128), (2,), want)


def _f32_sublane_read(device, r):
    x = torch.arange(256 * 128, dtype=torch.float32,
                     device=device).reshape(256, 128)
    return Case("window_convert", (x, _i32([r], device), _i32([0], device),
                                   64, 128, torch.float32),
                (64, 128), x[r:r + 64])


def v_dyn_sublane_read(device):
    """:98, rows 64..127 of a (256, 128) f32 array."""
    return _f32_sublane_read(device, 64)


def v_dyn_sublane_read_unaligned(device):
    """:115, rows 37..100."""
    return _f32_sublane_read(device, 37)


def v_dyn_lane_read(device):
    """:132, columns 128..255 of a (64, 512) f32 array."""
    x = torch.arange(64 * 512, dtype=torch.float32,
                     device=device).reshape(64, 512)
    return Case("window_convert", (x, _i32([0], device), _i32([128], device),
                                   64, 128, torch.float32),
                (64, 128), x[:, 128:256])


# --- probe_mosaic_bisect3.py ----------------------------------------------

def v_u8_scratch_store_read(device):
    """:28, a (64, 128) u8 block twice side by side, to i32: two windows at
    the same start through an output row of 256."""
    x = _u8_arange((64, 128), device)
    z = _i32([0, 0], device)
    return Case("window_convert", (x, z, z, 64, 128, torch.int32, True),
                (64, 256), torch.cat([x, x], 1).int())


def _u8_sublane_read(device, r):
    x = _u8_arange((128, 256), device)
    return Case("window_convert", (x, _i32([r], device), _i32([0], device),
                                   64, 256, torch.int32),
                (64, 256), x[r:r + 64].int())


def v_u8_dyn_sublane_read(device):
    """:48, rows 24..87 of a (128, 256) u8 array, to i32."""
    return _u8_sublane_read(device, 24)


def v_u8_dyn_sublane_read_32aligned(device):
    """:65, rows 32..95."""
    return _u8_sublane_read(device, 32)


def v_i32_dyn_sublane_scratch(device):
    """:82, rows 24..87, converted before the read in the script."""
    return _u8_sublane_read(device, 24)


def v_4d_idx_block(device):
    """:102, ``x * 2`` of an i32 ``arange`` of shape (2, 3, 1, 1024)."""
    x = torch.arange(6 * 1024, dtype=torch.int32,
                     device=device).reshape(6, 1024)
    return Case("scale_rows", (x, _i32([2], device), 6), (2, 3, 1, 1024),
                (x * 2).reshape(2, 3, 1, 1024))


# (script, the label it prints, variant), in the order the scripts run them
VARIANTS = [
    ("probe_mosaic_bisect", "trivial", v_trivial),
    ("probe_mosaic_bisect", "iota_compare_matmul", v_iota_compare_matmul),
    ("probe_mosaic_bisect", "u8_convert", v_u8_convert),
    ("probe_mosaic_bisect", "dma_static", v_dma_static),
    ("probe_mosaic_bisect", "dma_dynamic_prefetch", v_dma_dynamic),
    ("probe_mosaic_bisect", "fori_when_rem", v_fori_when_rem),
    ("probe_mosaic_bisect", "dyn_outer_index", v_dyn_outer_index),
    ("probe_mosaic_bisect", "dma_dyn_in_fori", v_dma_dyn_in_fori),
    ("probe_mosaic_bisect2", "prefetch_indexmap", v_prefetch_indexmap),
    ("probe_mosaic_bisect2", "prefetch_indexmap_u8", v_prefetch_indexmap_u8),
    ("probe_mosaic_bisect2", "same_array_two_specs", v_same_array_two_specs),
    ("probe_mosaic_bisect2", "dyn_sublane_read_aligned", v_dyn_sublane_read),
    ("probe_mosaic_bisect2", "dyn_sublane_read_unaligned",
     v_dyn_sublane_read_unaligned),
    ("probe_mosaic_bisect2", "dyn_lane_read", v_dyn_lane_read),
    ("probe_mosaic_bisect3", "u8_scratch_store_read",
     v_u8_scratch_store_read),
    ("probe_mosaic_bisect3", "u8_dyn_sublane_read", v_u8_dyn_sublane_read),
    ("probe_mosaic_bisect3", "u8_dyn_sublane_read_32aligned",
     v_u8_dyn_sublane_read_32aligned),
    ("probe_mosaic_bisect3", "i32_dyn_sublane_scratch",
     v_i32_dyn_sublane_scratch),
    ("probe_mosaic_bisect3", "4d_idx_block", v_4d_idx_block),
]


def output(variant, device):
    """One variant through its K5 dispatcher.

    :return: (the output in the script's shape, the script's want or None)
    """
    case = variant(device)
    return DISPATCH[case.kernel](*case.args).reshape(case.shape), case.want


def run(device="cuda"):
    """All 19 variants: each against its plain version (``torch.equal``,
    dtype too) and the script's ``want``, then timed. Each variant calls
    its kernel once to check, then ``timing.calls(REPS)`` times. Raises on
    any mismatch.

    :return: {"device", "variants": [{name, kernel, ms, correct}], "lines"}
    """
    device = torch.device(device)
    records, lines = [], []
    for script, label, variant in VARIANTS:
        case = variant(device)
        kernel = DISPATCH[case.kernel]
        plain = getattr(bk, f"{case.kernel}_plain")
        got = kernel(*case.args).reshape(case.shape)
        ref = plain(*case.args).reshape(case.shape)
        for what, other in (("plain", ref), ("want", case.want)):
            if other is not None and (got.dtype != other.dtype
                                      or not torch.equal(got, other)):
                raise AssertionError(f"{script} {label}: the output differs "
                                     f"from {what}")
        ms = timing.device_ms(lambda: kernel(*case.args), REPS, device)
        records.append(dict(name=variant.__name__, script=script,
                            kernel=case.kernel, ms=ms, correct=True))
        lines.append(f"PASS  {label}  (correct=True)  {ms:.4f} ms")
    return {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "variants": records, "lines": lines}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    print(f"device: {result['device']}")
    print("\n".join(result["lines"]))
    print(json.dumps({k: v for k, v in result.items() if k != "lines"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
