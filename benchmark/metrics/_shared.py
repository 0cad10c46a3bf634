"""What the readers of one quantity split by cell have in common."""

from __future__ import annotations

import torch

from benchmark.harness import raster
from benchmark.metrics import _counts

K1 = "map_crop_kernel"  # K1 of strive_tpu_torch/csrc/crop.cu


def k1_roofline_pct(run):
    """K1's least time for the bytes of its recorded launches in the
    profiled span (``_counts.crop_bytes`` at 3.35 TB/s: no arithmetic of
    K1's bounds it) over the device time of the kernels named ``K1``,
    in %; None without a profile or a launch."""
    p = run.profile
    if p is None or not p["k1"]:
        return None
    t = sum(v for n, v in p["kernel_s"].items() if K1 in n)
    if t <= 0:
        return None
    r, dx = raster(run.cfg["store"], run.device)
    shape = (r.shape[0],) + tuple(r.shape[2:])
    nbytes = sum(_counts.crop_bytes(shape, dx, pos, mapix, lo, wo, c,
                                    torch.finfo(dt).bits // 8)
                 for pos, mapix, lo, wo, c, dt in p["k1"])
    return 100.0 * nbytes / _counts.PEAK_HBM_BYTES / t


def device_idle_pct(run):
    """The share of the profiled span in which no kernel, copy or set ran
    on the card (the union of device intervals), in %."""
    p = run.profile
    if p is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])


def mfu_pct(run, flops):
    """``flops`` over the window's wall time x 67 TFLOP/s (H100 SXM
    float32 without tensor cores, the precision the cells compute in),
    in %."""
    return 100.0 * flops / (run.window_s * _counts.PEAK_FP32_FLOPS)
