"""Per-agent windows cut out of the raster (K4a), then gathered from (K4b).

Counterpart of the TPU gather probes, each at its own sizes and with its
own seeded inputs:

- ``scripts/pallas_gather_probe.py``: take from int32 windows of 512^2;
- ``scripts/pallas_gather_probe3.py``: take at WIN 512, 576 and 640 on
  int32 and at 512 on uint8, then the window extract at WIN 512 from the
  flat (M*H, W) uint8 raster;
- ``scripts/pallas_gather_probe2.py``: the window extract at WIN 640 from
  an (M, H, W) raster, uint8 and int32, the take from those windows, and
  extract + take fused.

Every step is held bit for bit against its plain version and timed.

    python -m strive_tpu_torch.probes.gather [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import gelem_s
from . import window_kernels as wk
from ..utils import timing

# the scripts' sizes: N agents, L x W gathered points per agent, an
# (M, H, Wp) raster; the window sides of each probe
SIZES = dict(N=32, L=256, W=256, M=2, H=2048, Wp=2048, take_wins=(512,),
             take_wins3=(512, 576, 640), extract_win3=512, extract_win2=640)
REPS = 20


def map_origins(mapix, y0, x0, H, WIN):
    """Starts in the flat (M*H, Wp) raster of windows taken from raster[m]
    at (y0, x0): y0 is taken inside map m as ``lax.dynamic_slice`` on
    ``raster[m]`` takes it (the extract takes the column itself)."""
    return (mapix * H + wk.slice_start(y0, H, WIN)).int(), x0.int()


class _Probe:
    """Checks each step against its plain version, times it, and keeps the
    scripts' report lines."""

    def __init__(self, device):
        self.device = device
        self.records, self.lines = [], []

    def tensor(self, a):
        return torch.from_numpy(a).to(self.device)

    def step(self, label, fn, plain, n, **info):
        """Check ``fn`` against ``plain`` (one call), then time it
        (``timing.calls(REPS)`` calls); ``n`` elements per call give its
        G elem/s. :return: the checked result"""
        got, want = fn(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: {int((got != want).sum())} of "
                                 f"{got.numel()} values differ from plain")
        ms = timing.device_ms(fn, REPS, self.device)
        rate = gelem_s(n, ms)
        self.records.append(dict(step=label, ms=ms, gelem_s=rate,
                                 correct=True, **info))
        self.lines.append(f"pallas_gather_probe{info['probe']}: {label}: "
                          f"{ms:8.3f} ms ({rate:6.2f} G elem/s) correct=True")
        return got


def _take_step(p, label, wins, idx, **info):
    N = wins.shape[0]
    w, i = wins.reshape(N, -1), idx.reshape(N, -1)
    return p.step(label, lambda: wk.take(w, i),
                  lambda: wk.window_take_plain(w, i), idx.numel(),
                  **info)


def probe1(p, s):
    """``pallas_gather_probe.py:30-37``: take from int32 windows."""
    rng = np.random.default_rng(0)
    N, L, W, WIN = s["N"], s["L"], s["W"], s["take_wins"][0]
    win = p.tensor(rng.integers(0, 16, (N, WIN, WIN)).astype(np.int32))
    idx = p.tensor(rng.integers(0, WIN * WIN, (N, L, W)).astype(np.int32))
    _take_step(p, f"take WIN={WIN} i32", win, idx, probe=1, win=WIN,
               dtype="i32")


def probe3(p, s):
    """``pallas_gather_probe3.py:36-118``: take vs window size, uint8
    take, and the extract from the flat raster."""
    rng = np.random.default_rng(0)
    N, L, W, M, H, Wp = (s[k] for k in ("N", "L", "W", "M", "H", "Wp"))
    for WIN in s["take_wins3"]:
        wins = p.tensor(rng.integers(0, 16, (N, WIN, WIN)).astype(np.int32))
        idx = p.tensor(rng.integers(0, WIN * WIN, (N, L, W)).astype(np.int32))
        _take_step(p, f"take WIN={WIN} i32", wins, idx, probe=3, win=WIN,
                   dtype="i32")
    WIN = s["take_wins3"][0]
    wins8 = p.tensor(rng.integers(0, 16, (N, WIN, WIN)).astype(np.uint8))
    idx = p.tensor(rng.integers(0, WIN * WIN, (N, L, W)).astype(np.int32))
    _take_step(p, f"take WIN={WIN} u8", wins8, idx, probe=3, win=WIN,
               dtype="u8")
    WIN = s["extract_win3"]
    raster = p.tensor(rng.integers(0, 16, (M * H, Wp)).astype(np.uint8))
    y0 = p.tensor(rng.integers(0, H - WIN, N).astype(np.int32))
    x0 = p.tensor(rng.integers(0, Wp - WIN, N).astype(np.int32))
    mapix = p.tensor(rng.integers(0, M, N).astype(np.int32))
    row0 = (mapix * H + y0).int()  # clamped in the flat raster
    p.step(f"extract WIN={WIN} u8 (flat raster)",
           lambda: wk.extract(raster, row0, x0, WIN),
           lambda: wk.window_extract_plain(raster, row0, x0, WIN),
           N * WIN * WIN, probe=3, win=WIN, dtype="u8")


def probe2(p, s):
    """``pallas_gather_probe2.py:38-114``: extract from an (M, H, W)
    raster, take from the windows, and the two fused."""
    rng = np.random.default_rng(0)
    N, L, W, M, H, Wp = (s[k] for k in ("N", "L", "W", "M", "H", "Wp"))
    WIN = s["extract_win2"]
    raster_u8 = p.tensor(rng.integers(0, 16, (M, H, Wp)).astype(np.uint8))
    y0 = p.tensor(rng.integers(0, H - WIN, N).astype(np.int32))
    x0 = p.tensor(rng.integers(0, Wp - WIN, N).astype(np.int32))
    mapix = p.tensor(rng.integers(0, M, N).astype(np.int32))
    lidx = p.tensor(rng.integers(0, WIN * WIN, (N, L, W)).astype(np.int32))
    row0, col0 = map_origins(mapix, y0, x0, H, WIN)
    rasters = {"u8": raster_u8.reshape(M * H, Wp)}
    rasters["i32"] = rasters["u8"].int()
    wins = {}
    for name, r in rasters.items():
        wins[name] = p.step(
            f"extract WIN={WIN} {name}",
            lambda r=r: wk.extract(r, row0, col0, WIN),
            lambda r=r: wk.window_extract_plain(r, row0, col0, WIN),
            N * WIN * WIN, probe=2, win=WIN, dtype=name)
    for name, w in wins.items():
        _take_step(p, f"stage2 take {name}", w, lidx, probe=2, win=WIN,
                   dtype=name)
    r, i = rasters["i32"], lidx.reshape(N, -1)
    p.step("fused extract+take i32",
           lambda: wk.take(wk.extract(r, row0, col0, WIN).reshape(N, -1), i),
           lambda: wk.window_take_plain(
               wk.window_extract_plain(r, row0, col0, WIN).reshape(N, -1), i),
           N * L * W, probe=2, win=WIN, dtype="i32")


def run(device="cuda"):
    """All three probes at their scripts' sizes. Raises on any mismatch.

    :return: {"device", "steps": [{step, ms, gelem_s, ...}], "lines"}; a
        step's label names the kernels it runs ("take", "extract")
    """
    device = torch.device(device)
    p = _Probe(device)
    for probe in (probe1, probe3, probe2):
        probe(p, SIZES)
    return {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "steps": p.records, "lines": p.lines}


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
