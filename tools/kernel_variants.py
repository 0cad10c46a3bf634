"""Launch-shape variants of K2 ``footprint_coll_point`` and K4b
``window_take``, timed on the card beside the port's kernels and an
earlier checkout's.

    python -m tools.kernel_variants [--parent DIR]

Each variant is a copy of ``strive_tpu_torch/csrc/crop.cu`` (K2) or
``window.cu`` (K4b) with some of the kernel's constants replaced
(:func:`variant_sources`; every replaced text must occur once in the
source): for K2 the threads per car and the loads in flight per thread,
for K4b the threads per block, the blocks per SM and the outputs per
thread of the layout by SM, the evict-first hints on or off, and the share
of L2 the windows may fill before the take turns to its flat layout. The
copies are built under ``build/variants/`` with the port's nvcc flags, one
nvcc each, all in parallel, and so are the same two sources of an earlier
checkout with ``--parent`` (``DIR/strive_tpu_torch/csrc``, whose C entry
points take the same arguments). Every build is held against the plain
versions on the inputs it is timed at and on the edge cases of
``strive_tpu_torch.kernel_cases``: K2 at the main path's shape (1152 cars
x 39x16 samples on 2 maps of 2048 px), K4b at probe 1's (32 windows of
512^2, 65,536 indices each; int32, uint8, the first 8 int32 windows, whose
8 MB stay in L2, and probe 3's 32 int32 windows of 576^2 and 640^2, which
fill 85% and 105% of the L2). Then ``ROUNDS`` rounds of device times
(``utils.timing.cuda_ms`` through the wrappers): the parent first and
last, the others in order and then in reverse between. K4b's streaming
floor is ``out.copy_(idx)`` into an output of its dtype: the index bytes
read and the output bytes written, without the gathers. Prints one JSON
line with the card's name and power limit and every time; needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.maps import crop_kernel
from strive_tpu_torch.probes import window_kernels as wk
from strive_tpu_torch.utils import build, launch

ROUNDS = 3
REPS = 200
OUT_DIR = build.BUILD_DIR.parent / "variants"

# (threads per car, samples per thread per pass); the port's is (128, 5)
K2_SHAPES = ((32, 20), (64, 10), (96, 7), (128, 1), (128, 5), (160, 4),
             (256, 3), (320, 2), (640, 1))
# (threads per block, blocks per SM, outputs per thread of either dtype,
# evict-first hints, percent of L2 the windows may fill before the flat
# layout: 0 takes it always, 1000 never); the port's is (1024, 1, 16 for
# uint8 and 4 for int32, on, 90)
TAKE_SHAPES = ((1024, 1, 4, True, 90), (1024, 1, 8, True, 90),
               (1024, 1, 16, True, 90), (1024, 1, 4, False, 90),
               (1024, 2, 4, True, 90), (256, 8, 4, True, 90),
               (1024, 1, 4, True, 1000), (1024, 1, 4, True, 0))


def _k2_edits(threads, samples):
    return {"constexpr int kFootThreads = 128;":
            f"constexpr int kFootThreads = {threads};",
            "constexpr int kFootSamples = 5;":
            f"constexpr int kFootSamples = {samples};"}


def _take_edits(threads, per_sm, vec, hints, l2_percent):
    edits = {"constexpr int kTakeThreads = 1024;":
             f"constexpr int kTakeThreads = {threads};",
             "constexpr int kTakeBlocksPerSM = 1;":
             f"constexpr int kTakeBlocksPerSM = {per_sm};",
             "constexpr int kTakeVec = sizeof(T) == 1 ? 16 : 4;":
             f"constexpr int kTakeVec = {vec};",
             "constexpr int kTakeL2Percent = 90;":
             f"constexpr int kTakeL2Percent = {l2_percent};"}
    if not hints:
        edits.update({"__stcs(p, v);": "*p = v;",
                      "return __ldcs(p);": "return *p;"})
    return edits


def patched(text, edits):
    """``text`` with each key of ``edits`` replaced by its value; raise
    unless every key occurs exactly once."""
    for old, new in edits.items():
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant_sources(csrc=build.CSRC):
    """{kernel ("k2" or "take"): {label: (source name, CUDA text)}}: the
    port's sources as they are ("port") and every shape's copy."""
    crop = (Path(csrc) / "crop.cu").read_text()
    window = (Path(csrc) / "window.cu").read_text()
    k2 = {"port": ("crop", crop)}
    for t, s in K2_SHAPES:
        k2[f"threads{t}_samples{s}"] = ("crop",
                                        patched(crop, _k2_edits(t, s)))
    take = {"port": ("window", window)}
    for t, b, v, h, l2 in TAKE_SHAPES:
        take[f"threads{t}_sm{b}_vec{v}_{'hints' if h else 'nohints'}"
             f"_l2at{l2}"] = ("window",
                              patched(window, _take_edits(t, b, v, h, l2)))
    return {"k2": k2, "take": take}


def _compile(jobs):
    """Build each {path: CUDA text} into ``path`` (.so), in parallel."""
    nvcc, procs = build._nvcc(), {}
    for so, text in jobs.items():
        so.parent.mkdir(parents=True, exist_ok=True)
        src = so.with_suffix(".cu")
        src.write_text(text)
        procs[so] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for so, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{so.with_suffix('.cu')}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _bound(like, path):
    """A ``launch.Library`` with ``like``'s entry points, from ``path``."""
    lib = launch.Library(like.source, like._signatures)
    handle = ctypes.CDLL(str(path))
    for fn, argtypes in like._signatures.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    handle.strive_cuda_error.argtypes = [launch.INT]
    handle.strive_cuda_error.restype = ctypes.c_char_p
    lib._lib = handle
    return lib


def _builds(parent):
    """{kernel: {label: Library}} for every variant, built in parallel."""
    sources = variant_sources()
    if parent is not None:
        csrc = Path(parent) / "strive_tpu_torch" / "csrc"
        sources["k2"]["parent"] = ("crop", (csrc / "crop.cu").read_text())
        sources["take"]["parent"] = ("window",
                                     (csrc / "window.cu").read_text())
    jobs = {OUT_DIR / kernel / label / f"{name}.so": text
            for kernel, group in sources.items()
            for label, (name, text) in group.items()}
    _compile(jobs)
    like = {"k2": crop_kernel._LIB, "take": wk._LIB}
    return {kernel: {label: _bound(like[kernel],
                                   OUT_DIR / kernel / label / f"{name}.so")
                     for label, (name, _) in group.items()}
            for kernel, group in sources.items()}


@contextlib.contextmanager
def _built_as(module, lib):
    """``module``'s wrappers launch from ``lib`` (another build) meanwhile."""
    saved, module._LIB = module._LIB, lib
    try:
        yield
    finally:
        module._LIB = saved


def _rounds(fns):
    """{label: [ms, ...]} over ``ROUNDS`` rounds: "parent" first and last,
    the others in order, then in reverse."""
    order = [k for k in fns if k != "parent"]
    seq = order + order[::-1]
    if "parent" in fns:
        seq = ["parent"] + seq + ["parent"]
    times = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k in seq:
            times[k].append(fns[k]())
    return times


def _probe_take(dev, win=512):
    """K4b's inputs at probe 1's shape, or with probe 3's windows of
    ``win``^2."""
    rng = np.random.default_rng(0)
    wins = rng.integers(0, 16, (32, win * win)).astype(np.int32)
    idx = rng.integers(0, win * win, (32, 256 * 256)).astype(np.int32)
    return torch.from_numpy(wins).to(dev), torch.from_numpy(idx).to(dev)


def run(parent=None):
    """Check and time every variant. :return: the JSON-able result"""
    from strive_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    libs = _builds(parent)
    store, k2_main = kc.main_path_k2(dev)
    k2_cases = [kc.coll_point_args(store, c, dev)
                for c in kc.coll_point_cases(2048).values()]
    wins, idx = _probe_take(dev)
    take_main = {"probe1_int32": (wins, idx),
                 "probe1_uint8": (wins.to(torch.uint8), idx),
                 "probe1_int32_8windows": (wins[:8], idx[:8]),
                 "probe3_int32_win576": _probe_take(dev, 576),
                 "probe3_int32_win640": _probe_take(dev, 640)}
    take_edges = []
    for w, i in kc.take_cases().values():
        w, i = torch.from_numpy(w).to(dev), torch.from_numpy(i).to(dev)
        take_edges += [(w, i), (w.to(torch.uint8), i)]

    k2_err, k2 = {}, {}
    for label, lib in libs["k2"].items():
        with _built_as(crop_kernel, lib):
            k2_err[label] = max(kc.coll_point_error(a)
                                for a in [k2_main] + k2_cases)

        def timed(lib=lib):
            with _built_as(crop_kernel, lib):
                return cuda_ms(lambda: crop_kernel.footprint_coll_point(
                    *k2_main), REPS)
        k2[label] = timed
    for label, lib in libs["take"].items():
        with _built_as(wk, lib):
            for w, i in list(take_main.values()) + take_edges:
                if label == "parent" and w.shape[0] > 65535:
                    continue  # its grid had a row of blocks per window
                got = wk.window_take(w, i)
                if not torch.equal(got, wk.window_take_plain(w, i)):
                    raise AssertionError(f"window_take {label} differs from "
                                         f"plain at {tuple(i.shape)}, "
                                         f"{w.dtype}")
    takes = {}
    for case, (w, i) in take_main.items():
        fns = {}
        for label, lib in libs["take"].items():
            def timed(lib=lib, w=w, i=i):
                with _built_as(wk, lib):
                    return cuda_ms(lambda: wk.window_take(w, i), REPS)
            fns[label] = timed
        out = torch.empty(i.shape, dtype=w.dtype, device=dev)
        fns["floor_copy"] = lambda out=out, i=i: cuda_ms(
            lambda: out.copy_(i), REPS)
        takes[case] = _rounds(fns)
    card = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {"variants": "K2 footprint_coll_point, K4b window_take",
            "card": card, "kind": torch.cuda.get_device_name(dev),
            "rounds": ROUNDS, "reps": REPS,
            "k2_main_path_ms": _rounds(k2), "k2_max_abs_err": k2_err,
            **{f"take_{k}_ms": v for k, v in takes.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier checkout whose "
                    "strive_tpu_torch/csrc is timed beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    res = run(args.parent)
    print(f"card: {res['card']}", file=sys.stderr)
    for key in [k for k in res if k.endswith("_ms")]:
        for label, ms in res[key].items():
            print(f"{key} {label:36s} {min(ms) * 1e3:8.2f}-"
                  f"{max(ms) * 1e3:8.2f} us", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
