"""Launch-shape variants of K1 ``map_crop``, K2 ``footprint_coll_point``,
K4b ``window_take``, K5c ``window_sums`` and K5d ``onehot_rows``, timed on
the card beside the port's kernels and an earlier checkout's.

    python -m tools.kernel_variants [--parent DIR] [--kernels k1 k2 take sums onehot]

Each variant is a copy of ``strive_tpu_torch/csrc/crop.cu`` (K1, K2),
``window.cu`` (K4b) or ``bisect.cu`` (K5c, K5d) with some of the kernel's
constants replaced (:func:`variant_sources`; every replaced text must occur
once in the source): for K1 the threads a block, the column units a
thread takes in a row, the rows a thread takes and the residual steps of
its division, and one copy that divides with ``__fdiv_rn``; for K2 the
threads per car and the loads in flight per thread, for K4b the threads
per block, the blocks per SM and the outputs per thread of the layout by
SM, the evict-first hints on or off,
and the share of L2 the windows may fill before the take turns to its
flat layout, for K5c the threads per block and the pieces a thread loads
before it sums them, of the block used while the outputs outnumber the
SMs and of the wide block used while they do not, and the way each
reads its windows' starts (staged in shared memory or read by every
thread), for K5d the threads a block and evict-first stores; K5d's
channels a block (``cg``) are an argument of its entry point, so its
groups are varied through the port's own build (``port_cg<n>``).
The copies are built under ``build/variants/`` with the port's nvcc
flags and ``-Xptxas -v`` (K1's registers and spills go into the result),
one nvcc each, all in parallel, and so are the same sources
of an earlier checkout with ``--parent`` (``DIR/strive_tpu_torch/csrc``,
whose C entry points take the same arguments). Every build is held
against the plain versions on the inputs it is timed at and on the edge
cases of ``strive_tpu_torch.kernel_cases``: K1 at the main path's 32
poses and training's 128 (256 px, NHWC) in float32 and bf16, and its edge
cases in both dtypes and layouts, K2 at the main path's shape
(1152 cars x 39x16 samples on 2 maps of 2048 px), K4b at probe 1's (32
windows of 512^2, 65,536 indices each; int32, uint8, the first 8 int32
windows, whose 8 MB stay in L2, and probe 3's 32 int32 windows of 576^2
and 640^2, which fill 85% and 105% of the L2), K5c at the gather-probe
path's shape (2048 windows of 64x192 on a (2048, 1024) uint8 raster) and
at the four Mosaic-bisect variants' (bit for bit against their ``want``
too), K5d at the bisect scripts' shape (T = 1, P = 1024, C = 192) and the
gather-probe path's (2048 tiles) and on ``kernel_cases.onehot_cases``
(an earlier checkout's K5d, the first design, took the shared-memory
pitch of all of w[t]'s columns where it now takes ``cg`` and the pitch of
its group, and is called so). Then ``ROUNDS``
rounds of device times (``utils.timing.cuda_ms`` through the wrappers):
the parent first and last, the others in order and then in reverse
between. K1's write floor is ``out.fill_(1)`` into an
output of its shape and dtype: its bytes without the gathers. K4b's
streaming floor is ``out.copy_(idx)`` into an output of its dtype: the
index bytes read and the output bytes written, without the gathers.
K5c's floors are the launch (``torch.cuda._sleep(0)``) and a pass of as
many 16-byte loads as K5c makes over its L2-resident raster
(``FLOORS_CU``), from a full card of blocks at the path's shape and from
G blocks at the scripts'. K5d's floors are the launch, an empty kernel
launched on the port's grid, block and shared memory (``FLOORS_CU``), and,
at the path's shape, its write floor, ``out.fill_(1)`` into an output of
its shape.
Prints one JSON line with the card's name and power limit and every
time; needs a card.
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
from strive_tpu_torch.probes import bisect_kernels as bk
from strive_tpu_torch.probes import mosaic_bisect as mb
from strive_tpu_torch.probes import window_kernels as wk
from strive_tpu_torch.utils import build, launch

ROUNDS = 3
REPS = 200
OUT_DIR = build.BUILD_DIR.parent / "variants"

# (threads a block, column units a thread takes in a row, rows a thread
# takes, residual steps of the quotient); the port's is (256, 1, 4, 2)
K1_SHAPES = ((256, 1, 1, 2), (256, 1, 2, 2), (256, 1, 4, 2), (256, 1, 8, 2),
             (256, 1, 16, 2), (128, 1, 4, 2), (128, 2, 4, 2), (512, 1, 4, 2),
             (256, 2, 2, 2), (256, 1, 4, 1))
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
# (threads per block, pieces a thread loads before it sums them) where G
# exceeds the SM count (the gather-probe path's shape), then the same for
# the wide block of G <= the SM count (the bisect scripts' shapes), and
# whether 16-byte pieces load through L2 only (ld.global.cg) instead of
# the read-only L1 path; the port's is (64, 16, 512, 2, off). (64, 16, 64,
# 16) and (512, 2, 512, 2) take one block shape for every G.
SUMS_SHAPES = ((64, 16, 64, 16, False), (512, 2, 512, 2, False),
               (64, 8, 256, 2, False), (64, 16, 512, 2, False),
               (64, 16, 512, 4, False), (128, 4, 512, 1, False),
               (128, 8, 1024, 1, False), (128, 16, 1024, 2, False),
               (256, 4, 256, 4, False), (256, 8, 512, 8, False),
               (64, 16, 512, 2, True))
# the Mosaic-bisect variants that run K5c, timed at their own shapes
SUMS_VARIANTS = (mb.v_prefetch_indexmap, mb.v_same_array_two_specs,
                 mb.v_prefetch_indexmap_u8, mb.v_dma_dyn_in_fori)
# K5d: (threads a block, evict-first stores); the port's is (256, off)
ONEHOT_SHAPES = ((64, False), (128, False), (512, False), (256, True))
# channels a block through the port's build; the port's own choice is
# bisect_kernels.onehot_launch's (1 at the scripts' shape, 192 at the path's)
ONEHOT_GROUPS = (1, 8, 32, 192)
ONEHOT_STORE = ("*reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], "
                "v[2], v[3]);")
KERNELS = ("k1", "k2", "take", "sums", "onehot")
SOURCES = {"k1": "crop", "k2": "crop", "take": "window", "sums": "bisect",
           "onehot": "bisect"}
REPS_K1 = 100

# The floors. L2 read: n 16-byte loads over the vectors [0, mask] of src (a
# power of two of them, resident in L2), four in flight a thread, with no
# start to fetch, no masks and no reduction; a thread stores only if its
# sum hits a value, so no load is dropped and nothing is written. Empty
# grid: a kernel that does nothing, launched with a given grid, block and
# dynamic shared memory (what a launch of that shape costs alone).
FLOORS_CU = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
l2_read_kernel(const uint4* __restrict__ src, unsigned mask, long long n,
               unsigned* __restrict__ out) {
  const long long step = (long long)gridDim.x * 256;
  unsigned acc = 0;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += 4 * step) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + u * step;
      v[u] = j < n ? __ldg(src + (j & mask)) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  if (acc == 0x9e3779b9u) out[blockIdx.x] = acc;
}

__global__ void empty_grid_kernel() {}

extern "C" {
const char* strive_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int strive_l2_read(const void* src, unsigned mask, long long n, int blocks,
                   unsigned* out, void* stream) {
  l2_read_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), mask, n, out);
  return (int)cudaGetLastError();
}

int strive_empty_grid(int gx, int gy, int gz, int threads, int smem,
                      void* stream) {
  empty_grid_kernel<<<dim3(gx, gy, gz), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
}
"""
FLOORS = launch.Library("floors", {
    # src, mask, n, blocks, out, stream
    "strive_l2_read": [launch.PTR, ctypes.c_uint, ctypes.c_longlong,
                       launch.INT, launch.PTR, launch.PTR],
    # grid x, y, z, threads, dynamic shared bytes, stream
    "strive_empty_grid": [launch.INT] * 5 + [launch.PTR]})


def _k1_edits(threads, cols, rows, steps):
    return {"constexpr int kThreads = 256;":
            f"constexpr int kThreads = {threads};",
            "constexpr int kCols = 1;": f"constexpr int kCols = {cols};",
            "constexpr int kRows = 4;": f"constexpr int kRows = {rows};",
            "constexpr int kQuotientSteps = 2;":
            f"constexpr int kQuotientSteps = {steps};"}


# K1 dividing as its first design did, with __fdiv_rn at every pixel
K1_FDIV = {"  if (!kFast) return rintf(__fdiv_rn(g, q.d));":
           "  if (true) return rintf(__fdiv_rn(g, q.d));"}


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


def _sums_edits(threads, vecs, wide_threads, wide_vecs, cg):
    edits = {"constexpr int kSumThreads = 64;":
             f"constexpr int kSumThreads = {threads};",
             "constexpr int kSumVecs = 16;":
             f"constexpr int kSumVecs = {vecs};",
             "constexpr int kSumWideThreads = 512;":
             f"constexpr int kSumWideThreads = {wide_threads};",
             "constexpr int kSumWideVecs = 2;":
             f"constexpr int kSumWideVecs = {wide_vecs};"}
    if cg:
        edits["ok ? __ldg(reinterpret_cast<const uint4*>(p))"] = \
            "ok ? __ldcg(reinterpret_cast<const uint4*>(p))"
    return edits


def _onehot_edits(threads, stcs):
    edits = {"constexpr int kOnehotThreads = 256;":
             f"constexpr int kOnehotThreads = {threads};"}
    if stcs:
        edits[ONEHOT_STORE] = ("__stcs(reinterpret_cast<float4*>(o), "
                               "make_float4(v[0], v[1], v[2], v[3]));")
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
    """{kernel ("k1", "k2", "take", "sums" or "onehot"): {label: (source
    name, CUDA text)}}: the port's sources as they are ("port") and every
    shape's copy."""
    crop = (Path(csrc) / "crop.cu").read_text()
    k1 = {"port": ("crop", crop)}
    for t, c, r, q in K1_SHAPES:
        k1[f"threads{t}_cols{c}_rows{r}_steps{q}"] = (
            "crop", patched(crop, _k1_edits(t, c, r, q)))
    k1["fdiv"] = ("crop", patched(crop, K1_FDIV))
    window = (Path(csrc) / "window.cu").read_text()
    bisect = (Path(csrc) / "bisect.cu").read_text()
    k2 = {"port": ("crop", crop)}
    for t, s in K2_SHAPES:
        k2[f"threads{t}_samples{s}"] = ("crop",
                                        patched(crop, _k2_edits(t, s)))
    take = {"port": ("window", window)}
    for t, b, v, h, l2 in TAKE_SHAPES:
        take[f"threads{t}_sm{b}_vec{v}_{'hints' if h else 'nohints'}"
             f"_l2at{l2}"] = ("window",
                              patched(window, _take_edits(t, b, v, h, l2)))
    sums = {"port": ("bisect", bisect)}
    for t, v, wt, wv, cg in SUMS_SHAPES:
        sums[f"threads{t}x{v}_wide{wt}x{wv}{'_cg' if cg else ''}"] = (
            "bisect", patched(bisect, _sums_edits(t, v, wt, wv, cg)))
    for how, flag in (("direct", "true"), ("staged", "false")):
        sums[f"starts_{how}_for_every_G"] = ("bisect", patched(
            bisect, {"  if constexpr (WIDE) {": f"  if constexpr ({flag}) {{"}))
    onehot = {"port": ("bisect", bisect)}
    for t, cs in ONEHOT_SHAPES:
        onehot[f"threads{t}{'_stcs' if cs else ''}"] = (
            "bisect", patched(bisect, _onehot_edits(t, cs)))
    return {"k1": k1, "k2": k2, "take": take, "sums": sums, "onehot": onehot}


def _compile(jobs):
    """Build each {path: CUDA text} into ``path`` (.so), in parallel.
    :return: {path: nvcc's output, ptxas's report among it}"""
    nvcc, procs = build._nvcc(), {}
    for so, text in jobs.items():
        so.parent.mkdir(parents=True, exist_ok=True)
        src = so.with_suffix(".cu")
        src.write_text(text)
        procs[so] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed, outs = [], {}
    for so, proc in procs.items():
        outs[so], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{so.with_suffix('.cu')}:\n{outs[so]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def ptxas_report(out, kernel):
    """{entry function: its "Used ... registers" line and any spill line}
    of ``kernel``'s instantiations in nvcc ``-Xptxas -v`` output ``out``."""
    report, entry = {}, None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if kernel in name else None
            if entry:
                report[entry] = []
        elif entry and ("Used" in line or "spill" in line):
            report[entry].append(line.split(":", 1)[-1].strip())
    return report


def _bound(like, path):
    """A ``launch.Library`` with ``like``'s entry points, from ``path``
    (those the build has: an earlier checkout's may lack some)."""
    lib = launch.Library(like.source, like._signatures)
    handle = ctypes.CDLL(str(path))
    for fn, argtypes in like._signatures.items():
        if not hasattr(handle, fn):
            continue
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    handle.strive_cuda_error.argtypes = [launch.INT]
    handle.strive_cuda_error.restype = ctypes.c_char_p
    lib._lib = handle
    return lib


def _builds(parent, kernels):
    """{kernel: {label: Library}} for every variant of ``kernels``, the
    L2 read floor's Library, and K1's ptxas report by label, built in
    parallel."""
    sources = {k: g for k, g in variant_sources().items() if k in kernels}
    if parent is not None:
        csrc = Path(parent) / "strive_tpu_torch" / "csrc"
        for kernel, group in sources.items():
            name = SOURCES[kernel]
            group["parent"] = (name, (csrc / f"{name}.cu").read_text())
    jobs = {OUT_DIR / kernel / label / f"{name}.so": text
            for kernel, group in sources.items()
            for label, (name, text) in group.items()}
    floor = OUT_DIR / "floors" / "floors.so"
    jobs[floor] = FLOORS_CU
    outs = _compile(jobs)
    like = {"k1": crop_kernel._LIB, "k2": crop_kernel._LIB, "take": wk._LIB,
            "sums": bk._LIB, "onehot": bk._LIB}
    ptxas = {label: ptxas_report(outs[OUT_DIR / "k1" / label / "crop.so"],
                                 "map_crop_kernel")
             for label in sources.get("k1", {})}
    return ({kernel: {label: _bound(
                FIRST_ONEHOT if (kernel, label) == ("onehot", "parent")
                else like[kernel], OUT_DIR / kernel / label / f"{name}.so")
                      for label, (name, _) in group.items()}
             for kernel, group in sources.items()}, _bound(FLOORS, floor),
            ptxas)


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


def _k1(libs, dev, cuda_ms):
    """K1's builds held bit for bit to the plain version on the inputs
    they are timed at and on the edge cases, in both dtypes (and, for the
    edge cases, both layouts), then timed at the main path's 32 poses and
    training's 128 beside the write floor: ``{"k1_<shape>_<dtype>_ms":
    ...}``."""
    main = {"main_32": kc.main_path_k1(dev),
            "training_128": kc.decode_crop_args(dev, 8)}
    raster = kc.crop_edge_raster(dev)
    edges = [kc.crop_edge_args(raster, c, layout, dev)
             for c in kc.crop_edge_cases().values()
             for layout in ("nhwc", "nchw")]
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for label, lib in libs.items():
        with _built_as(crop_kernel, lib):
            for args in list(main.values()) + edges:
                for dt in dtypes.values():
                    got = crop_kernel.map_crop(*args, dt)
                    if not torch.equal(got, crop_kernel.map_crop_plain(
                            *args, dt)):
                        raise AssertionError(
                            f"map_crop {label} differs from plain at "
                            f"{tuple(got.shape)} {args[-1]}, {dt}")
    res = {}
    for case, args in main.items():
        for tag, dt in dtypes.items():
            fns = {}
            for label, lib in libs.items():
                def timed(lib=lib, args=args, dt=dt):
                    with _built_as(crop_kernel, lib):
                        return cuda_ms(lambda: crop_kernel.map_crop(
                            *args, dt), REPS_K1)
                fns[label] = timed
            out = torch.empty(crop_kernel.map_crop(*args, dt).shape,
                              dtype=dt, device=dev)
            fns["floor_fill"] = lambda out=out: cuda_ms(
                lambda: out.fill_(1), REPS_K1)
            res[f"k1_{case}_{tag}_ms"] = _rounds(fns)
    return res


def _k2(libs, dev, cuda_ms):
    """K2's builds held to the plain version, then timed at the main
    path's shape: ``{"k2_main_path_ms": ..., "k2_max_abs_err": ...}``."""
    store, k2_main = kc.main_path_k2(dev)
    k2_cases = [kc.coll_point_args(store, c, dev)
                for c in kc.coll_point_cases(2048).values()]
    k2_err, k2 = {}, {}
    for label, lib in libs.items():
        with _built_as(crop_kernel, lib):
            k2_err[label] = max(kc.coll_point_error(a)
                                for a in [k2_main] + k2_cases)

        def timed(lib=lib):
            with _built_as(crop_kernel, lib):
                return cuda_ms(lambda: crop_kernel.footprint_coll_point(
                    *k2_main), REPS)
        k2[label] = timed
    return {"k2_main_path_ms": _rounds(k2), "k2_max_abs_err": k2_err}


def _take(libs, dev, cuda_ms):
    """K4b's builds held to the plain version, then timed at the probes'
    shapes beside the streaming floor: ``{"take_<shape>_ms": ...}``."""
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
    for label, lib in libs.items():
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
        for label, lib in libs.items():
            def timed(lib=lib, w=w, i=i):
                with _built_as(wk, lib):
                    return cuda_ms(lambda: wk.window_take(w, i), REPS)
            fns[label] = timed
        out = torch.empty(i.shape, dtype=w.dtype, device=dev)
        fns["floor_copy"] = lambda out=out, i=i: cuda_ms(
            lambda: out.copy_(i), REPS)
        takes[f"take_{case}_ms"] = _rounds(fns)
    return takes


def _sums_pieces(args):
    """The 16-byte pieces K5c loads for ``args`` (rows of a multiple of
    16 bytes): the vectors each window row touches, over all rows."""
    src, row0, col0, _, WR, WC = args
    E = src.element_size()
    b0 = bk.slice_start(col0.reshape(-1).long(), src.shape[1], WC) * E
    return int(((b0 + WC * E - 1) // 16 - b0 // 16 + 1).sum()) * WR


def _sums(libs, floor_lib, dev, cuda_ms):
    """K5c's builds held bit for bit to the plain version (and to each
    variant's ``want``), then timed at the gather-probe path's shape and
    at the four variants' beside the launch floor and, at the path's
    shape, the L2 read floor: ``{"sums_<shape>_ms": ...}``."""
    main = {"path": kc.bisect_path_args(dev)["window_sums"]}
    wants = {}
    for v in SUMS_VARIANTS:
        case = v(dev)
        main[v.__name__], wants[v.__name__] = case.args, case.want
    edges = [kc.sums_args(c, dev) for c in kc.sums_cases().values()]
    for label, lib in libs.items():
        with _built_as(bk, lib):
            for name, args in list(main.items()) + [("edge", a)
                                                    for a in edges]:
                got = bk.window_sums(*args)
                want = bk.window_sums_plain(*args)
                if not torch.equal(got, want) or (
                        wants.get(name) is not None
                        and not torch.equal(got, wants[name])):
                    raise AssertionError(f"window_sums {label} differs at "
                                         f"{name} {tuple(args[1].shape)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(sms * 8, dtype=torch.int32, device=dev)
    sums = {}
    for case, args in main.items():
        fns = {}
        for label, lib in libs.items():
            def timed(lib=lib, args=args):
                with _built_as(bk, lib):
                    return cuda_ms(lambda: bk.window_sums(*args), REPS)
            fns[label] = timed
        fns["floor_launch"] = lambda: cuda_ms(
            lambda: torch.cuda._sleep(0), REPS)
        # as many 16-byte loads as K5c makes, from as many blocks as it
        # launches while the outputs outnumber the SMs, else from G blocks
        src, G = args[0], args[1].shape[0]
        vectors = src.numel() * src.element_size() // 16
        n = _sums_pieces(args)
        blocks = sms * 8 if G > sms else G

        def l2_read(src=src, vectors=vectors, n=n, blocks=blocks):
            floor_lib.launch("strive_l2_read", src.data_ptr(), vectors - 1,
                             n, blocks, scratch.data_ptr(),
                             launch.stream(dev))
        if vectors & (vectors - 1) == 0:
            fns["floor_l2_read"] = lambda f=l2_read: cuda_ms(f, REPS)
        sums[f"sums_{case}_ms"] = _rounds(fns)
        sums[f"sums_{case}_l2_read_bytes"] = n * 16
    return sums


# the first K5d design's entry point: w, idx, T, R, C, P, pitch, out, stream
FIRST_ONEHOT = launch.Library(bk.SOURCE, dict(
    bk._LIB._signatures, strive_onehot_rows=[launch.PTR, launch.PTR] +
    [launch.INT] * 5 + [launch.PTR, launch.PTR]))


def _onehot_first_design(lib, w, idx):
    """The first K5d design, from an earlier checkout's build: its entry
    point took the shared-memory row pitch of all of w[t]'s columns where
    the port's takes ``cg`` and the pitch of its group."""
    (T, R, C), P = w.shape, idx.shape[1]
    out = torch.empty((T, C, P), dtype=torch.float32, device=idx.device)
    lib.launch("strive_onehot_rows", w.data_ptr(), idx.data_ptr(), T, R, C,
               P, bk._smem_pitch(C), out.data_ptr(), launch.stream(idx.device))
    return out


def _onehot(libs, floor_lib, dev, cuda_ms):
    """K5d's builds (and the port's build at other ``cg``) held bit for
    bit to the plain version at both shapes and on the edge cases, then
    timed at both beside the launch floor, an empty kernel on the port's
    grid and, at the path's shape, the write floor:
    ``{"onehot_<shape>_ms": ...}``."""
    variants = {v.__name__: v for _, _, v in mb.VARIANTS}
    main = {"scripts": variants["v_iota_compare_matmul"](dev).args,
            "path": kc.bisect_path_args(dev)["onehot_rows"]}
    edges = [kc.onehot_args(c, dev) for c in kc.onehot_cases().values()]
    sms = bk._sm_count(dev)

    def group_launch(label, w, idx):
        """The launch of a ``port_cg<n>`` label: n channels a block, or
        all of a narrower w's."""
        cg = min(int(label[len("port_cg"):]), w.shape[2])
        return bk.onehot_launch(*w.shape, idx.shape[1], sms, cg)

    def call(label, w, idx):
        if label == "parent":
            return _onehot_first_design(libs["parent"], w, idx)
        if label.startswith("port_cg"):
            return bk._onehot_rows_at(w, idx, group_launch(label, w, idx))
        with _built_as(bk, libs[label]):
            return bk.onehot_rows(w, idx)

    def takes(label, w, idx):
        """Whether the build takes a case: the first design staged all of
        w[t]; the others as ``onehot_launch`` allows."""
        (T, R, C), P = w.shape, idx.shape[1]
        if label == "parent":
            return R * bk._smem_pitch(C) * 2 <= bk._SMEM_BYTES
        try:
            if label.startswith("port_cg"):
                group_launch(label, w, idx)
            else:
                bk.onehot_launch(T, R, C, P, sms)
        except ValueError:
            return False
        return True

    labels = list(libs) + [f"port_cg{g}" for g in ONEHOT_GROUPS]
    for label in labels:
        for w, idx in list(main.values()) + edges:
            if not takes(label, w, idx):
                continue
            got = call(label, w, idx)
            if not torch.equal(got, bk.onehot_rows_plain(w, idx)):
                raise AssertionError(f"onehot_rows {label} differs from "
                                     f"plain at {tuple(idx.shape)}, "
                                     f"{tuple(w.shape)}")
    res = {}
    for case, (w, idx) in main.items():
        fns = {}
        for label in labels:
            def timed(label=label, w=w, idx=idx):
                return cuda_ms(lambda: call(label, w, idx), REPS)
            fns[label] = timed
        fns["floor_launch"] = lambda: cuda_ms(
            lambda: torch.cuda._sleep(0), REPS)
        shape = bk.onehot_launch(*w.shape, idx.shape[1], sms)

        def empty_grid(shape=shape):
            floor_lib.launch("strive_empty_grid", *shape["grid"],
                             bk.ONEHOT_THREADS, shape["smem"],
                             launch.stream(dev))
        fns["floor_grid"] = lambda f=empty_grid: cuda_ms(f, REPS)
        if case == "path":
            out = torch.empty((w.shape[0], w.shape[2], idx.shape[1]),
                              device=dev)
            fns["floor_fill"] = lambda out=out: cuda_ms(
                lambda: out.fill_(1), REPS)
        res[f"onehot_{case}_ms"] = _rounds(fns)
    res["onehot_launch"] = {
        case: bk.onehot_launch(*w.shape, idx.shape[1], bk._sm_count(dev))
        for case, (w, idx) in main.items()}
    return res


def run(parent=None, kernels=KERNELS):
    """Check and time every variant of ``kernels``. :return: the
    JSON-able result"""
    from strive_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    libs, floor_lib, ptxas = _builds(parent, kernels)
    res = {}
    if "k1" in kernels:
        res.update(_k1(libs["k1"], dev, cuda_ms))
        res["k1_ptxas"] = ptxas
    if "k2" in kernels:
        res.update(_k2(libs["k2"], dev, cuda_ms))
    if "take" in kernels:
        res.update(_take(libs["take"], dev, cuda_ms))
    if "sums" in kernels:
        res.update(_sums(libs["sums"], floor_lib, dev, cuda_ms))
    if "onehot" in kernels:
        res.update(_onehot(libs["onehot"], floor_lib, dev, cuda_ms))
    card = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    names = {"k1": "K1 map_crop", "k2": "K2 footprint_coll_point",
             "take": "K4b window_take",
             "sums": "K5c window_sums", "onehot": "K5d onehot_rows"}
    return {"variants": ", ".join(names[k] for k in kernels),
            "card": card, "kind": torch.cuda.get_device_name(dev),
            "rounds": ROUNDS, "reps": REPS, **res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier checkout whose "
                    "strive_tpu_torch/csrc is timed beside this one")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="the kernels to sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    res = run(args.parent, tuple(args.kernels))
    print(f"card: {res['card']}", file=sys.stderr)
    for key in [k for k in res if k.endswith("_ms")]:
        for label, ms in res[key].items():
            print(f"{key} {label:36s} {min(ms) * 1e3:8.2f}-"
                  f"{max(ms) * 1e3:8.2f} us", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
