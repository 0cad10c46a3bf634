"""Wrapper of the device planner's lane-match kernel, ``csrc/lane_match.cu``.

``lane_match`` gives each pose's closest-first lane representatives: the
edges of its own map that match it, picked closest first with spatial
dedupe, as ``device_planner._cluster_reps(*device_planner._match_edges(...))``
computes them over every stacked edge. Those two functions are its plain
version (any device), and ``device_planner._match_reps`` takes them on the
CPU and this kernel on a card. The design notes and bounds are in the CUDA
source.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream, raises
if the launch failed, and adds one to ``LAUNCHES["lane_match"]``. Under a
CUDA graph's capture nothing is launched: the device planner's
``_CapturedRollout`` takes back what its capture counted here and adds it
at each replay, which runs the captured launches, so ``LAUNCHES`` counts
the kernel's runs.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import launch
from ..utils.launch import INT as _I, PTR as _P

SOURCE = "lane_match"

# the kernel's rounds at most (kMaxMC in csrc/lane_match.cu)
MAX_MC = 8

# the kernel's runs: the wrapper's calls, and the launches a replayed
# CUDA graph runs (module doc)
LAUNCHES = {"lane_match": 0}

_F = ctypes.c_float
_LIB = launch.Library(SOURCE, {
    # x, y, c, s, mid, offsets, n_maps, edges, N, cdistmax, xydistmax,
    # dedupe_r, MC, reps, valid, stream
    "strive_lane_match": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _F, _F, _F,
                          _I, _P, _P, _P],
})


def lane_match(x, y, c, s, mid, offsets, edges, cdistmax, xydistmax,
               dedupe_r, MC):
    """Closest-first representatives of N poses among their own map's
    edges (module doc).

    :param x, y, c, s: (N,) float32 positions and the heading's cos and sin
    :param mid: (N,) int64 map ids; offsets: (n_maps + 1,) int64, map m's
        edges are rows ``offsets[m]`` to ``offsets[m + 1]`` of ``edges``
    :param edges: (E, 5) float32 x0, y0, hcos, hsin, length
    :param cdistmax, xydistmax, dedupe_r: the match's and the dedupe's
        thresholds, compared in float32
    :param MC: rounds, 1 to ``MAX_MC``
    :return: reps (N, MC) int64 stacked edge ids, rep_valid (N, MC) bool;
        a round with nothing left gives id 0, not valid
    """
    device = x.device
    for name, t in (("x", x), ("y", y), ("c", c), ("s", s)):
        launch.check(name, t, torch.float32, 1, device)
    launch.check("mid", mid, torch.int64, 1, device)
    launch.check("offsets", offsets, torch.int64, 1, device)
    launch.check("edges", edges, torch.float32, 2, device, last=5)
    N = x.shape[0]
    if any(t.shape[0] != N for t in (y, c, s, mid)):
        raise ValueError("x, y, c, s and mid must have one entry per pose")
    if not 1 <= MC <= MAX_MC:
        raise ValueError(f"MC must be in [1, {MAX_MC}], got {MC}")
    if N >= 2 ** 28 or edges.shape[0] >= 2 ** 31 or offsets.shape[0] < 2:
        raise ValueError("lane_match takes fewer than 2^28 poses, fewer "
                         "than 2^31 edges and at least one map")
    reps = torch.empty((N, MC), dtype=torch.int64, device=device)
    valid = torch.empty((N, MC), dtype=torch.bool, device=device)
    if N == 0:
        return reps, valid
    _LIB.launch(
        "strive_lane_match", x.data_ptr(), y.data_ptr(), c.data_ptr(),
        s.data_ptr(), mid.data_ptr(), offsets.data_ptr(),
        offsets.shape[0] - 1, edges.data_ptr(), N, float(cdistmax),
        float(xydistmax), float(dedupe_r), int(MC), reps.data_ptr(),
        valid.data_ptr(), launch.stream(device))
    LAUNCHES["lane_match"] += 1
    return reps, valid
