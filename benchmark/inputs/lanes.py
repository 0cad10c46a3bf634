"""The lane graph of the raster's lane grid on nuScenes' four maps.

The lanes of ``maps.lanes`` (four a band, every ``spacing_m``, over the
square of each map's shorter extent: where ``scenes.py`` puts its agents),
discretised as ``process_nuscenes_lanegraph`` does nuScenes' lanes: a
vertex every ``res_m`` from the lane's start, and its end. At every
crossing of two lanes a turn connector runs from the last vertex of the
one at least ``res_m / 2`` before the crossing to the first vertex of the
other at least ``res_m / 2`` past it, each way, so that every lane forks
at every junction and merges there (nuScenes' lanes do; a grid without
them would leave the planner's branch walks idle). The Singapore maps are
flipped about x, as the raster and the scenes are. The graph depends on no
seed: like the raster, the map is the same in every run.

The format is the lane-graph dict of the planners: ``xy`` (V, 2),
``in_edges`` / ``out_edges`` (a list of vertex ids a vertex), ``edges``
(E, 5) = (x0, y0, hcos, hsin, length) and ``edgeixes`` (E, 2). Every
lane's own edges come first, lane by lane, then the connectors; a vertex
lists its own lane first in ``out_edges`` and ``in_edges``, so a walk's
first successor and predecessor stay on the lane.
"""

from __future__ import annotations

import numpy as np

from .maps import lanes


def _bands(extent, spacing):
    return len(np.arange(spacing, extent, spacing))


def lane_vertices(length, res):
    """Arc lengths of a lane's vertices: every ``res`` from 0, and the
    end."""
    s = np.arange(0.0, length, res)
    if length - s[-1] > 1e-6:
        s = np.append(s, length)
    return s


def edge_count(extent, spacing, res=1.0):
    """Edges of one map's graph: 4 lanes a band of ``ceil(extent / res)``
    edges each, and two connectors at each of the (2 x bands)^2 crossings
    of a horizontal and a vertical lane."""
    nb = _bands(extent, spacing)
    return 4 * nb * (len(lane_vertices(extent, res)) - 1) + 8 * nb * nb


def graph(store, name, res=1.0):
    """:return: the lane-graph dict of map ``name`` (module doc)."""
    extent = min(store["extents_m"][name])
    ls = lanes(extent, store["spacing_m"])
    xys, first, arcs = [], [], []
    for p0, d, length in ls:
        s = lane_vertices(length, res)
        first.append(sum(len(a) for a in arcs))
        arcs.append(s)
        xys.append(np.asarray(p0) + s[:, None] * np.asarray(d))
    xy = np.concatenate(xys)
    V = len(xy)
    out_edges = [[] for _ in range(V)]
    in_edges = [[] for _ in range(V)]
    src, dst = [], []
    for li, s in enumerate(arcs):
        v = first[li] + np.arange(len(s))
        src.append(v[:-1])
        dst.append(v[1:])
        for a, b in zip(v[:-1].tolist(), v[1:].tolist()):
            out_edges[a].append(b)
            in_edges[b].append(a)
    horiz = [i for i, (_, d, _) in enumerate(ls) if d[1] == 0.0]
    vert = [i for i, (_, d, _) in enumerate(ls) if d[0] == 0.0]
    csrc, cdst = [], []
    for a_set, b_set in ((horiz, vert), (vert, horiz)):
        for a in a_set:
            for b in b_set:
                pa, da, _ = ls[a]
                pb, db, _ = ls[b]
                # the crossing, at arc length sa on lane a and sb on lane b
                cross = np.where(np.asarray(da) == 0.0, pa, pb)
                sa = float(np.dot(cross - np.asarray(pa), da))
                sb = float(np.dot(cross - np.asarray(pb), db))
                ia = int(np.searchsorted(arcs[a], sa - res / 2, "right")) - 1
                ib = int(np.searchsorted(arcs[b], sb + res / 2, "left"))
                if ia < 0 or ib >= len(arcs[b]):
                    continue
                u, w = first[a] + ia, first[b] + ib
                out_edges[u].append(w)
                in_edges[w].append(u)
                csrc.append(u)
                cdst.append(w)
    ix = np.stack([np.concatenate(src + [np.asarray(csrc, np.int64)]),
                   np.concatenate(dst + [np.asarray(cdst, np.int64)])], 1)
    if store["flip_singapore"] and name.startswith("singapore"):
        xy = xy.copy()
        xy[:, 1] = store["extents_m"][name][0] - xy[:, 1]
    d = xy[ix[:, 1]] - xy[ix[:, 0]]
    length = np.linalg.norm(d, axis=1)
    edges = np.concatenate([xy[ix[:, 0]], d / length[:, None],
                            length[:, None]], 1)
    return {"xy": xy, "in_edges": in_edges, "out_edges": out_edges,
            "edges": edges, "edgeixes": ix.astype(np.int64)}


def graphs(store, res=1.0):
    """{map name: lane-graph dict} of every map of the store."""
    return {name: graph(store, name, res) for name in store["maps"]}
