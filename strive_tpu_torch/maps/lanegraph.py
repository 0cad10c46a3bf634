"""Lane graphs for the rule-based planners: nuScenes extraction (the
devkit imported inside it) and synthetic grids.

Copy of ``strive_tpu/maps/lanegraph.py``. Format (reference
``nuscenes_utils.py:50-122`` process_lanegraph):
``{'xy': (L, 2), 'in_edges': list[list[int]], 'out_edges': list[list[int]],
   'edges': (m, 5) = (x0, y0, hcos, hsin, len), 'edgeixes': (m, 2)}``
"""

from __future__ import annotations

import numpy as np


def _build_edges(xys, out_edges, eps=1e-6):
    """Edge table from vertex positions + adjacency
    (reference ``nuscenes_utils.py:106-122``)."""
    edges, edgeixes = [], []
    ee2ix = {}
    for i, outs in enumerate(out_edges):
        x0, y0 = xys[i]
        for e in outs:
            x1, y1 = xys[e]
            d = np.array([x1 - x0, y1 - y0])
            dist = np.linalg.norm(d)
            assert dist > eps
            d = d / dist
            ee2ix[(i, e)] = len(edges)
            edges.append([x0, y0, d[0], d[1], dist])
            edgeixes.append([i, e])
    return (np.array(edges), np.array(edgeixes, dtype=np.int64), ee2ix)


def process_nuscenes_lanegraph(nmap, res_meters=1.0, eps=1e-6):
    """Discretize a NuScenesMap's lanes into the graph format.

    Requires nuscenes-devkit; mirrors reference
    ``nuscenes_utils.py:50-104`` (1m discretization, duplicate removal,
    connector stitching).
    """
    from nuscenes.map_expansion.arcline_path_utils import discretize_lane

    lane_pts = {}
    for lane in nmap.lane + nmap.lane_connector:
        my_lane = nmap.arcline_path_3.get(lane["token"], [])
        pts = np.array(discretize_lane(my_lane, res_meters))[:, :2]
        # drop consecutive duplicates (keep >= 2 pts invariant)
        d = np.linalg.norm(pts[1:] - pts[:-1], axis=1)
        keep = np.ones(len(pts), bool)
        keep[:-1] = d > eps
        lane_pts[lane["token"]] = pts[keep]

    for intok, conn in nmap.connectivity.items():
        for outtok in conn["outgoing"]:
            if outtok in lane_pts and intok in lane_pts:
                if np.linalg.norm(lane_pts[outtok][0] - lane_pts[intok][-1]) <= eps:
                    lane_pts[intok] = lane_pts[intok][:-1]

    xys = []
    start = {}
    for lid, pts in lane_pts.items():
        start[lid] = len(xys)
        xys.extend(pts.tolist())
    in_edges = [[] for _ in xys]
    out_edges = [[] for _ in xys]
    for lid, pts in lane_pts.items():
        s = start[lid]
        for ix in range(len(pts) - 1):
            out_edges[s + ix].append(s + ix + 1)
            in_edges[s + ix + 1].append(s + ix)
        for outtok in nmap.connectivity[lid]["outgoing"]:
            if outtok in lane_pts:
                out_edges[s + len(pts) - 1].append(start[outtok])
        for intok in nmap.connectivity[lid]["incoming"]:
            if intok in lane_pts:
                in_edges[s].append(start[intok] + len(lane_pts[intok]) - 1)

    edges, edgeixes, _ = _build_edges(xys, out_edges, eps)
    return {"xy": np.array(xys), "in_edges": in_edges,
            "out_edges": out_edges, "edges": edges, "edgeixes": edgeixes}


def flip_lanegraph_x(lg, map_height_m):
    """Flip about the x axis (Singapore right-hand-drive conversion,
    reference ``map_env.py:131-144``)."""
    lg = dict(lg)
    xy = lg["xy"].copy()
    xy[:, 1] = map_height_m - xy[:, 1]
    lg["xy"] = xy
    edges = lg["edges"].copy()
    edges[:, 1] = map_height_m - edges[:, 1]
    edges[:, 3] *= -1
    lg["edges"] = edges
    return lg


def synthetic_lanegraph(extent_m=128.0, spacing_m=32.0, res_m=2.0):
    """Grid of straight bidirectional-by-pairs lanes for tests/benchmarks.

    Horizontal lanes run +x at y = k*spacing; vertical lanes run +y at
    x = k*spacing. Each lane is an independent chain (no turns) — enough
    structure for lane matching, spline building, and BFS expansion.
    """
    xys = []
    out_edges = []
    in_edges = []

    def add_lane(points):
        s = len(xys)
        n = len(points)
        xys.extend(points)
        out_edges.extend([[] for _ in range(n)])
        in_edges.extend([[] for _ in range(n)])
        for i in range(n - 1):
            out_edges[s + i].append(s + i + 1)
            in_edges[s + i + 1].append(s + i)

    n_pts = int(extent_m / res_m) + 1
    ts = np.linspace(0, extent_m, n_pts)
    for k in np.arange(spacing_m, extent_m, spacing_m):
        add_lane([(t, k) for t in ts])            # +x lane
        add_lane([(extent_m - t, k - spacing_m / 4) for t in ts])  # -x lane
        add_lane([(k, t) for t in ts])            # +y lane
        add_lane([(k - spacing_m / 4, extent_m - t) for t in ts])  # -y lane

    edges, edgeixes, _ = _build_edges(np.array(xys), out_edges)
    return {"xy": np.array(xys), "in_edges": in_edges,
            "out_edges": out_edges, "edges": edges, "edgeixes": edgeixes}


class _GraphBuilder:
    """Incremental polyline/fork lane-graph builder (test fixtures)."""

    def __init__(self):
        self.xys = []
        self.out_edges = []
        self.in_edges = []

    def add_chain(self, points, from_vertex=None):
        """Append a polyline; optionally connect its head to an existing
        vertex (creating a fork/merge). Returns (first_idx, last_idx)."""
        s = len(self.xys)
        n = len(points)
        self.xys.extend([tuple(p) for p in points])
        self.out_edges.extend([[] for _ in range(n)])
        self.in_edges.extend([[] for _ in range(n)])
        for i in range(n - 1):
            self.out_edges[s + i].append(s + i + 1)
            self.in_edges[s + i + 1].append(s + i)
        if from_vertex is not None:
            self.out_edges[from_vertex].append(s)
            self.in_edges[s].append(from_vertex)
        return s, s + n - 1

    def connect(self, a, b):
        self.out_edges[a].append(b)
        self.in_edges[b].append(a)

    def build(self):
        edges, edgeixes, _ = _build_edges(np.array(self.xys), self.out_edges)
        return {"xy": np.array(self.xys), "in_edges": self.in_edges,
                "out_edges": self.out_edges, "edges": edges,
                "edgeixes": edgeixes}


def synthetic_lanegraph_forks(res_m=2.0):
    """Fork-heavy test graph: a trunk that forks twice plus a merge.

    Layout (meters):
    - trunk along y=50 from x=0 to x=60,
    - FORK 1 at (60, 50): branch A straight to x=150, branch B curving up
      to y=90 then straight,
    - FORK 2 on branch A at (100, 50): A1 continues straight, A2 curves
      down to y=20,
    - branch B merges back into A1 at (140, 50).

    Exercises the device planner's branch codes (2 fork levels = the NBR=4
    (b1, b2) codes) and cluster dedupe on nearby parallel routes.
    """
    g = _GraphBuilder()
    ts = np.arange(0.0, 60.0 + res_m / 2, res_m)
    _, trunk_end = g.add_chain([(t, 50.0) for t in ts])

    # branch A: straight 60 -> 100
    ta = np.arange(60.0 + res_m, 100.0 + res_m / 2, res_m)
    a_start, a_end = g.add_chain([(t, 50.0) for t in ta],
                                 from_vertex=trunk_end)
    # fork 2: A1 straight 100 -> 150
    t1 = np.arange(100.0 + res_m, 150.0 + res_m / 2, res_m)
    a1_start, _ = g.add_chain([(t, 50.0) for t in t1], from_vertex=a_end)
    # fork 2: A2 curves down to y=20 (quarter-ish bend then straight)
    bend = [(100.0 + 10 * np.sin(u), 50.0 - 30 * (1 - np.cos(u)) / 2)
            for u in np.linspace(0.3, np.pi / 2, 12)]
    g.add_chain(bend + [(110.0 + t, 20.0) for t in
                        np.arange(res_m, 40.0, res_m)], from_vertex=a_end)

    # branch B from fork 1: curve up to y=90, run straight, merge into A1
    curve = [(60.0 + 20 * np.sin(u), 50.0 + 40 * (1 - np.cos(u)))
             for u in np.linspace(0.25, np.pi / 2, 14)]
    tb = np.arange(82.0, 130.0, res_m)
    _, b_end = g.add_chain(curve + [(t, 90.0) for t in tb],
                           from_vertex=trunk_end)
    # merge: descend and rejoin A1 at (140, 50)
    down = [(130.0 + 8 * np.sin(u), 90.0 - 40 * (1 - np.cos(u)))
            for u in np.linspace(0.3, np.pi / 2, 12)]
    _, d_end = g.add_chain(down, from_vertex=b_end)
    # connect merge end to the A1 vertex nearest x=140
    target = None
    best = 1e9
    for i, (x, y) in enumerate(g.xys):
        d = abs(x - 140.0) + abs(y - 50.0)
        if i >= a1_start and d < best:
            best, target = d, i
    g.connect(d_end, target)
    return g.build()


def synthetic_lanegraph_ring(center=(64.0, 64.0), radius=40.0, res_m=2.0):
    """Closed circular ring road (roundabout-like loop): constant curvature
    everywhere, no start/end — the walk wraps around. Exercises the curved
    route-spline warp and the chain walk on a cyclic graph."""
    n = int(round(2 * np.pi * radius / res_m))
    u = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    pts = [(center[0] + radius * np.cos(a), center[1] + radius * np.sin(a))
           for a in u]
    g = _GraphBuilder()
    s, e = g.add_chain(pts)
    g.connect(e, s)  # close the loop
    return g.build()
