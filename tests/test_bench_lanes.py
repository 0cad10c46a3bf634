"""The closed-loop cell's lane graph (``benchmark/inputs/lanes.py``) at a
small extent: its edge count, a fork and a merge of every lane at every
junction, the Singapore flip of the raster, and a graph that depends on
nothing but the store."""

import copy

import numpy as np
import pytest

from benchmark.harness import BENCH, load_json
from benchmark.inputs import lanes, maps


def _store():
    st = copy.deepcopy(load_json(BENCH / "configs"
                                 / "strive_adv_rule_nusc.json")["store"])
    st["extents_m"] = {k: [v[0] / 8, v[1] / 8]
                       for k, v in st["extents_m"].items()}
    st["spacing_m"] = 64.0
    st["pix_per_m"] = 1.0
    return st


STORE = _store()
MAPS = STORE["maps"]


@pytest.fixture(scope="module")
def graphs():
    return lanes.graphs(STORE)


@pytest.mark.parametrize("name", MAPS)
def test_edge_count_matches_its_formula(graphs, name):
    extent = min(STORE["extents_m"][name])
    g = graphs[name]
    nb = len(np.arange(STORE["spacing_m"], extent, STORE["spacing_m"]))
    per_lane = int(np.ceil(extent - 1e-6))  # a vertex a metre, and the end
    assert len(g["edges"]) == lanes.edge_count(extent, STORE["spacing_m"])
    assert len(g["edges"]) == 4 * nb * per_lane + 8 * nb * nb
    assert len(g["edgeixes"]) == len(g["edges"])
    assert sum(map(len, g["out_edges"])) == len(g["edges"])
    assert sum(map(len, g["in_edges"])) == len(g["edges"])
    np.testing.assert_allclose(
        g["edges"][:, 4],
        np.linalg.norm(g["xy"][g["edgeixes"][:, 1]]
                       - g["xy"][g["edgeixes"][:, 0]], axis=1))
    assert g["edges"][:, 4].max() < 2.0 and g["edges"][:, 4].min() > 0


@pytest.mark.parametrize("name", MAPS)
def test_every_lane_forks_and_merges_at_every_junction(graphs, name):
    """A lane crosses the two lanes of every band of the other direction:
    one vertex before each crossing forks onto the crossing lane (its own
    lane first), one past it takes the merge, both within 1.5 m."""
    extent = min(STORE["extents_m"][name])
    ls = maps.lanes(extent, STORE["spacing_m"])
    g = graphs[name]
    xy = g["xy"]
    if name.startswith("singapore"):
        xy = xy.copy()
        xy[:, 1] = STORE["extents_m"][name][0] - xy[:, 1]
    first = 0
    for p0, d, length in ls:
        n = len(lanes.lane_vertices(length, 1.0))
        v = np.arange(first, first + n)
        first += n
        forks = [u for u in v if len(g["out_edges"][u]) == 2]
        merges = [u for u in v if len(g["in_edges"][u]) == 2]
        crosses = [np.where(np.asarray(d) == 0.0, p0, q0)
                   for q0, e, _ in ls if np.dot(e, d) == 0.0]
        assert len(forks) == len(merges) == len(crosses) > 0
        for u in v[:-1]:
            assert g["out_edges"][u][0] == u + 1  # its own lane first
        for ends in (forks, merges):
            near = [int(np.argmin([np.linalg.norm(xy[u] - c)
                                   for c in crosses])) for u in ends]
            assert sorted(near) == list(range(len(crosses)))
            assert all(np.linalg.norm(xy[u] - crosses[k]) <= 1.5
                       for u, k in zip(ends, near))
        for u in forks:  # the turn lands on the crossing lane
            c = crosses[int(np.argmin([np.linalg.norm(xy[u] - c)
                                       for c in crosses]))]
            assert abs(np.dot(xy[g["out_edges"][u][1]] - c, d)) < 1e-6


def test_singapore_flipped_as_the_raster(graphs):
    """Every lane vertex lies on the road layer of the store's raster (the
    Singapore maps flipped about x as the raster and the scenes are), and
    the unflipped graph is the mirror image."""
    import torch

    r, dx = maps.raster(STORE, torch.device("cpu"))
    r, dx = r.numpy(), dx.numpy()
    for mi, name in enumerate(MAPS):
        g = graphs[name]
        xy = g["xy"]
        row = np.floor(xy[:, 1] / dx[mi, 0]).astype(int)
        col = np.floor(xy[:, 0] / dx[mi, 1]).astype(int)
        h, w = maps.sizes(STORE)[0][mi]
        inside = (row < h) & (col < w)
        assert inside.mean() > 0.95
        assert (r[mi, 0, row[inside], col[inside]] == 1).all(), name
        plain = lanes.graph(dict(STORE, flip_singapore=False), name)
        if name.startswith("singapore"):
            h = STORE["extents_m"][name][0]
            np.testing.assert_allclose(g["xy"][:, 1], h - plain["xy"][:, 1])
            np.testing.assert_allclose(g["edges"][:, 3],
                                       -plain["edges"][:, 3])
        else:
            np.testing.assert_array_equal(g["xy"], plain["xy"])


def test_the_same_store_gives_the_same_graph(graphs):
    again = lanes.graphs(STORE)
    for name in MAPS:
        for k in ("xy", "edges", "edgeixes"):
            np.testing.assert_array_equal(again[name][k], graphs[name][k])
        assert again[name]["out_edges"] == graphs[name]["out_edges"]
        assert again[name]["in_edges"] == graphs[name]["in_edges"]
