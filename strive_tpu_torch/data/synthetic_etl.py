"""A synthetic ETL directory in exactly the format of real nuScenes.

``strive_tpu_torch.scripts.preprocess_nuscenes`` turns the nuScenes
download into ``{data_dir}/strive_tpu_etl/{version}/{maps.npz,
lane_graphs.pkl, scenes.npz, meta.json}``. Neither the download nor the
devkit is in the repository, so :func:`write_synthetic_etl` writes such a
directory from synthetic content through the same code: the maps go
through ``rasterize_maps`` (nuScenes' map extents from ``NUSC_MAP_SIZES``,
the road layers collapsed into channel 0, Singapore flipped, each map's
``dx`` = extent / round(extent x pix_per_m)), the scenes through
``finalize_scene_states`` (the drivable/carpark frame filter, then the
finite-difference states), the lane graphs through ``flip_lanegraph_x``
for Singapore.

The arrays are written with plain ``np.savez``, where the preprocessing
compresses (``np.savez_compressed``): ``np.load`` reads both alike, and
compressing a raster of gigabytes costs tens of seconds.

Content, in the devkit's frame (before the flip): a grid of roads over the
whole extent, one band a ``synthetic_lanegraph`` lane pair (the +x lane at
y = k x spacing, the -x lane spacing / 4 below it, likewise in y), a
carpark square in every other block, divider lines inside the bands. Each
scene is 2 Hz with an ego seen at every frame and other agents driving
along the lanes near it (a platoon ahead of it on its lane, traffic on
the opposite lane), each seen over an interval of frames (at least its
first or its second half) with a chance of a gap inside it.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..maps.lanegraph import flip_lanegraph_x, synthetic_lanegraph
from ..maps.store import DEFAULT_LAYERS, NUSC_MAP_SIZES, ROAD_LAYERS

ROAD_HALF_M = 5.0  # road margin beyond the outer lanes of a band (m)
GAP_M = 8.0  # least distance of another lane's agent from the ego's start
LEAD_GAP_M = 9.0  # between the centers of the ego and its platoon
NEAR_M = 70.0  # other agents' lanes pass this close to the ego's start
CATEGORIES = ("car", "truck")
# the lane grid: 256 m apart, a vertex every 4 m (52,000 vertices on the
# largest map, which the numpy rule planner scans a query)
SPACING_M, LANE_RES_M = 256.0, 4.0


class SyntheticNuscMap:
    """Stands in for the devkit's ``NuScenesMap`` in ``rasterize_maps``:
    ``get_map_mask(None, 0.0, layers, (H, W))`` of the synthetic content
    over a map of ``size_m`` = (H, W) meters."""

    def __init__(self, size_m, spacing_m):
        self.size_m = tuple(float(v) for v in size_m)
        self.spacing = float(spacing_m)

    def _bands(self, extent_m):
        """(lo, hi) meters of each road band across one axis."""
        S = self.spacing
        return [(k - S / 4 - ROAD_HALF_M, k + ROAD_HALF_M)
                for k in np.arange(S, extent_m, S)]

    def get_map_mask(self, patch_box, angle, layers, canvas_size):
        assert patch_box is None and angle == 0.0
        H, W = canvas_size
        sy, sx = H / self.size_m[0], W / self.size_m[1]  # px per meter
        out = np.zeros((len(layers), H, W), np.uint8)

        def rows(lo, hi):
            return slice(max(int(lo * sy), 0), max(int(hi * sy), 0))

        def cols(lo, hi):
            return slice(max(int(lo * sx), 0), max(int(hi * sx), 0))

        S = self.spacing
        for i, layer in enumerate(layers):
            m = out[i]
            if layer in ROAD_LAYERS:
                for lo, hi in self._bands(self.size_m[0]):
                    m[rows(lo, hi), :] = 1
                for lo, hi in self._bands(self.size_m[1]):
                    m[:, cols(lo, hi)] = 1
            elif layer == "carpark_area":
                for a, ky in enumerate(np.arange(S, self.size_m[0], S)):
                    for b, kx in enumerate(np.arange(S, self.size_m[1], S)):
                        if (a + b) % 2 == 0:
                            m[rows(ky + 2 * ROAD_HALF_M,
                                   ky + 2 * ROAD_HALF_M + S / 4),
                              cols(kx + 2 * ROAD_HALF_M,
                                   kx + 2 * ROAD_HALF_M + S / 4)] = 1
            else:  # a divider line inside every band
                off = -S / 8 if layer == "road_divider" else 1.5
                for k in np.arange(S, self.size_m[0], S):
                    m[rows(k + off, k + off + 0.5), :] = 1
                for k in np.arange(S, self.size_m[1], S):
                    m[:, cols(k + off, k + off + 0.5)] = 1
        return out


def _scene(rng, name, map_idx, mname, lanes, frames, agents, categories,
           flip):
    """One scene in ``extract_scenes``' raw format, NaN where unseen: an
    ego on a random lane; other agents on the lanes parallel to it that
    pass within ``NEAR_M`` of its start: on its own lane in a platoon
    ahead of it (``LEAD_GAP_M`` apart at its speed, so nobody runs into
    the ego), on the others near it at random speeds. The devkit frame is flipped
    about x for Singapore (``preprocess_nuscenes.extract_scenes``)."""
    mheight = NUSC_MAP_SIZES[mname][0]
    n = int(rng.integers(agents[0], agents[1] + 1))
    T = frames
    t = np.arange(T) * 0.5
    cat2vec = {c: np.eye(len(categories), dtype=np.float32)[i]
               for i, c in enumerate(sorted(categories))}
    start = np.array([l[0] for l in lanes])
    head = np.array([l[1] for l in lanes])
    length = np.array([l[2] for l in lanes])
    raw_x = np.full((n, T, 4), np.nan)
    lw, sems, kinds = [], [], []
    lead_slots = list(rng.permutation(np.arange(1, 8)))
    for a in range(n):
        if a == 0:
            li = li0 = int(rng.integers(len(lanes)))
            speed = v0 = (0.0 if rng.random() < 0.15
                          else float(rng.uniform(2.0, 12.0)))
            s0 = s_ego = float(rng.uniform(0.1, 0.6)) * length[li]
        else:
            li = int(rng.choice(near))
            if li == li0 and not lead_slots:
                li = int(rng.choice(near[near != li0])) if (
                    near != li0).any() else li0
        if a > 0 and li == li0 and lead_slots:
            speed = v0
            s0 = s_ego + LEAD_GAP_M * lead_slots.pop()
        elif a > 0:
            speed = (0.0 if rng.random() < 0.15
                     else float(rng.uniform(2.0, 12.0)))
            for _ in range(8):  # at least GAP_M from the ego at the start
                s0 = float(np.clip(
                    (ego0 - start[li]) @ head[li]
                    + rng.uniform(-NEAR_M / 2, NEAR_M / 2), 0.0,
                    max(length[li] - speed * t[-1], 0.0)))
                if np.linalg.norm(start[li] + s0 * head[li] - ego0) >= GAP_M:
                    break
        s = s0 + speed * t
        (x0, y0), (hc, hs) = start[li], head[li]
        x = np.stack([x0 + s * hc, y0 + s * hs, np.full(T, hc),
                      np.full(T, hs)], axis=1)
        x[:, :2] += rng.normal(0.0, 0.05, (1, 2))
        if a == 0:  # the ego is seen throughout; the others over an interval
            ego0 = x[0, :2]
            rel = ego0 - start
            along = np.clip(np.sum(rel * head, axis=1), 0.0, length)
            dist = np.linalg.norm(rel - along[:, None] * head, axis=1)
            parallel = np.abs(head @ head[li0]) > 0.9
            near = np.nonzero((dist < NEAR_M) & parallel)[0]
        else:
            first = int(rng.integers(0, T // 2))
            last = int(rng.integers(max(first + 2, T // 2), T + 1))
            seen = np.zeros(T, bool)
            seen[first:last] = True
            if last - first > 4 and rng.random() < 0.3:
                seen[int(rng.integers(first + 1, last - 1))] = False
            x[~seen] = np.nan
        raw_x[a] = x
        kind = "car" if rng.random() < 0.8 or "truck" not in categories \
            else "truck"
        if kind == "car":
            lw.append([rng.uniform(3.8, 5.2), rng.uniform(1.7, 2.1)])
        else:
            lw.append([rng.uniform(6.0, 10.0), rng.uniform(2.3, 2.8)])
        sems.append(cat2vec[kind])
        kinds.append(kind)
    if flip:
        raw_x[..., 1] = mheight - raw_x[..., 1]
        raw_x[..., 3] = -raw_x[..., 3]
    raw_h = np.arctan2(raw_x[..., 3], raw_x[..., 2])
    return {
        "raw_x": raw_x, "raw_h": raw_h, "ts": t + 1.0,
        "lw": np.asarray(lw, np.float32), "sem": np.stack(sems),
        "map_idx": map_idx, "name": name, "kinds": kinds,
        "agent_tokens": ["ego"] + [f"{name}-agent{a}" for a in range(1, n)],
        "sample_tokens": [f"{name}-sample{i}" for i in range(T)],
    }


def write_synthetic_etl(data_dir, version="trainval", num_scenes=850,
                        with_data=None, pix_per_m=4.0, frames=40,
                        agents=(10, 40), maps=None, spacing_m=SPACING_M,
                        lane_res_m=LANE_RES_M, seed=0, device="cpu"):
    """Write ``{data_dir}/strive_tpu_etl/{version}/`` as
    ``preprocess_nuscenes`` does, from synthetic content.

    :param num_scenes: scene names ``scene-0001`` ... in ``meta.json``
    :param with_data: indices of the names whose scenes are written to
        ``scenes.npz`` (default all); the others are listed only, as a
        split's name list may hold scenes the payload lacks
    :param maps: map names (default all of ``NUSC_MAP_SIZES``); scene i
        lies on map ``i % len(maps)``
    :param spacing_m, lane_res_m: the lane grid's spacing and vertex step
    :param device: where the frame filter reads the raster
    :return: the directory
    """
    from ..scripts.preprocess_nuscenes import (finalize_scene_states,
                                               rasterize_maps)

    maps = list(maps or NUSC_MAP_SIZES)
    out_dir = os.path.join(data_dir, "strive_tpu_etl", version)
    os.makedirs(out_dir, exist_ok=True)
    nmaps = {m: SyntheticNuscMap(NUSC_MAP_SIZES[m], spacing_m) for m in maps}
    layers = list(DEFAULT_LAYERS)
    raster, dx, map_list = rasterize_maps(nmaps, layers, pix_per_m)
    np.savez(os.path.join(out_dir, "maps.npz"), raster=raster, dx=dx)

    lgs, lanes = {}, {}
    for m in map_list:
        extent = min(NUSC_MAP_SIZES[m])
        lg = synthetic_lanegraph(extent_m=extent, spacing_m=spacing_m,
                                 res_m=lane_res_m)
        # lane chains as (start, unit direction, length), devkit frame
        lanes[m] = []
        xy, out_edges = lg["xy"], lg["out_edges"]
        for s, ins in enumerate(lg["in_edges"]):
            if ins:
                continue  # not the start of a chain
            e = s
            while out_edges[e]:
                e = out_edges[e][0]
            d = xy[e] - xy[s]
            ln = float(np.linalg.norm(d))
            lanes[m].append((tuple(xy[s]), tuple(d / ln), ln))
        lgs[m] = flip_lanegraph_x(lg, NUSC_MAP_SIZES[m][0]) \
            if m.startswith("singapore") else lg
    with open(os.path.join(out_dir, "lane_graphs.pkl"), "wb") as f:
        pickle.dump(lgs, f)

    rng = np.random.default_rng(seed)
    names = ["scene-%04d" % (i + 1) for i in range(num_scenes)]
    keep = range(num_scenes) if with_data is None else sorted(with_data)
    scenes = {}
    for i in keep:
        mi = i % len(map_list)
        m = map_list[mi]
        scenes[names[i]] = _scene(rng, names[i], mi, m, lanes[m], frames,
                                  agents, CATEGORIES,
                                  m.startswith("singapore"))
    carpark = 1 + [l for l in layers if l not in ROAD_LAYERS].index(
        "carpark_area")
    scenes = finalize_scene_states(scenes, raster, dx, carpark,
                                   device=device)
    np.savez(os.path.join(out_dir, "scenes.npz"),
             scenes=np.array(scenes, dtype=object))
    meta = {"map_names": map_list, "scene_names": sorted(names),
            "version": version, "categories": list(CATEGORIES)}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
