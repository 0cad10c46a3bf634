"""Data and map loading for the entry points.

Port of ``strive_tpu/data/loading.py``, synthetic branch only
(``loading.py:33-70``): procedurally generated scenes and maps, the same
for a seed as the JAX package's. Real nuScenes (the ETL output) and the
appending of saved scenarios to the training set wait for the data port
(P10) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os

from ..maps.lanegraph import synthetic_lanegraph
from ..maps.store import synthetic_map_store, upsample_store
from ..normalize import (att_normalizer_for, effective_categories,
                         state_normalizer_for)
from .dataset import SceneDataset
from .synthetic import synthetic_scene_list


def parse_buckets(cfg):
    """cfg.na_buckets 'a,b,c' -> tuple | None."""
    raw = getattr(cfg, "na_buckets", None)
    if not raw:
        return None
    return tuple(int(x) for x in str(raw).split(",") if x.strip())


def load_environment(cfg, split="train", load_lanegraph=False,
                     pix_per_m=None, device="cuda"):
    """Returns (SceneDataset, MapStore, lane_graphs|None, state_norm,
    att_norm), the dataset's batches and the store on ``device``.

    For 'synthetic', fabricates ``cfg.synth_scenes`` scenes per split from
    the split's seed, on 2 maps of 512 px x 4 channels at 4 px/m, and with
    ``load_lanegraph`` one ``synthetic_lanegraph(128 m, spacing 32 m)`` per
    map.

    :param pix_per_m: optional raster resolution override (nearest
        upsampling of the 4 px/m maps)
    """
    cats = effective_categories(cfg.agent_types,
                                getattr(cfg, "reduce_cats", False))
    state_norm = state_normalizer_for(cats)
    att_norm = att_normalizer_for(cats)
    nc = len(cats)

    if cfg.data_version != "synthetic":
        raise NotImplementedError(
            f"data_version {cfg.data_version!r}: the nuScenes ETL is not "
            "ported yet (P10); use 'synthetic'")
    seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
    num = getattr(cfg, "synth_scenes", 24)
    store = synthetic_map_store(num_maps=2, size_px=512, channels=4,
                                pix_per_m=4.0, device=device)
    if pix_per_m is not None and pix_per_m > 4.0:
        store = upsample_store(store, int(round(pix_per_m / 4.0)))
    scenes = synthetic_scene_list(
        num_scenes=num, num_maps=2, map_size_px=512, PT=cfg.past_len,
        FT=cfg.future_len, NC=nc, min_agents=2, max_agents=cfg.max_agents,
        seed=seed, categories=cats,
    )
    ds = SceneDataset(scenes, cfg.max_agents, nc, buckets=parse_buckets(cfg),
                      device=device)
    lgs = None
    if load_lanegraph:
        lg = synthetic_lanegraph(extent_m=128.0, spacing_m=32.0)
        lgs = {name: lg for name in store.map_names}
    _check_no_scenarios(cfg, split)
    return ds, store, lgs, state_norm, att_norm


def _check_no_scenarios(cfg, split):
    """Saved adversarial scenarios appended to the training set (reference
    ``--scenario_dir``, ``nuscenes_dataset.py:197-204``) are not ported."""
    scen_dir = getattr(cfg, "scenario_dir", None)
    if scen_dir and split == "train" and os.path.isdir(scen_dir):
        raise NotImplementedError(
            "appending saved scenarios (--scenario_dir) is not ported yet "
            "(P10)")
