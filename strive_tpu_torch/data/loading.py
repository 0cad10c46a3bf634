"""Data and map loading for the entry points.

Port of ``strive_tpu/data/loading.py``. Three data versions:
- 'synthetic': procedurally generated scenes and maps, the same for a seed
  as the JAX package's,
- 'mini'/'trainval': real nuScenes through the offline ETL
  (``strive_tpu_torch.data.etl``), read from the npz files that
  ``strive_tpu_torch.scripts.preprocess_nuscenes`` writes under
  ``{data_dir}/strive_tpu_etl/{version}``.
Saved scenarios (``--scenario_dir``) are appended to the training split.
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
    map. For real nuScenes, loads the ETL output directory
    ``{data_dir}/strive_tpu_etl/{version}`` (a missing directory raises
    ``FileNotFoundError``).

    :param pix_per_m: optional raster resolution override (nearest
        upsampling: the reference re-rasterizes at 8 px/m for qualitative
        eval, ``eval_adv_gen.py:683``)
    """
    cats = effective_categories(cfg.agent_types,
                                getattr(cfg, "reduce_cats", False))
    state_norm = state_normalizer_for(cats)
    att_norm = att_normalizer_for(cats)
    nc = len(cats)

    if cfg.data_version == "synthetic":
        seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        num = getattr(cfg, "synth_scenes", 24)
        store = synthetic_map_store(num_maps=2, size_px=512, channels=4,
                                    pix_per_m=4.0, device=device)
        if pix_per_m is not None and pix_per_m > 4.0:
            store = upsample_store(store, int(round(pix_per_m / 4.0)))
        scenes = synthetic_scene_list(
            num_scenes=num, num_maps=2, map_size_px=512, PT=cfg.past_len,
            FT=cfg.future_len, NC=nc, min_agents=2,
            max_agents=cfg.max_agents, seed=seed, categories=cats,
        )
        ds = SceneDataset(scenes, cfg.max_agents, nc,
                          buckets=parse_buckets(cfg), device=device)
        lgs = None
        if load_lanegraph:
            lg = synthetic_lanegraph(extent_m=128.0, spacing_m=32.0)
            lgs = {name: lg for name in store.map_names}
        ds = _maybe_append_scenarios(ds, cfg, split, store, state_norm,
                                     att_norm, nc, device)
        return ds, store, lgs, state_norm, att_norm

    # real nuScenes via ETL artifacts
    from .etl import load_etl_dataset

    etl_dir = os.path.join(cfg.data_dir, "strive_tpu_etl", cfg.data_version)
    ds, store, lgs, state_norm, att_norm = load_etl_dataset(
        etl_dir, split, cfg, state_norm, att_norm,
        load_lanegraph=load_lanegraph, device=device)
    if pix_per_m is not None:
        # one integer factor for the whole stacked raster, from the FINEST
        # map: every map ends at <= pix_per_m (strive_tpu/data/loading.py:83-93)
        native_finest = 1.0 / float(store.dx.min())
        if pix_per_m > native_finest:
            store = upsample_store(store,
                                   int(round(pix_per_m / native_finest)))
    ds = _maybe_append_scenarios(ds, cfg, split, store, state_norm, att_norm,
                                 nc, device)
    return ds, store, lgs, state_norm, att_norm


def _maybe_append_scenarios(ds, cfg, split, store, state_norm, att_norm, nc,
                            device):
    """Append saved adversarial scenarios to the training set
    (reference ``--scenario_dir``, ``nuscenes_dataset.py:197-204``)."""
    scen_dir = getattr(cfg, "scenario_dir", None)
    if not scen_dir or split != "train" or not os.path.isdir(scen_dir):
        return ds
    from .dataset import ConcatSceneDataset
    from .etl import WindowedSceneDataset
    from .scenario_ingest import scenarios_as_scenes

    raw = scenarios_as_scenes(scen_dir, list(store.map_names), nc)
    if not raw:
        return ds
    extra = WindowedSceneDataset(
        raw, cfg.max_agents, nc, cfg.past_len, cfg.future_len,
        state_norm, att_norm, seq_interval=1,
        noise_std=getattr(cfg, "data_noise_std", 0.0),
        include_final_window=True, device=device,
    )
    print(f"Appended {len(extra)} scenario windows from {scen_dir}")
    return ConcatSceneDataset([ds, extra])
