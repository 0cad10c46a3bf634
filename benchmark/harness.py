"""What every driver shares: the run's record, its inputs and the program
built from them.

The inputs (raster, weights, scenes) are made here from the seed; the
program (``strive_tpu_torch``) is handed them and derives its own state
(the packed raster, its parameters); the reference gets the same inputs
and derives its own again.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def now():
    return time.perf_counter()


class Run:
    """One run of one cell: its settings, and what the driver and the
    tracer record. Metric readers (``metrics/<name>.py``) read it."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.setup_s = None
        self.window_s = None
        self.attempted = 0
        self.failed = 0
        self.work = {}       # counts of the window's work, by kind
        self.data_wait_s = None
        self.unit_s = []     # seconds of each batch or step of the window
        self.tracer = None   # trace.Tracer when traced
        self.profile = None  # trace.summarize() of the profiled span
        self.checks = []     # (name, value, limit)
        self.state = {}      # the driver's own


def load_json(path):
    with open(path) as f:
        return json.load(f)


_RASTERS = {}


def raster(store_cfg, device):
    """The store's (M, C, H, W) raster and (M, 2) dx on ``device``; made
    once a process (the content has no seed)."""
    from .inputs import maps

    key = (json.dumps(store_cfg, sort_keys=True), str(device))
    if key not in _RASTERS:
        _RASTERS[key] = maps.raster(store_cfg, device)
    return _RASTERS[key]


def program_store(store_cfg, device):
    """The program's map store of the raster (it packs the bits itself)."""
    from strive_tpu_torch.maps.store import MapStore

    r, dx = raster(store_cfg, device)
    return MapStore.from_raster(r, dx, tuple(store_cfg["maps"]))


def normalizers(m):
    from strive_tpu_torch.normalize import MeanStdNormalizer

    st, at = m["norm"]["state"], m["norm"]["att"]
    return (MeanStdNormalizer(st["mean"], st["std"]),
            MeanStdNormalizer(at["mean"], at["std"]))


def program_model(m, weights, device):
    """The program's ``TrafficModel`` of configuration ``m``, loaded with
    ``weights`` (copied: the dict stays the benchmark's)."""
    from strive_tpu_torch.dynamics import BikeParams
    from strive_tpu_torch.model.traffic_model import NormConfig, TrafficModel

    st, at = m["norm"]["state"], m["norm"]["att"]
    model = TrafficModel(
        npast=m["past_len"], nfuture=m["future_len"],
        map_obs_size_pix=m["map_obs_size_pix"],
        nclasses=len(m["agent_types"]),
        norm=NormConfig(tuple(st["mean"]), tuple(st["std"]),
                        tuple(at["mean"]), tuple(at["std"])),
        bike=BikeParams(**m["bike"]), map_feat_size=m["map_feat_size"],
        past_feat_size=m["past_feat_size"],
        future_feat_size=m["future_feat_size"],
        latent_size=m["latent_size"],
        output_bicycle=m["model_output_bicycle"],
        map_bounds=tuple(m["map_obs_bounds"]),
        conv_kernels=tuple(m["conv_kernel_list"]),
        conv_strides=tuple(m["conv_stride_list"]),
        conv_filters=tuple(m["conv_filter_list"]),
        num_memory_layers=m["num_memory_layers"],
        map_channels=m["map_channels"], device=device)
    model.load_state_dict(weights, strict=True)
    return model


def reference_model(cfg, weights, device, precision="float32"):
    from .reference.model import Model

    r, dx = raster(cfg["store"], device)
    return Model(cfg["model"], dict(weights), r, dx, precision)


class CropPoses:
    """While open, keeps the unnormalized (N, 4) poses of every map crop
    the program's model asks for, in order (the tensors themselves: no
    copy, no kernel)."""

    def __init__(self):
        self.poses = []

    def __enter__(self):
        from strive_tpu_torch.model import traffic_model

        self._mod, self._orig = traffic_model, traffic_model.get_map_crop
        poses = self.poses

        def recorded(packed, dx, pos, *a, **k):
            poses.append(pos)
            return self._orig(packed, dx, pos, *a, **k)

        traffic_model.get_map_crop = recorded
        return self

    def __exit__(self, *exc):
        self._mod.get_map_crop = self._orig


def pose_gap_m(own, want):
    """Largest distance (m, per axis) between a rollout's own crop poses
    and the poses another run cropped at: two lists of (N, 4)."""
    return max((float((a[:, :2].cpu() - b[:, :2].cpu()).abs().max())
                for a, b in zip(own, want)), default=0.0)


def rel_gap(a, b):
    """The largest |a - b| / |b| over two matching sequences (0 where
    both are 0)."""
    return max((abs(x - y) / abs(y) if y else
                (0.0 if x == y else float("inf"))
                for x, y in zip(a, b)), default=0.0)


def free_cuda():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
