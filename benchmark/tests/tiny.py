"""Tiny versions of the benchmark's configurations, for runs on the CPU.

The cells' own files at a size a test can hold: a 64 px crop through
three small convolutions, 2 scenes of 4 agents, a coarse raster of the
same four maps, 3 Adam iterations a batch.
"""

from __future__ import annotations

import copy

import torch

from benchmark.harness import BENCH, Run, load_json

torch.set_num_threads(2)


def config(name):
    cfg = copy.deepcopy(load_json(BENCH / "configs" / f"{name}.json"))
    m = cfg["model"]
    m.update(map_obs_size_pix=64, conv_kernel_list=[5, 3, 3],
             conv_stride_list=[2, 2, 2], conv_filter_list=[4, 4, 4])
    cfg["store"]["pix_per_m"] = 0.5
    cfg["batch_size"], cfg["max_agents"] = 2, 4
    if "num_iters" in cfg["optim"]:
        cfg["optim"]["num_iters"] = 3
    return cfg


def traffic(name):
    tr = copy.deepcopy(load_json(BENCH / "traffic" / f"{name}.json"))
    if "pool_batches" in tr:
        tr["pool_batches"] = 3
    if "pool_scenes" in tr:
        tr["pool_scenes"] = 8
    return tr


def run(config_name, traffic_name, seed=2 ** 31 + 5, seconds=0.0):
    return Run(traffic_name, config(config_name), traffic(traffic_name),
               seed, seconds, False, torch.device("cpu"))
