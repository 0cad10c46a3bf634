"""Render saved scenario JSONs to images/video, on PyTorch.

    python -m strive_tpu_torch.scripts.viz_scenario_dir -c CFG --scenario_dir DIR
    python -m strive_tpu_torch.scripts.viz_scenario_dir -c CFG --scenario_dir DIR --device cpu

Port of ``scripts/viz_scenario_dir.py`` (reference ``viz_scenario_dir.py``)
with the same flags and outputs: one ``<name>.jpg`` a scenario, and with
``--video`` its per-step frames (an mp4 where ffmpeg is present), under
``<out>_<unix time>``. The map store is loaded on ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``); the drawing
needs matplotlib.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..data.loading import load_environment
from ..data.scenario_json import read_adv_scenes
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from ..viz import get_adv_coloring, render_rollout_video, render_scene
from .common import resolve_device


def parse_cfg(argv=None):
    parser = get_parser("Visualize a directory of scenarios (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--scenario_dir", type=str, required=True)
    parser.add_argument("--video", action="store_true", default=False)
    parser.add_argument("--synth_scenes", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser.parse(argv)


def main(argv=None):
    """Render; returns the output directory."""
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    cfg.out = cfg.out + "_" + str(int(time.time()))
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "viz_log.txt"))

    _, store, _, _, _ = load_environment(cfg, "val", device=device)
    scenes = read_adv_scenes(cfg.scenario_dir)
    Logger.log(f"Rendering {len(scenes)} scenarios to {cfg.out}")
    for sc in scenes:
        map_idx = store.map_names.index(sc["map"]) if sc["map"] in \
            store.map_names else 0
        NA = sc["scene_past"].shape[0]
        mask = np.ones(NA, bool)
        colors = get_adv_coloring(NA, sc.get("attack_agt"), 0)
        render_scene(
            os.path.join(cfg.out, sc["name"] + ".jpg"), store, map_idx,
            sc["scene_past"], sc["scene_fut"][:, :, :4], sc["veh_att"], mask,
            car_colors=colors, title=sc["name"],
        )
        if cfg.video:
            render_rollout_video(
                os.path.join(cfg.out, sc["name"]), store, map_idx,
                sc["scene_past"], sc["scene_fut"][:, :, :4], sc["veh_att"],
                mask, car_colors=colors,
            )
    return cfg.out


if __name__ == "__main__":
    main()
