"""Matplotlib scene visualization (host-side).

Equivalent of reference ``datasets/nuscenes_utils.py:430-854``
(viz_scene_graph / viz_map_crop / create_video): renders the local map
crop, agent boxes, and trajectories; optional mp4 via ffmpeg when present.
Not performance-critical — runs on the host from numpy copies.

Copy of ``strive_tpu/viz.py``: the same figures, pixel for pixel. The map
store's tensors may lie on the card: only the rendered window of the
raster is copied to the host. matplotlib is imported inside the drawing
functions, so the package imports without it.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess

import numpy as np
import torch

from .losses.metrics import box_corners

def have_matplotlib():
    """Whether matplotlib can be imported (checked without importing it)."""
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    """matplotlib's pyplot on the Agg backend (no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    """A numpy copy of a tensor (on any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# channel palette for multi-layer map rendering (reference
# ``nuscenes_utils.py:717-731`` render_map_observation: drivable/carpark/
# road_divider/lane_divider/walkway/ped_crossing)
MAP_COLOR_LIST = ["darkgray", "coral", "orange", "gold", "lightblue",
                  "lightblue"]
MAP_ALPHA_LIST = [1.0, 0.6, 0.6, 0.6, 1.0, 0.5]


def _render_map_layers(ax, crop, extent):
    """Overlay every raster channel with its reference color
    (``nuscenes_utils.py:704-731``): one RGBA image per channel, alpha =
    occupancy * layer alpha, drawn over a white background."""
    import matplotlib.colors as mcolors

    h, w = crop.shape[-2:]
    ax.imshow(np.ones((h, w, 3)), origin="lower", extent=extent, zorder=0)
    for i in range(crop.shape[0]):
        c = mcolors.to_rgba(MAP_COLOR_LIST[i % len(MAP_COLOR_LIST)])[:3]
        a = MAP_ALPHA_LIST[i % len(MAP_ALPHA_LIST)]
        occ = (np.asarray(crop[i], dtype=np.float32) > 0).astype(np.float32)
        rgba = np.empty((h, w, 4), dtype=np.float32)
        rgba[..., 0], rgba[..., 1], rgba[..., 2] = c
        rgba[..., 3] = occ * a
        ax.imshow(rgba, origin="lower", extent=extent, zorder=0)


def get_adv_coloring(na, attack_agt, planner_idx=0):
    """Reference ``nuscenes_utils.py:434-475``: planner green, attacker red,
    everyone else default."""
    colors = [None] * na
    if planner_idx is not None:
        colors[planner_idx] = "green"
    if attack_agt is not None and 0 <= int(attack_agt) < na:
        colors[int(attack_agt)] = "red"
    return colors


def _draw_car(ax, state, lw, color, alpha=0.7):
    corners = box_corners(np.asarray(state)[None], np.asarray(lw)[None])[0]
    ax.fill(corners[:, 0], corners[:, 1], color=color, edgecolor="k",
            alpha=alpha, zorder=3, linewidth=1.0)
    h = np.arctan2(state[3], state[2])
    ax.plot([state[0], state[0] + lw[0] / 2 * np.cos(h)],
            [state[1], state[1] + lw[0] / 2 * np.sin(h)], "b", alpha=0.5)


def render_scene(out_path, map_store, map_idx, past, future_pred, lw, mask,
                 gt_future=None, car_colors=None, viz_bounds=(-60, -60, 60, 60),
                 center_idx=0, title=None):
    """Render ONE scene to a png.

    :param past: (NA, PT, 6) UNNORMALIZED
    :param future_pred: UNNORMALIZED future(s) or None — (NA, FT, 4) for a
        single trajectory set (rainbow time markers), or (NS, NA, FT, 4) to
        overlay ALL NS samples with one color per sample (reference
        ``viz_scene_graph`` overlays every sampled future,
        ``nuscenes_utils.py:477-621`` via ``test_traffic.py:181-193``)
    :param lw: (NA, 2) UNNORMALIZED
    :param mask: (NA,) bool
    """
    plt = _pyplot()
    past = _np(past)
    mask = _np(mask)
    n = int(mask.sum())
    center = past[center_idx, -1, :2]

    fig, ax = plt.subplots(figsize=(8, 8))
    raster = map_store.raster[int(map_idx)]  # (C, H, W), on its device
    dx = _np(map_store.dx[int(map_idx)])
    x0, y0 = center + np.array(viz_bounds[:2])
    x1, y1 = center + np.array(viz_bounds[2:])
    px0, py0 = max(int(x0 / dx[0]), 0), max(int(y0 / dx[1]), 0)
    px1 = min(int(x1 / dx[0]), raster.shape[2])
    py1 = min(int(y1 / dx[1]), raster.shape[1])
    if px1 > px0 and py1 > py0:
        crop = _np(raster[:, py0:py1, px0:px1])
        _render_map_layers(
            ax, crop,
            (px0 * dx[0], px1 * dx[0], py0 * dx[1], py1 * dx[1]))

    cmap = plt.get_cmap("rainbow")
    fp_all = None if future_pred is None else _np(future_pred)
    multi = fp_all is not None and fp_all.ndim == 4
    NS = fp_all.shape[0] if multi else 1
    samp_cmap = plt.get_cmap("turbo")
    for a in range(n):
        color = None
        if car_colors is not None:
            color = car_colors[a]
        _draw_car(ax, past[a, -1, :4], _np(lw)[a],
                  color or ("green" if a == center_idx else "cornflowerblue"))
        ax.plot(past[a, :, 0], past[a, :, 1], ".-", color="gray", alpha=0.6)
        if fp_all is not None:
            if multi:
                # overlay every sample, one color per sample
                for s in range(NS):
                    fp = fp_all[s, a]
                    ax.plot(fp[:, 0], fp[:, 1], ".-",
                            color=samp_cmap(s / max(NS - 1, 1)),
                            markersize=4, linewidth=1.0, alpha=0.6)
            else:
                fp = fp_all[a]
                for t in range(fp.shape[0]):
                    ax.plot(fp[t, 0], fp[t, 1], ".",
                            color=cmap(t / max(fp.shape[0] - 1, 1)),
                            markersize=5)
        if gt_future is not None:
            gf = _np(gt_future)[a]
            ax.plot(gf[:, 0], gf[:, 1], "--", color="k", alpha=0.4)

    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def render_rollout_video(out_path, map_store, map_idx, past, future_pred, lw,
                         mask, fps=2, **kw):
    """Per-step frames + ffmpeg mp4 (reference ``create_video`` :623-630).
    Falls back to keeping the frames if ffmpeg is unavailable."""
    frame_dir = out_path + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    future_pred = _np(future_pred)
    FT = future_pred.shape[1]
    for t in range(FT):
        render_scene(os.path.join(frame_dir, "%04d.jpg" % t), map_store,
                     map_idx, past, future_pred[:, t : t + 1],
                     lw, mask, **kw)
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-r", str(fps), "-i",
             os.path.join(frame_dir, "%04d.jpg"), "-vcodec", "libx264",
             "-pix_fmt", "yuv420p", out_path + ".mp4"],
            check=False, capture_output=True,
        )
        shutil.rmtree(frame_dir, ignore_errors=True)
        return out_path + ".mp4"
    return frame_dir
