"""The port's rendering against strive_tpu's, pixel for pixel (CPU).

The same scene goes through ``strive_tpu.viz`` (a JAX map store) and
``strive_tpu_torch.viz`` (the same store as CPU tensors); each image is
read back with ``matplotlib.pyplot.imread`` and must be equal:
``render_scene`` (one trajectory set, every sample overlaid, adversarial
colours with a partial mask, the ground truth and a title, a window that
runs off the map), the frames of ``render_rollout_video``, and
``viz_scenario_dir`` on the tracked scenario JSONs.
"""

import glob
import importlib.util
import os

import numpy as np
import jax  # noqa: F401  (JAX on the CPU before torch's threads start)
import pytest
import torch

plt = pytest.importorskip("matplotlib.pyplot")

from strive_tpu import viz as jviz  # noqa: E402
from strive_tpu.maps.store import synthetic_map_store as j_store  # noqa: E402
from strive_tpu_torch import viz as tviz  # noqa: E402
from strive_tpu_torch.maps.store import MapStore  # noqa: E402
from strive_tpu_torch.scripts import viz_scenario_dir as tvsd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN = os.path.join(REPO, "out/adv_gen_synth_hc_prod/scenario_results/"
                          "adv_sol_success")


@pytest.fixture(scope="module")
def stores():
    js = j_store(num_maps=2, size_px=256, channels=4, pix_per_m=4.0)
    ts = MapStore.from_raster(torch.from_numpy(np.array(js.raster)),
                              torch.from_numpy(np.array(js.dx)),
                              js.map_names)
    return js, ts


def _scene(seed, na=4, pt=4, ft=6, ns=None):
    rng = np.random.default_rng(seed)
    past = np.zeros((na, pt, 6))
    past[:, :, 0] = rng.uniform(20, 40, (na, 1)) + np.arange(pt)
    past[:, :, 1] = rng.uniform(20, 40, (na, 1))
    h = rng.uniform(-np.pi, np.pi, (na, 1))
    past[:, :, 2], past[:, :, 3] = np.cos(h), np.sin(h)
    shape = (na, ft, 4) if ns is None else (ns, na, ft, 4)
    fut = np.zeros(shape)
    fut[..., 0] = past[:, -1:, 0] + np.cumsum(rng.uniform(0.5, 2, shape[:-1]),
                                              axis=-1)
    fut[..., 1] = past[:, -1:, 1] + rng.normal(0, 0.5, shape[:-1])
    fut[..., 2] = 1.0
    lw = rng.uniform(1.5, 5, (na, 2))
    return past, fut, lw


def _same_image(a, b):
    np.testing.assert_array_equal(plt.imread(a), plt.imread(b))


CASES = ["single", "samples", "adv_partial", "gt_title", "off_map"]


@pytest.mark.parametrize("case", CASES)
def test_render_scene_same_pixels(stores, tmp_path, case):
    js, ts = stores
    ns = 3 if case == "samples" else None
    past, fut, lw = _scene(CASES.index(case), ns=ns)
    mask = np.ones(4, bool)
    kw = {}
    if case == "adv_partial":
        mask[3] = False
        kw["car_colors"] = jviz.get_adv_coloring(4, 2, 0)
        assert kw["car_colors"] == tviz.get_adv_coloring(4, 2, 0)
    if case == "gt_title":
        kw.update(gt_future=fut + 0.5, title="a title")
    if case == "off_map":
        past[:, :, :2] += 40.0
        kw["viz_bounds"] = (-30, -20, 30, 20)
    a = jviz.render_scene(str(tmp_path / "j.png"), js, 1, past, fut, lw,
                          mask, **kw)
    # the port's from tensors, as its entry points pass them
    b = tviz.render_scene(str(tmp_path / "t.png"), ts, 1,
                          torch.from_numpy(past), torch.from_numpy(fut), lw,
                          torch.from_numpy(mask), **kw)
    _same_image(a, b)
    assert tviz.MAP_COLOR_LIST == jviz.MAP_COLOR_LIST


def test_rollout_video_frames_same_pixels(stores, tmp_path, monkeypatch):
    js, ts = stores
    for mod in (jviz, tviz):  # keep the frames: compare them, not an mp4
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    past, fut, lw = _scene(5, ft=4)
    mask = np.ones(4, bool)
    a = jviz.render_rollout_video(str(tmp_path / "j"), js, 0, past, fut, lw,
                                  mask)
    b = tviz.render_rollout_video(str(tmp_path / "t"), ts, 0, past, fut, lw,
                                  mask)
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb == ["%04d.jpg" % t for t in range(4)]
    for f in fa:
        _same_image(os.path.join(a, f), os.path.join(b, f))


def test_viz_scenario_dir_same_pixels(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "_strive_scripts_viz_scenario_dir",
        os.path.join(REPO, "scripts", "viz_scenario_dir.py"))
    jvsd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jvsd)
    argv = ["-c", "/dev/null", "--scenario_dir", SCEN, "--data_version",
            "synthetic", "--max_agents", "16"]
    jvsd.main(argv + ["--out", str(tmp_path / "j")])
    out = tvsd.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    (jd,) = glob.glob(str(tmp_path / "j") + "_*")
    imgs = sorted(f for f in os.listdir(out) if f.endswith(".jpg"))
    assert imgs == sorted(f for f in os.listdir(jd) if f.endswith(".jpg"))
    assert len(imgs) == len(glob.glob(os.path.join(SCEN, "*.json"))) > 0
    for f in imgs:
        _same_image(os.path.join(out, f), os.path.join(jd, f))
