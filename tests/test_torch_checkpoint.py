"""Checkpoints in the port's pipeline, and the initial weights' distribution.

- ``adv_scenario_gen --ckpt``: strive_tpu's initial weights for
  ``configs/adv_gen_synthetic.cfg`` (``init_model_params(PRNGKey(0))`` on
  the val split's first batch), converted, written by the port's
  ``save_state``, and read back through ``--ckpt``, give the pipeline the
  same stats, folders and scene JSONs, exactly, as the same weights passed
  in memory (``init_params``); a missing checkpoint raises, and so does a
  directory without the port's ``torch_state.pt`` (strive_tpu's orbax store
  at ``out/train_synth_prod/checkpoints/latest_model``, the path
  ``configs/test_synth_prod.cfg`` names).
- ``init_model_params``: every leaf of the port's tiny model (the model of
  tests/helpers.py), by name, against strive_tpu's Flax init of the same
  model. Biases are 0 and norm scales 1 exactly; each weight's mean and
  standard deviation agree with strive_tpu's within 6 standard errors of
  two independent samples (sigma * sqrt(2 / n) for the mean, sigma *
  sqrt(1 / n) for the std, sigma = the LeCun std 1 / sqrt(fan_in)); no
  draw lies beyond the truncation at 2 / 0.8796 sigma; the draws are the
  same on every call (a CPU generator seeded 0).
"""

import json
import math
import os

import numpy as np
import jax
import pytest
import torch

from helpers import make_scene, tiny_model, tiny_store
from torch_helpers import port_model

from strive_tpu.model.traffic_model import init_model_params as j_init
from strive_tpu_torch.model.traffic_model import init_model_params
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.utils.checkpoint import load_state, save_state
from strive_tpu_torch.utils.convert import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "adv_gen_synthetic.cfg")
SMALL = ["--num_iters", "1", "--num_samples", "2", "--synth_scenes", "3",
         "--max_scenes", "3"]


def _jax_weights_for(cfg_path):
    """strive_tpu's initial weights for a config's model, as a state dict."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from train_traffic import build_model as j_build  # noqa: E402
    from strive_tpu.data.loading import load_environment as j_load
    from strive_tpu.normalize import effective_categories

    cfg = tgen.parse_cfg(["-c", cfg_path] + SMALL)
    ds, store, _, sn, an = j_load(cfg, cfg.split)
    nc = len(effective_categories(cfg.agent_types, cfg.reduce_cats))
    model = j_build(cfg, sn, an, nc)
    params = j_init(model, ds.get_batch([0]), store, jax.random.PRNGKey(0))
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _outputs(out):
    res = {}
    root = os.path.join(out, "scenario_results")
    for d in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        for name in sorted(os.listdir(os.path.join(root, d))):
            with open(os.path.join(root, d, name)) as f:
                res[(d, name)] = json.load(f)
    return res


def test_adv_scenario_gen_reads_the_port_checkpoint(tmp_path, monkeypatch):
    weights = _jax_weights_for(CFG)
    ckpt = save_state(str(tmp_path), "latest_model", weights, None, 3, 1.5)
    monkeypatch.setattr(tgen, "init_params",
                        lambda model: model.load_state_dict(weights))
    want = tgen.main(["-c", CFG, "--out", str(tmp_path / "mem"),
                      "--device", "cpu"] + SMALL)
    monkeypatch.undo()
    got = tgen.main(["-c", CFG, "--out", str(tmp_path / "ckpt"),
                     "--device", "cpu", "--ckpt", ckpt] + SMALL)
    assert got == want and want["candidates"] == 3
    assert _outputs(str(tmp_path / "ckpt")) == _outputs(str(tmp_path / "mem"))
    with open(tmp_path / "ckpt" / "adv_gen_log.txt") as f:
        assert f"Loaded checkpoint {ckpt}" in f.read()
    with pytest.raises(FileNotFoundError):
        tgen.main(["-c", CFG, "--out", str(tmp_path / "x"), "--device",
                   "cpu", "--ckpt", str(tmp_path / "missing")] + SMALL)
    assert os.path.isfile(os.path.join(ckpt, "torch_state.pt"))
    # strive_tpu's orbax store at the path the configs name is refused
    orbax = os.path.join(REPO, "out", "train_synth_prod", "checkpoints",
                         "latest_model")
    for path in (str(tmp_path), orbax):
        with pytest.raises(ValueError, match="orbax"):
            load_state(path)


def test_init_matches_flax_distribution():
    rng = np.random.default_rng(0)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=6)
    jm = tiny_model(FT=6, PT=4)
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, j_init(jm, scene, tiny_store(), jax.random.PRNGKey(0))))
    tm = port_model(jm, jax.tree_util.tree_map(np.asarray, j_init(
        jm, scene, tiny_store(), jax.random.PRNGKey(1))), 3)
    init_model_params(tm, seed=0)
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        a, b = p.detach().numpy().astype(np.float64), \
            want[name].numpy().astype(np.float64)
        if name.endswith("bias") or (".ln" in name or ".gn" in name):
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        sigma = 1.0 / math.sqrt(a[0].size)
        n = a.size
        assert abs(a.mean() - b.mean()) <= 6 * sigma * math.sqrt(2 / n), name
        assert abs(a.std() - b.std()) <= 6 * sigma * math.sqrt(1 / n), name
        assert np.abs(a).max() <= 2 / .87962566103423978 * sigma * (1 + 1e-6)
    again = {k: v.clone() for k, v in got.items()}
    init_model_params(tm, seed=0)
    for k, v in tm.named_parameters():
        assert torch.equal(v, again[k]), k
