"""The reference-checkpoint converter of the port against strive_tpu's.

A state dict with the reference STRIVE TrafficModel's key names and shapes
(``models/traffic_model.py``: ``map_conv.<i>``, ``map_feature``, MLP
``net.<i>``, ``msg.0``, torch ``nn.GRU`` weights) is made from seeded
numpy values; the port's ``convert_traffic_model_state_dict`` must give
exactly ``params_from_flax(strive_tpu's convert_traffic_model_state_dict)``.
Then ``convert_ref_ckpt`` writes a port checkpoint from a ``.pth`` of such
a state dict, and ``adv_scenario_gen --ckpt`` reads it on the CPU. The
'gru' trajectory encoders (reference ``past_encoder``/``future_encoder``
``nn.GRU`` of 4 layers, ``past_out_layer``, ``future_out_layer``) go
through both converters too.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from helpers import init_model
from torch_helpers import (n, port_model, reference_state_dict,
                           scene_to_torch)

from strive_tpu.model.traffic_model import init_model_params
from strive_tpu_torch.maps import synthetic_map_store as t_store

from strive_tpu.utils.convert import (
    convert_traffic_model_state_dict as j_convert)
from strive_tpu_torch.utils.checkpoint import load_state
from strive_tpu_torch.utils.convert import (convert_traffic_model_state_dict,
                                            params_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    """strive_tpu's tiny model and the port's of the same config."""
    model, params, _, _ = init_model()
    return model, port_model(model, params, 3)


@pytest.fixture(scope="module")
def gru_models():
    """The tiny model with the 'gru' trajectory encoders, both packages'
    (the port's from the Flax tree), and the scene it was made on."""
    model, _, scene, store = init_model()
    model = dataclasses.replace(model, traj_encoder="gru")
    params = init_model_params(model, scene, store, jax.random.PRNGKey(3))
    return model, params, port_model(model, params, 3), scene, store


def test_reference_names_cover_the_model(models):
    _, port = models
    sd = reference_state_dict(port)
    assert len(sd) == len(port.state_dict())
    assert {"map_conv.0.weight", "map_conv.1.weight", "map_feature.weight",
            "past_encoder.net.9.bias", "prior_net.msg.0.edge_mlp.net.4.weight",
            "decoder_memory.weight_hh_l2"} <= set(sd)


@pytest.mark.parametrize("seed", [0, 1])
def test_converter_matches_strive_tpu(models, seed):
    model, port = models
    sd = reference_state_dict(port, seed)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   j_convert(sd, model)))
    got = convert_traffic_model_state_dict(sd, port)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    # the flatten Linear's columns really moved (CHW -> HWC)
    assert not torch.equal(got["map_encoder.out.weight"],
                           sd["map_feature.weight"])
    port.load_state_dict(got)


def test_converted_checkpoint_loads_in_adv_scenario_gen(tmp_path):
    from strive_tpu_torch.normalize import (att_normalizer_for,
                                            state_normalizer_for)
    from strive_tpu_torch.scripts import adv_scenario_gen, convert_ref_ckpt
    from strive_tpu_torch.scripts.common import build_model

    cfg_path = os.path.join(REPO, "configs/adv_gen_synthetic.cfg")
    cfg = adv_scenario_gen.parse_cfg(["-c", cfg_path])
    model_flags = []  # the config's model widths, as flags
    for key in ("map_obs_size_pix", "map_obs_bounds", "conv_kernel_list",
                "conv_stride_list", "conv_filter_list", "future_len"):
        val = getattr(cfg, key)
        model_flags += [f"--{key}"] + [str(v) for v in (
            val if isinstance(val, list) else [val])]
    cats = tuple(sorted(cfg.agent_types))
    model = build_model(cfg, state_normalizer_for(cats),
                        att_normalizer_for(cats), len(cats), "cpu")
    sd = reference_state_dict(model, 3)
    pth = tmp_path / "traffic_model.pth"
    torch.save({"model": sd, "epoch": 7}, pth)
    out = tmp_path / "ckpt" / "traffic_model"
    path = convert_ref_ckpt.main(["--pth", str(pth), "--out", str(out),
                                  "--device", "cpu"] + model_flags)
    params, opt_state, epoch, _ = load_state(path)
    assert epoch == 7 and opt_state is None
    want = convert_traffic_model_state_dict(sd, model)
    for k in want:
        torch.testing.assert_close(params[k], want[k], rtol=0, atol=0)

    run = tmp_path / "adv"
    stats = adv_scenario_gen.main(["-c", cfg_path, "--ckpt", path, "--out",
                                   str(run), "--device", "cpu",
                                   "--num_iters", "1", "--max_scenes", "2"])
    assert stats["candidates"] == 2
    with open(run / "adv_gen_log.txt") as f:
        assert f"Loaded checkpoint {path}" in f.read()


def test_gru_encoder_flax_tree_loads_and_matches(gru_models):
    """The Flax tree's past_gru / past_out / future_gru / future_out load
    by name; the posterior-mean forward then agrees with strive_tpu's at
    tests/test_torch_model.py's tolerance (atol 1e-4)."""
    model, params, port, scene, store = gru_models
    assert {"past_gru", "past_out", "future_gru", "future_out"} <= set(
        params["params"])
    assert not hasattr(port, "past_encoder")
    want = jax.jit(lambda p: model.apply(
        p, scene, store, jax.random.PRNGKey(0), use_post_mean=True,
        method="forward"))(params)
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    with torch.no_grad():
        got = port(scene_to_torch(scene), ts, use_post_mean=True)
    for k in ("future_pred", "posterior_out", "prior_out"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]),
                        jax.tree_util.tree_leaves(want[k])):
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-4,
                                       err_msg=k)


def test_gru_encoder_state_dict_converts_as_strive_tpu(gru_models):
    model, _, port, _, _ = gru_models
    sd = reference_state_dict(port, 4)
    assert {"past_encoder.weight_ih_l3", "future_encoder.bias_hh_l0",
            "past_out_layer.weight", "future_out_layer.bias"} <= set(sd)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   j_convert(sd, model)))
    got = convert_traffic_model_state_dict(sd, port)
    assert sorted(got) == sorted(want) == sorted(port.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    port.load_state_dict(got)
