"""Convert strive_tpu's Flax parameters, and reference STRIVE PyTorch
checkpoints, into the port's state dict.

The port names every module as the Flax tree does, so the conversion is by
name: a Flax leaf ``a/b/kernel`` becomes ``a.b.weight`` and so on.

- Dense kernel (in, out) -> Linear weight (out, in)
- Conv kernel HWIO -> Conv2d weight OIHW
- LayerNorm / GroupNorm ``scale`` -> ``weight``; every ``bias`` -> ``bias``
- GRU ``ih``/``hh`` Dense layers map like any Dense (gate order r, z, n is
  the same on both sides); the 'gru' trajectory encoders' ``past_gru``,
  ``past_out``, ``future_gru`` and ``future_out`` are named as in Flax
- the MapEncoder's final Dense keeps its rows: the port flattens the last
  conv activation in NHWC order, as Flax does (``model/cnn.py``)

A reference state dict (``models/traffic_model.py``) goes through the
Flax tree of ``strive_tpu/utils/convert.py:101``
(:func:`convert_traffic_model_state_dict`, numpy here) and then the
above: its MLP ``net.<i>`` indices become ``fc<k>``/``ln<k>``, torch's
``nn.GRU`` weights split into per-layer ``ih``/``hh``, and the flatten
Linear's input rows go from torch's CHW order to the NHWC order the port
flattens in.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(name, value):
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {a.ndim}")
    if name == "scale":
        return "weight", a
    if name == "bias":
        return "bias", a
    raise ValueError(f"unexpected parameter {name}")


def params_from_flax(tree):
    """Flax params (nested dict of numpy arrays, with or without the outer
    ``'params'`` key) -> {torch name: float32 tensor} for ``load_state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, prefix + (key,))
            else:
                name, arr = _leaf(key, val)
                out[".".join(prefix + (name,))] = torch.from_numpy(
                    np.array(arr, copy=True, order="C"))

    walk(tree, ())
    return out


# ---- reference STRIVE state dict -> Flax tree (strive_tpu/utils/convert.py)

def _lin(sd, name):
    return {"kernel": np.ascontiguousarray(sd[name + ".weight"].T),
            "bias": np.asarray(sd[name + ".bias"])}


def _ln(sd, name):
    return {"scale": np.asarray(sd[name + ".weight"]),
            "bias": np.asarray(sd[name + ".bias"])}


def _conv(sd, name):
    w = np.asarray(sd[name + ".weight"])  # (O, I, kH, kW)
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": np.asarray(sd[name + ".bias"])}


def convert_mlp(sd, prefix, widths):
    """Reference MLP ``net`` ModuleList [L, LN, act, L, LN, act, L, ...] ->
    ``fc{i}``/``ln{i}``: linear i >= 1 at module index 3i - 2 + 2.

    :param widths: number of Linear layers
    """
    out = {"fc0": _lin(sd, f"{prefix}.net.0")}
    for i in range(1, widths):
        mod_idx = 3 * i - 2
        out[f"ln{i}"] = _ln(sd, f"{prefix}.net.{mod_idx}")
        out[f"fc{i}"] = _lin(sd, f"{prefix}.net.{mod_idx + 2}")
    return out


def convert_interaction_net(sd, prefix):
    """SceneInteractionNet: mlp_in, conv0 edge/update, mlp_out."""
    return {
        "mlp_in": convert_mlp(sd, f"{prefix}.mlp_in", 3),
        "conv0": {
            "edge_mlp": convert_mlp(sd, f"{prefix}.msg.0.edge_mlp", 3),
            "update_mlp": convert_mlp(sd, f"{prefix}.msg.0.update_mlp", 2),
        },
        "mlp_out": convert_mlp(sd, f"{prefix}.mlp_out", 3),
    }


def convert_gru(sd, prefix, num_layers):
    """torch nn.GRU -> StackedGRU layer{k}/{ih,hh}."""
    out = {}
    for k in range(num_layers):
        out[f"layer{k}"] = {
            "ih": {"kernel": np.ascontiguousarray(
                       np.asarray(sd[f"{prefix}.weight_ih_l{k}"]).T),
                   "bias": np.asarray(sd[f"{prefix}.bias_ih_l{k}"])},
            "hh": {"kernel": np.ascontiguousarray(
                       np.asarray(sd[f"{prefix}.weight_hh_l{k}"]).T),
                   "bias": np.asarray(sd[f"{prefix}.bias_hh_l{k}"])},
        }
    return out


def chw_to_hwc_perm(C, H, W):
    """Permutation p with hwc_in[i] = chw_in[p[i]] for the flatten dim."""
    return np.arange(C * H * W).reshape(C, H, W).transpose(1, 2, 0).reshape(-1)


def convert_map_encoder(sd, n_convs, final_hw, final_c):
    out = {}
    for i in range(n_convs):
        out[f"conv{i}"] = _conv(sd, f"map_conv.{3 * i}")
        out[f"gn{i}"] = _ln(sd, f"map_conv.{3 * i + 1}")
    lin = _lin(sd, "map_feature")
    perm = chw_to_hwc_perm(final_c, final_hw, final_hw)
    lin["kernel"] = np.ascontiguousarray(lin["kernel"][perm])
    out["out"] = lin
    return out


def convert_traffic_model_state_dict(sd, model):
    """Reference TrafficModel state dict -> the port's state dict.

    :param sd: {reference name: torch tensor or numpy array}
    :param model: the port's ``TrafficModel`` (for its conv geometry, GRU
        depth and trajectory encoder)
    :return: {port name: float32 tensor} for ``model.load_state_dict``
    """
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in sd.items()}
    enc = model.map_encoder
    hw = model.map_obs_size_pix
    for i in range(enc.n):
        conv = getattr(enc, f"conv{i}")
        hw = (hw - conv.kernel_size[0]) // conv.stride[0] + 1
    final_c = getattr(enc, f"conv{enc.n - 1}").out_channels
    tree = {
        "map_encoder": convert_map_encoder(sd, enc.n, hw, final_c),
        "prior_net": convert_interaction_net(sd, "prior_net"),
        "posterior_net": convert_interaction_net(sd, "posterior_net"),
        "decoder_net": convert_interaction_net(sd, "decoder_net"),
        "decoder_memory": convert_gru(sd, "decoder_memory",
                                      model.num_memory_layers),
    }
    if model.traj_encoder == "mlp":
        tree["past_encoder"] = convert_mlp(sd, "past_encoder", 4)
        tree["future_encoder"] = convert_mlp(sd, "future_encoder", 4)
    else:  # reference nn.GRU(num_layers=4) encoders and their out layers
        tree["past_gru"] = convert_gru(sd, "past_encoder", 4)
        tree["past_out"] = _lin(sd, "past_out_layer")
        tree["future_gru"] = convert_gru(sd, "future_encoder", 4)
        tree["future_out"] = _lin(sd, "future_out_layer")
    return params_from_flax(tree)
