"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

The same numpy-seeded inputs go through strive_tpu (JAX, on the CPU) and
strive_tpu_torch (on the CPU, where every kernel wrapper takes its plain
version); arrays cross between the two as numpy.
"""

import re

import numpy as np
import jax
import torch

from strive_tpu_torch.model import traffic_model as ttm
from strive_tpu_torch.scene import SceneBatch
from strive_tpu_torch.utils.convert import params_from_flax

# tier-1 runs several pytest workers; keep each to a couple of threads
torch.set_num_threads(2)

# a gathered sample may differ from the JAX package only this close (in
# pixels) to a rounding tie: the crop grid's float32 offsets can differ by
# an ulp (XLA rewrites jnp.linspace), which moves round() only at .5 ties
TIE_BAND_PX = 1e-3


def t(x, dtype=None):
    """JAX / numpy array -> CPU tensor (int -> int64)."""
    a = np.array(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """Tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene_to_torch(scene):
    return SceneBatch(**{k: (None if getattr(scene, k) is None
                             else t(getattr(scene, k)))
                         for k in SceneBatch.__dataclass_fields__})


def port_model(jax_model, params, map_channels):
    """The port's TrafficModel with the Flax model's config, options and
    weights."""
    m = ttm.TrafficModel(
        jax_model.npast, jax_model.nfuture, jax_model.map_obs_size_pix,
        jax_model.nclasses, ttm.NormConfig(*jax_model.norm),
        output_bicycle=jax_model.output_bicycle,
        traj_encoder=jax_model.traj_encoder,
        map_bounds=jax_model.map_bounds, conv_kernels=jax_model.conv_kernels,
        conv_strides=jax_model.conv_strides,
        conv_filters=jax_model.conv_filters,
        compute_dtype=jax_model.compute_dtype,
        map_refresh_every=jax_model.map_refresh_every,
        map_channels=map_channels, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return m


def tie_distance(xys, dx_per_sample):
    """Distance in pixels of each sample's x or y coordinate to the nearest
    rounding tie: (..., 2) world coords, (..., 2) meters per pixel."""
    p = n(xys).astype(np.float64) / n(dx_per_sample).astype(np.float64)
    return np.abs(np.abs(p - np.floor(p)) - 0.5).min(axis=-1)


def assert_gather_parity(got, want, xys, dx_per_sample):
    """Per-sample gathered values agree except within TIE_BAND_PX of a
    rounding tie. :return: the number of samples that differ."""
    diff = n(got) != n(want)
    if diff.any():
        near = tie_distance(xys, dx_per_sample)[diff]
        assert (near < TIE_BAND_PX).all(), (
            f"{int(diff.sum())} samples differ, "
            f"{int((near >= TIE_BAND_PX).sum())} away from any rounding tie")
    return int(diff.sum())


def _reference_name(name):
    """The reference's name of a port parameter (the converter's inverse)."""
    m = re.fullmatch(r"map_encoder\.conv(\d+)\.(\w+)", name)
    if m:
        return f"map_conv.{3 * int(m[1])}.{m[2]}"
    m = re.fullmatch(r"map_encoder\.gn(\d+)\.(\w+)", name)
    if m:
        return f"map_conv.{3 * int(m[1]) + 1}.{m[2]}"
    if name.startswith("map_encoder.out."):
        return "map_feature." + name.split(".")[-1]
    m = re.fullmatch(r"(decoder_memory|past|future)(?:_gru)?\.layer(\d+)"
                     r"\.(ih|hh)\.(\w+)", name)
    if m:
        gru = m[1] if m[1] == "decoder_memory" else f"{m[1]}_encoder"
        return f"{gru}.{m[4]}_{m[3]}_l{m[2]}"
    m = re.fullmatch(r"(past|future)_out\.(\w+)", name)
    if m:
        return f"{m[1]}_out_layer.{m[2]}"
    name = name.replace(".conv0.", ".msg.0.")
    m = re.fullmatch(r"(.*)\.(fc|ln)(\d+)\.(\w+)", name)
    i = int(m[3])
    idx = 0 if i == 0 else (3 * i - 2 if m[2] == "ln" else 3 * i)
    return f"{m[1]}.net.{idx}.{m[4]}"


def reference_state_dict(port, seed=0):
    """Seeded values under the reference's names, in its shapes (the port's
    shapes: Linear (out, in), Conv2d OIHW, the flatten Linear's columns in
    another order of the same width)."""
    rng = np.random.default_rng(seed)
    return {_reference_name(k): torch.from_numpy(
                rng.normal(size=tuple(v.shape)).astype(np.float32))
            for k, v in port.state_dict().items()}
