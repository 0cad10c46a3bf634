"""Pieces shared by the port's entry points."""

from __future__ import annotations

import os
import subprocess

import torch

from ..maps.store import num_channels
from ..model.traffic_model import NormConfig, TrafficModel, init_model_params
from ..utils.checkpoint import load_state


def build_model(cfg, state_norm, att_norm, nc, device):
    """The traffic model a config describes (``scripts/train_traffic.py:45-58``),
    on ``device``: ``--bf16`` computes in bfloat16, ``--no_output_bicycle``
    has the decoder emit poses directly."""
    norm = NormConfig.from_normalizers(state_norm, att_norm)
    return TrafficModel(
        npast=cfg.past_len, nfuture=cfg.future_len,
        map_obs_size_pix=cfg.map_obs_size_pix, nclasses=nc, norm=norm,
        map_feat_size=cfg.map_feat_size, past_feat_size=cfg.past_feat_size,
        future_feat_size=cfg.future_feat_size, latent_size=cfg.latent_size,
        output_bicycle=cfg.model_output_bicycle,
        map_bounds=tuple(cfg.map_obs_bounds),
        conv_kernels=tuple(cfg.conv_kernel_list),
        conv_strides=tuple(cfg.conv_stride_list),
        conv_filters=tuple(cfg.conv_filter_list),
        compute_dtype="bfloat16" if getattr(cfg, "bf16", False) else None,
        map_channels=num_channels(cfg.map_layers), device=device,
    )


def resolve_device(name):
    """``--device`` as a torch device; 'cuda' without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    return dev


def sync(device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device):
    """What ran: "cpu", or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them (the name alone without
    nvidia-smi)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        index = visible.split(",")[index]
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(dev)


def init_params(model):
    """The model's initial weights, in place: Flax's distributions drawn
    from a CPU generator seeded 0 (``init_model_params``), so the card and
    the CPU start from the same numbers."""
    init_model_params(model, seed=0)


def prior_noise(generator, shape):
    """Standard-normal prior noise of ``shape``, drawn on the CPU from
    ``generator``, so the card and the CPU sample the same latents."""
    return torch.randn(shape, generator=generator)


def load_checkpoint(model, path):
    """Load a checkpoint written by the port's ``train_traffic`` into
    ``model``; :return: (opt_state or None, epoch, min_val_loss)."""
    params, opt_state, epoch, min_val_loss = load_state(path)
    model.load_state_dict(params)
    return opt_state, epoch, min_val_loss

