"""Pieces shared by the port's entry points."""

from __future__ import annotations

from ..model.traffic_model import NormConfig, TrafficModel
from ..maps.store import num_channels


def build_model(cfg, state_norm, att_norm, nc, device):
    """The traffic model a config describes (``scripts/train_traffic.py:45-58``),
    on ``device``. ``--bf16`` raises (queue 1b)."""
    if getattr(cfg, "bf16", False):
        raise NotImplementedError("--bf16 is not ported yet (ROADMAP queue 1b)")
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
        map_channels=num_channels(cfg.map_layers), device=device,
    )
