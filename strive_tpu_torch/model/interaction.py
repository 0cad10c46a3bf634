"""Dense masked scene interaction network.

Port of ``strive_tpu/model/interaction.py`` (reference
``models/interaction_net.py``): scenes are fully connected, so message
passing is a dense pairwise MLP over (B, NA, NA) with a masked max.

- message to node i from j: MLP([x_i, x_j, sem_i, sem_j, relpose(j in i)]),
  rel-pose NaN guard -> 0;
- aggregation: max over incoming messages; nodes with no neighbors get 0;
- update: MLP([x, aggr, sem]) with one hidden layer;
- wrapper: mlp_in -> k rounds -> mlp_out.

With a compute ``dtype`` (bf16) every MLP runs in it; the concatenations
of its features with the float32 poses and classes are float32, as
``jnp.concatenate`` promotes them (the next MLP casts back), the masked
max runs on the bf16 messages with bf16's lowest value, and the outputs of
``AgentInteractionConv`` and ``SceneInteractionNet`` are cast to float32
(``strive_tpu/model/interaction.py:51-89``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry import pairwise_transforms
from .common import MLP


class AgentInteractionConv(nn.Module):
    def __init__(self, in_dim: int, nc: int, out_channels: int,
                 hidden_size: int = 128, dtype=None):
        super().__init__()
        self.edge_mlp = MLP(2 * in_dim + 2 * nc + 4,
                            (hidden_size, hidden_size, out_channels), dtype)
        self.update_mlp = MLP(in_dim + out_channels + nc,
                              (hidden_size, out_channels), dtype)

    def forward(self, x, pos, sem, mask):
        """x (B, NA, D), pos (B, NA, 4), sem (B, NA, NC), mask (B, NA) bool."""
        B, NA, D = x.shape
        NC = sem.shape[-1]
        rel = pairwise_transforms(pos)
        rel = torch.where(torch.isnan(rel), 0.0, rel)
        x = x.float()  # bf16 features promote to float32 beside the poses
        msg_in = torch.cat([
            x[:, :, None, :].expand(B, NA, NA, D),
            x[:, None, :, :].expand(B, NA, NA, D),
            sem[:, :, None, :].expand(B, NA, NA, NC),
            sem[:, None, :, :].expand(B, NA, NA, NC),
            rel], dim=-1)
        msgs = self.edge_mlp(msg_in)  # (B, NA, NA, out), compute dtype

        eye = torch.eye(NA, dtype=torch.bool, device=x.device)
        pair_valid = mask[:, :, None] & mask[:, None, :] & ~eye[None]
        neg = torch.finfo(msgs.dtype).min
        masked = torch.where(pair_valid[..., None], msgs, neg)
        aggr = torch.amax(masked, dim=2)
        has_neighbor = torch.any(pair_valid, dim=2)[..., None]
        aggr = torch.where(has_neighbor, aggr, 0.0)
        upd_in = torch.cat([x, aggr.float(), sem], dim=-1)
        return self.update_mlp(upd_in).float()


class SceneInteractionNet(nn.Module):
    def __init__(self, in_dim: int, nc: int, msg_node_channels: int,
                 out_channels: int, k: int = 1, dtype=None):
        super().__init__()
        self.k = k
        self.mlp_in = MLP(in_dim, (128, 128, msg_node_channels), dtype)
        for ki in range(k):
            setattr(self, f"conv{ki}", AgentInteractionConv(
                msg_node_channels, nc, msg_node_channels, dtype=dtype))
        self.mlp_out = MLP(msg_node_channels, (128, 128, out_channels),
                           dtype)

    def forward(self, x, pos, sem, mask):
        x = self.mlp_in(x)
        for ki in range(self.k):
            x = getattr(self, f"conv{ki}")(x, pos, sem, mask)
        return self.mlp_out(x).float()
