"""Evaluation errors of the traffic model.

Port of ``strive_tpu/losses/training.py``'s ``compute_coll_rate_env``
(reference ``losses/traffic_model.py:366-419``), which the solution check
of the adversarial pipeline calls. The training loss and the other
evaluation errors of that file wait for the training port (P9).
"""

from __future__ import annotations

import torch

from ..maps.queries import check_on_layer

ENV_COLL_THRESH = 0.05  # reference losses/traffic_model.py:17


def compute_coll_rate_env(scene, future_pred, map_store, state_norm,
                          att_norm, ego_only=False):
    """Map-collision rate over samples (reference
    ``losses/traffic_model.py:366-419``).

    :param future_pred: (B, NS, NA, FT, 4) NORMALIZED
    :return: dict with did_collide (B, NS, NA) bool (False for padded;
        (B, NS, 1) with ``ego_only``), num_coll_map, num_traj_map.
    """
    B, NS, NA, FT, _ = future_pred.shape
    pred = state_norm.unnormalize(future_pred).reshape(B * NS * NA * FT, 4)
    lw = att_norm.unnormalize(scene.lw)
    lw_flat = lw[:, None, :, None, :].expand(B, NS, NA, FT, 2).reshape(-1, 2)
    mapix = scene.map_idx[:, None, None, None].expand(B, NS, NA, FT)
    frac = check_on_layer(map_store.drivable(), map_store.dx, pred, lw_flat,
                          mapix.reshape(-1)).reshape(B, NS, NA, FT)
    coll_frame = frac < (1.0 - ENV_COLL_THRESH)
    did = torch.any(coll_frame, dim=-1) & scene.mask[:, None, :]
    if ego_only:
        did = did[:, :, 0:1]
        n_traj = B * NS
    else:
        n_traj = torch.sum(scene.mask) * NS
    return {
        "did_collide": did,
        "num_coll_map": torch.sum(did).to(torch.float32),
        "num_traj_map": n_traj,
    }
