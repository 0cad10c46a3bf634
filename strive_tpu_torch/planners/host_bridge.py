"""Host bridge: run the numpy rule-based planner against torch rollouts.

Port of ``strive_tpu/planners/host_bridge.py:24-51``. The closed-loop
adversarial optimization re-rolls the planner on the current (detached)
non-ego trajectories (reference ``adv_gen_optim.py:133-139``); the planner
of ``hardcode.py`` is host numpy, so the prediction makes one explicit copy
to the host and the planner future one copy back. That copy is the
semantics of this backend, not a fallback: ``device_planner.py`` is the
planner that stays on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def reset_planner(planner, init_state, lw, mask, map_idx):
    """Reset the numpy planner on a padded batch, as
    ``scripts/adv_scenario_gen.py:343-355`` does: each scene's real agents
    in order, a fully-masked padding scene its ego row alone (so every
    scene has an 'ego').

    :param init_state: (B, NA, 6) UNNORMALIZED; lw: (B, NA, 2)
        UNNORMALIZED; mask: (B, NA); map_idx: (B,) — numpy or tensors
    """
    init_state, lw, mask, map_idx = (
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a) for a in (init_state, lw, mask, map_idx))
    counts = [max(int(m.sum()), 1) for m in mask]
    planner.reset(
        np.concatenate([s[:n] for s, n in zip(init_state, counts)]),
        np.concatenate([a[:n] for a, n in zip(lw, counts)]),
        np.repeat(np.arange(len(counts)), counts), len(counts), map_idx)


def make_planner_host_fn(planner, scene_mask, state_norm, dt, future_len):
    """Build ``fn(future_pred_norm (B, NA, FT, 4)) -> (B, FT, 4)`` NORMALIZED.

    ``planner.reset(...)`` must already have been called. Unnormalizes,
    strips ego + padding, rolls the planner per scene, re-normalizes. The
    result is float32 on the prediction's device.
    """
    mask_np = np.asarray(torch.as_tensor(scene_mask).cpu())
    B, NA = mask_np.shape
    smean = state_norm.mean_np[:4]
    sstd = state_norm.std_np[:4]
    plan_t = np.linspace(dt, dt * future_len, future_len)
    # non-ego agents per scene; fully-masked padding scenes contribute
    # their ego only (0 non-ego observations), never a negative count
    counts = np.maximum(mask_np.sum(axis=1) - 1, 0)
    agent_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def host_fn(future_pred_norm):
        fp = future_pred_norm.detach().cpu().numpy() * sstd + smean
        nonego = []
        for b in range(B):
            n = max(int(mask_np[b].sum()), 1)
            nonego.append(fp[b, 1:n])
        nonego = (np.concatenate(nonego, axis=0) if nonego
                  else np.empty((0, future_len, 4)))
        out = planner.rollout(nonego, plan_t, agent_ptr, plan_t)  # (B, FT, 4)
        out = ((out - smean) / sstd).astype(np.float32)
        return torch.from_numpy(out).to(future_pred_norm.device)

    return host_fn
