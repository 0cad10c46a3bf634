"""Feasibility check: which agents could plausibly attack the ego?

Port of ``strive_tpu/optim/feasibility.py`` (reference
``utils/scenario_gen.py:30-107``, determine_feasibility_nusc): from NS
prior samples, an agent is a feasible attacker if some sample comes within
``feasibility_thresh`` meters of the ego at a step >= ``feasibility_time``,
optionally in front of the ego, not separated from it by non-drivable
area, and moving faster than ``feasibility_vel``. Every argmin picks the
first index on ties, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..maps.queries import check_line_layer
from ..normalize import REDUCED_CAT


def determine_feasibility(samples, mask, state_norm, feasibility_thresh,
                          feasibility_time=0, feasibility_vel=0.0,
                          feasibility_infront_min=None,
                          check_non_drivable_separation=True,
                          drivable=None, dx=None, map_idx=None):
    """
    :param samples: (NS, NA, FT, 4) NORMALIZED samples of ONE scene
        (slot 0 = ego)
    :param mask: (NA,) validity
    :param drivable, dx, map_idx: the drivable layer (M, H, W), the
        store's dx and the scene's map index, for the separation check
    :return: feasible (NA-1,) bool, feasible_time_step (NA-1,),
        feasible_dist (NA-1,) — all padded-masked (False/FT/inf)
    """
    samples = state_norm.unnormalize(samples)
    ego = samples[:, 0:1]        # (NS, 1, FT, 4)
    agents = samples[:, 1:]      # (NS, NA-1, FT, 4)
    NS, NAm1, FT, _ = agents.shape
    t0 = feasibility_time

    dists = torch.linalg.vector_norm(
        ego[..., t0:, :2] - agents[..., t0:, :2], dim=-1)  # (NS, NA-1, T')
    dists = dists.movedim(0, 1)  # (NA-1, NS, T')

    if feasibility_infront_min is not None:
        ego_h = ego[..., t0:, 2:4]
        d = agents[..., t0:, :2] - ego[..., t0:, :2]
        n = torch.linalg.vector_norm(d, dim=-1)
        cossim = torch.where(
            n > 1e-9, torch.sum(d * ego_h, -1) / torch.clamp(n, min=1e-9),
            -torch.inf)
        infront = cossim.movedim(0, 1) >= feasibility_infront_min
        dists = torch.where(infront, dists, torch.inf)

    min_samp_dists = torch.amin(dists, dim=1)                # (NA-1, T')
    min_samp_inds = torch.argmin(dists, dim=1)               # (NA-1, T')
    feasible_dist = torch.amin(min_samp_dists, dim=1)        # (NA-1,)
    feasible_t = torch.argmin(min_samp_dists, dim=1) + t0
    feasible = torch.sum(dists < feasibility_thresh, dim=(1, 2)) > 0

    if check_non_drivable_separation:
        assert drivable is not None
        rows = torch.arange(NAm1, device=samples.device)
        best_s = min_samp_inds[rows, feasible_t - t0]        # (NA-1,)
        agent_state = agents[best_s, rows, feasible_t, :2]   # (NA-1, 2)
        ego_state = ego[best_s, 0, feasible_t, :2]
        blocked = check_line_layer(
            drivable, dx, agent_state, ego_state,
            torch.as_tensor(map_idx, device=samples.device).reshape(())
            .expand(NAm1))
        feasible = feasible & ~blocked

    vels = torch.linalg.vector_norm(
        agents[:, :, 1:, :2] - agents[:, :, :-1, :2], dim=-1)  # (NS, NA-1, FT-1)
    max_vels = torch.amax(torch.amax(vels, dim=0), dim=-1)   # (NA-1,)
    feasible = feasible & (max_vels > feasibility_vel)

    feasible = feasible & mask[1:]
    return feasible, feasible_t, feasible_dist


def restrict_attackers_to_category(feasible, sem, categories, category,
                                   reduced=False):
    """Keep only feasible candidates of one semantic category.

    Reference ``adv_scenario_gen.py:209-219`` (``--adv_attack_with``): the
    restriction gates FEASIBILITY (which seeds enter the batch) only; the
    adversarial softmin itself stays unrestricted.

    :param feasible: (NA-1,) bool over non-ego agents (slot 0 = ego)
    :param sem: (NA, NC) one-hot semantics incl. the ego row
    :param categories: ordered category names indexing sem's columns (the
        EFFECTIVE set, after ``reduce_cats``)
    :param category: name that may attack (e.g. 'cyclist'); one absent from
        the effective set gives an all-False mask
    :param reduced: True when ``categories`` is the REDUCED set; only then
        is a raw name mapped through ``REDUCED_CAT`` (e.g. 'bus' ->
        'truck'). Without reduction an unknown name never substitutes a
        different category.
    :return: (NA-1,) bool tensor on ``feasible``'s device
    """
    feasible = torch.as_tensor(feasible, dtype=torch.bool)
    cats = list(categories)
    if reduced and category not in cats and REDUCED_CAT.get(category) in cats:
        category = REDUCED_CAT[category]
    if category not in cats:
        return torch.zeros_like(feasible)
    ci = cats.index(category)
    sem = sem.detach().cpu().numpy() if isinstance(sem, torch.Tensor) \
        else np.asarray(sem)
    is_cat = torch.from_numpy(sem[1:, ci] > 0.5).to(feasible.device)
    return feasible & is_cat
