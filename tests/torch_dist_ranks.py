"""The rank side of tests/test_torch_distributed.py.

Each function runs in a process that ``strive_tpu_torch.parallel.mesh.launch``
spawned (or, for the one-process reference, in the test's own process,
outside any process group), so this module imports torch and the port
only.
"""

import torch

from strive_tpu_torch.losses.adv import (adv_gen_loss, avoid_coll_loss,
                                         tgt_matching_loss)
from strive_tpu_torch.losses.common import WHOLE_BATCH
from strive_tpu_torch.model.traffic_model import NormConfig, TrafficModel
from strive_tpu_torch.normalize import att_normalizer_for, state_normalizer_for
from strive_tpu_torch.parallel import mesh
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.train import Trainer

CATS = ("car", "truck")  # tests/helpers.py TEST_CATS
TRAIN_WEIGHTS = {"recon": 1.0, "kl": 0.004, "coll_veh_prior": 0.05,
                 "coll_env_prior": 0.1}
LR = 1e-4  # configs/train_synth_prod.cfg


def tiny_model():
    """tests/helpers.py's ``tiny_model``, in the port, on the CPU."""
    sn, an = state_normalizer_for(CATS), att_normalizer_for(CATS)
    return TrafficModel(4, 6, 64, len(CATS), NormConfig.from_normalizers(
        sn, an), map_bounds=(-4.0, -8.0, 12.0, 8.0), conv_kernels=(5, 3, 3),
        conv_strides=(2, 2, 2), conv_filters=(8, 8, 16), map_channels=3,
        device="cpu")


def train_step(state, scene, store, eps, eps_samp):
    """A ``Trainer``'s gradients, eval metrics and train step on the batch
    (this rank's rows of it inside a group).

    :return: (gradients, train metrics, eval metrics, flat parameters
        after the step, whether every rank holds the same parameters)
    """
    model = tiny_model()
    model.load_state_dict(state)
    trainer = Trainer(model, TRAIN_WEIGHTS, state_normalizer_for(CATS),
                      att_normalizer_for(CATS), lr=LR)
    grads, metrics = trainer.gradients(scene, store, 0.004, eps, eps_samp)
    evals = trainer.eval_step(scene, store, 0.004, eps, eps_samp)
    trainer.train_step(scene, store, 0.004, eps, eps_samp)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    same = bool((mesh.gather_rows(flat[None]) == flat).all())
    return [g.clone() for g in grads], metrics, evals, flat, same


ADV_WEIGHTS = {"adv_crash": 2.0, "motion_prior": 1.0,
               "motion_prior_atk": 0.005, "coll_veh": 20.0,
               "coll_veh_plan": 20.0, "coll_env": 20.0, "init_z": 0.5,
               "init_z_atk": 0.05}
SOL_WEIGHTS = {"coll_veh": 10.0, "coll_env": 10.0, "motion_prior": 0.005}
MATCH_WEIGHTS = {"match_ext": 10.0, "motion_prior_ext": 0.1}
OBJECTIVES = ("adv_gen", "avoid_coll", "tgt_matching", "tgt_matching_mean")


def _objective(name, x, fp, z, batch):
    """One objective of the pipeline's optimizations, as they call it
    (``ref_compat=False``, so that the motion prior's mean is in the
    matching loss)."""
    prior = (x["prior_mean"], x["prior_var"])
    if name == "adv_gen":
        out = adv_gen_loss(
            fp, x["tgt"], z, prior, lw=x["lw"], mask=x["mask"],
            mapixes=x["map_idx"], packed=x["packed"], dx=x["dx"],
            init_z=x["init_z"], weights=ADV_WEIGHTS, veh_coll_buffer=0.1,
            crash_min_t=2, crash_min_infront=0.0, batch=batch)
        return out["loss"], torch.stack([out["min_agt"], out["min_t"]], 1)
    if name == "avoid_coll":
        ego = torch.zeros_like(x["mask"])
        ego[:, 0] = True
        out = avoid_coll_loss(
            fp, z, prior, lw=x["lw"], mask=x["mask"], mapixes=x["map_idx"],
            packed=x["packed"], dx=x["dx"], init_z=x["init_z"],
            weights=SOL_WEIGHTS, veh_coll_buffer=0.5, single_veh_idx=0,
            z_mask=ego, batch=batch)
    elif name == "tgt_matching":
        w = (x["mask"][:, :, None] & (torch.arange(fp.shape[1])[:, None]
                                      > 0)).to(torch.float32)
        out = tgt_matching_loss(
            fp, x["match"], z, prior, MATCH_WEIGHTS,
            frame_weights=w.expand(fp.shape[:3]), agent_mask=x["mask"],
            ref_compat=False, batch=batch)
    else:  # the adversarial loop's ego term: a mean over the batch
        out = tgt_matching_loss(
            fp[:, 0], x["tgt"], z[:, 0], (prior[0][:, 0], prior[1][:, 0]),
            MATCH_WEIGHTS, agent_mask=x["mask"][:, 0], ref_compat=False,
            batch=batch)
    return out["loss"], None


def objectives(x, real):
    """Every objective of ``OBJECTIVES`` on the batch ``x`` (a dict of
    tensors, leading axis the scenes), or inside a group on this rank's
    rows of it, with ``mesh.ShardedBatch`` (``real``: (B,) bool, the rows
    that belong to the batch).

    :return: {name: (loss of the whole batch, d loss / d (future_pred, z)
        of every row, the per-row outputs or None)}
    """
    rows = mesh.shard_rows(real.shape[0])
    x = {k: (v[rows] if v.dim() and v.shape[0] == real.shape[0]
             and k not in ("packed", "dx") else v) for k, v in x.items()}
    batch = (mesh.ShardedBatch(real[rows]) if mesh.world() > 1
             else WHOLE_BATCH)
    res = {}
    for name in OBJECTIVES:
        fp = x["future_pred"].clone().requires_grad_(True)
        z = x["z"].clone().requires_grad_(True)
        loss, rows_out = _objective(name, x, fp, z, batch)
        g_fp, g_z = torch.autograd.grad(loss, (fp, z))
        res[name] = (batch.values(loss.detach()),
                     mesh.gather_rows((g_fp, g_z)),
                     None if rows_out is None else mesh.gather_rows(rows_out))
    return res


def _always(*a, **k):
    return True, None, None


def torch_default_init(model):
    """torch's default initializers seeded 0, as chip_smoke.py's phase 9b
    weights the pipeline it holds at ``PARITY_TRAJ_M`` / ``PARITY_LATENT``
    (the fits' amplification of float noise depends on the weights)."""
    torch.manual_seed(0)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters()


def pipeline(argv, all_succeed=False):
    """``adv_scenario_gen.run`` in this process (a rank, or the one
    process) with ``torch_default_init``'s weights and, with
    ``all_succeed``, every scene an adversarial success
    (tests/test_torch_adv_scenario_gen_sol.py), so that the solution
    branch runs."""
    cfg = tgen.parse_cfg(argv)
    real = tgen.init_params, tgen.compute_adv_gen_success
    tgen.init_params = torch_default_init
    if all_succeed:
        tgen.compute_adv_gen_success = _always
    try:
        return tgen.run(cfg, torch.device(cfg.device))
    finally:
        tgen.init_params, tgen.compute_adv_gen_success = real
