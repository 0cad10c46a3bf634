"""Train the CVAE traffic prior, on PyTorch.

    python -m strive_tpu_torch.scripts.train_traffic -c configs/train_synth_prod.cfg
    python -m strive_tpu_torch.scripts.train_traffic -c configs/train_traffic_synthetic.cfg --device cpu

Port of ``scripts/train_traffic.py`` with the same flags, defaults, log
lines and checkpoints: KL annealing to ``--loss_kl`` over
``--kl_anneal_end`` epochs (the best validation loss is forgotten when it
ends), a validation pass every ``--val_every`` epochs that writes
``best_eval_model`` on a new best, and ``epoch_%08d_model`` and
``latest_model`` every ``--save_every`` epochs, under ``<out>/checkpoints``.
``--ckpt`` resumes: weights, optimizer state and epoch.

- ``--device`` defaults to ``cuda`` and raises without a card; the CPU
  runs only when asked for (``--device cpu``).
- Training is data-parallel over every visible card, as strive_tpu's is
  over every device of its mesh: one process a card with NCCL
  (``parallel/mesh.py``), each stepping on its rows of every batch, the
  step the one-process step on the whole batch (``train.Trainer``); the
  batch size must split evenly over the cards, as strive_tpu's sharding
  requires. ``--mesh_devices N`` takes the first N cards, or with
  ``--device cpu`` runs N CPU processes with gloo (the default there is
  one process). Rank 0 alone logs and writes the checkpoints.
- The initial weights are Flax's distributions from a CPU generator
  seeded 0 (``init_params``); the step noise comes from the trainer's CPU
  generator, seeded 0.
- ``--profile_dir`` writes a ``torch.profiler`` trace of epoch
  ``ckpt_epoch + 1`` there (``trace.json``, Chrome format).
- ``--data_version mini``/``trainval`` reads the ETL output of
  ``strive_tpu_torch.scripts.preprocess_nuscenes``; ``--scenario_dir``
  appends saved scenarios to the training split.
- ``--bf16`` computes the map encoder and the decoder's GNN in bfloat16
  (the parameters and the optimizer stay float32); ``--no_output_bicycle``
  has the decoder emit poses directly.
"""

from __future__ import annotations

import os

import torch

from ..data.dataset import bucketed_batch_iterator as batch_iterator
from ..data.loading import load_environment
from ..normalize import effective_categories
from ..parallel.mesh import (default_backend, entry_devices, launch, rank,
                             rank_device)
from ..train import Trainer, compute_kl_weight
from ..utils.checkpoint import save_state
from ..utils.config import add_base_args, get_parser
from ..utils.logger import Logger, mkdir
from .common import (build_model, init_params, load_checkpoint,
                     resolve_device)


def parse_cfg(argv=None):
    parser = get_parser("Train traffic model (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--scenario_dir", type=str, default=None)
    parser.add_argument("--data_noise_std", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--val_every", type=int, default=3)
    parser.add_argument("--save_every", type=int, default=3)
    parser.add_argument("--print_every", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--loss_kl", type=float, default=0.004)
    parser.add_argument("--kl_anneal_end", type=int, default=20)
    parser.add_argument("--loss_recon", type=float, default=1.0)
    parser.add_argument("--loss_veh_coll_prior", type=float, default=0.05)
    parser.add_argument("--loss_env_coll_prior", type=float, default=0.1)
    parser.add_argument("--synth_scenes", type=int, default=24)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of one epoch here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    parser.add_argument("--mesh_devices", type=int, default=None,
                        help="data-parallel over this many processes, one "
                             "a device (default: every visible card; one "
                             "process with --device cpu)")
    return parser.parse(argv)


def main(argv=None, timings=None, init_method=None):
    """Train; returns the last epoch's train metrics.

    :param timings: optional dict, filled with each train step's wall
        seconds (``train_steps``, ended by a device synchronize) and each
        epoch's ``train`` and ``val`` metric dicts (rank 0's).
    :param init_method: the process group's rendezvous with several
        processes (``launch``'s default: a free ``tcp://localhost`` port)
    """
    cfg = parse_cfg(argv)
    device = resolve_device(cfg.device)
    devices = entry_devices(cfg.device, cfg.mesh_devices)
    if len(devices) == 1:
        return train(cfg, torch.device(devices[0]), timings)
    metrics, rank_timings = launch(
        _train_rank, (argv, timings is not None), devices,
        default_backend(device), init_method)
    if timings is not None:
        timings.update(rank_timings)
    return metrics


def _train_rank(argv, want_timings):
    """A rank of ``main``'s processes: :return: (metrics, timings or None)."""
    timings = {} if want_timings else None
    return train(parse_cfg(argv), rank_device(), timings), timings


def train(cfg, device, timings=None):
    """Train on ``device`` (``main``'s arguments); inside a process group,
    this rank's share of every step (``train.Trainer``)."""
    lead = rank() == 0
    mkdir(cfg.out)
    Logger.init(os.path.join(cfg.out, "train_log.txt"))
    Logger.log("Args: " + str(vars(cfg)))
    if timings is not None:
        timings.update(train_steps=[], train=[], val=[])

    wandb_run = None
    if cfg.wandb_project is not None and lead:
        try:
            import wandb

            wandb_run = wandb.init(
                project=cfg.wandb_project, config=vars(cfg),
                mode="offline" if cfg.wandb_offline else "online",
                name=cfg.wandb_name,
            )
        except ImportError:
            Logger.log("wandb requested but not installed; continuing without")

    train_ds, store, _, state_norm, att_norm = load_environment(
        cfg, "train", device=device)
    val_ds = load_environment(cfg, "val", device=device)[0]
    nc = len(effective_categories(cfg.agent_types, cfg.reduce_cats))
    model = build_model(cfg, state_norm, att_norm, nc, "cpu")
    init_params(model)
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    Logger.log("Num model params: %d" % n_params)

    loss_weights = {
        "recon": cfg.loss_recon, "kl": cfg.loss_kl,
        "coll_veh_prior": cfg.loss_veh_coll_prior,
        "coll_env_prior": cfg.loss_env_coll_prior,
    }
    trainer = Trainer(model, loss_weights, state_norm, att_norm, lr=cfg.lr,
                      weight_decay=cfg.weight_decay)

    ckpt_epoch, min_eval_loss = 0, float("inf")
    if cfg.ckpt is not None:
        opt_state, ckpt_epoch, min_eval_loss = load_checkpoint(model,
                                                               cfg.ckpt)
        if opt_state is not None:
            trainer.opt.load_state_dict(opt_state)
        Logger.log(f"Loaded ckpt from epoch {ckpt_epoch} "
                   f"(val loss {min_eval_loss:.4f})")

    def save(name, epoch):
        if not lead:
            return
        save_state(ckpts, name, model.state_dict(), trainer.opt.state_dict(),
                   epoch, min_eval_loss)

    ckpts = os.path.join(cfg.out, "checkpoints")
    mkdir(ckpts)
    use_anneal = cfg.kl_anneal_end is not None and cfg.kl_anneal_end > 0
    step_counter = 0
    m = {}
    for epoch in range(ckpt_epoch, cfg.epochs):
        kl_w = (compute_kl_weight(epoch, cfg.kl_anneal_end, cfg.loss_kl)
                if use_anneal else cfg.loss_kl)
        if use_anneal and epoch == cfg.kl_anneal_end:
            Logger.log("KL annealing finished: resetting val loss tracking")
            min_eval_loss = float("inf")
        Logger.log(f"Epoch {epoch} (kl weight {kl_w:.6f})")
        profiling = cfg.profile_dir is not None and epoch == ckpt_epoch + 1
        prof = None
        if profiling:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        m, step_counter = trainer.run_epoch(
            batch_iterator(train_ds, cfg.batch_size, shuffle=True, seed=epoch),
            store, kl_w, train=True, log_every=cfg.print_every,
            wandb_run=wandb_run, step_counter=step_counter,
            step_seconds=None if timings is None else timings["train_steps"])
        if prof is not None:
            prof.__exit__(None, None, None)
            mkdir(cfg.profile_dir)
            prof.export_chrome_trace(os.path.join(cfg.profile_dir,
                                                  "trace.json"))
            Logger.log(f"  wrote profiler trace to {cfg.profile_dir}")
        Logger.log(f"  train loss {m['loss']:.4f} recon {m['recon_loss']:.4f} "
                   f"kl {m['kl_loss']:.4f} time {m['epoch_time']:.1f}s")
        if timings is not None:
            timings["train"].append(m)
        if wandb_run is not None:
            wandb_run.log({f"Train Epoch Mean {k}": v for k, v in m.items()},
                          step=step_counter)
        if epoch % cfg.val_every == 0:
            vm, step_counter = trainer.run_epoch(
                batch_iterator(val_ds, cfg.batch_size, shuffle=False),
                store, kl_w, train=False, step_counter=step_counter)
            Logger.log(f"  val loss {vm['loss']:.4f}")
            if timings is not None:
                timings["val"].append(vm)
            if vm["loss"] < min_eval_loss:
                min_eval_loss = vm["loss"]
                save("best_eval_model", epoch)
                Logger.log("  new best, saved")
        if epoch % cfg.save_every == 0:
            save("epoch_%08d_model" % epoch, epoch)
            save("latest_model", epoch)
    Logger.log("Training done.")
    return m


if __name__ == "__main__":
    main()
