"""Diagnostic: how much of an adversarial iteration is the in-loop map
re-encode (crop + CNN)? Times a decode + gradient with and without it.

    python -m strive_tpu_torch.scripts.ablate_hotpath
    python -m strive_tpu_torch.scripts.ablate_hotpath --device cpu

Port of ``scripts/ablate_hotpath.py`` at bench.py's widths
(``bench.workload``: B=4 x NA=8, FT=12, 256 px crops, TF32 off): the
gradient of ``sum(future ** 2)`` with respect to the latents through a
12-step ``decode_embedding`` rollout, in the JAX script's three variants:

- full: the map re-encoded at every rollout step;
- frozen: every step keeps the embedding's map feature (the JAX script
  wraps its decode step to carry the initial feature, ``:59-72``);
- gather only: every step takes the crop (K1 on a card) at its new pose
  and keeps it alive in the feature (``+ 0 * mean(crop)``) but runs no CNN
  (``:74-98``).

The port's decoder is one loop with no step function to wrap, so the
variants replace the model's ``encode_map`` for the run (:func:`frozen_map`,
:func:`gather_only`); the model itself has no knob for them. Each
variant is timed over ``STRIVE_BENCH_ITERS`` calls (10) after a warm-up
call, fenced by ``torch.cuda.synchronize()`` (host ms a call, as the JAX
script times). ``STRIVE_BENCH_B`` / ``_NA`` set the batch. ``--device``
defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from ..maps.queries import get_map_crop
from .bench import decode_grad, env_int, workload
from .common import card_name, resolve_device, sync


@contextlib.contextmanager
def replaced_encode_map(model, fn):
    """``model.encode_map`` is ``fn`` meanwhile."""
    model.encode_map = fn
    try:
        yield
    finally:
        del model.encode_map


def frozen_map(model, map_feat):
    """The frozen variant: every rollout step keeps ``map_feat``."""
    return replaced_encode_map(model, lambda pos, map_idx, store: map_feat)


def gather_only(model, map_feat):
    """The gather-only variant: each step crops at its pose (K1 on a card)
    and adds ``0 * mean(crop)`` to ``map_feat``; no CNN."""
    def encode(pos, map_idx, store):
        B, NA, _ = pos.shape
        crop = get_map_crop(
            store.packed, store.dx, model.state_unnorm(pos).reshape(B * NA, 4),
            torch.repeat_interleave(map_idx, NA), model.map_bounds,
            model.map_channels, L=model.map_obs_size_pix,
            W=model.map_obs_size_pix, layout="nhwc")
        return map_feat + torch.mean(crop) * 0.0
    return replaced_encode_map(model, encode)


def measure(w, label, n, device):
    decode_grad(w)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        decode_grad(w)
    sync(device)
    dt = (time.perf_counter() - t0) / n
    print(f"{label}: {dt * 1e3:.1f} ms / decode+grad", flush=True)
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, NA = env_int("STRIVE_BENCH_B", 4), env_int("STRIVE_BENCH_NA", 8)
    n = env_int("STRIVE_BENCH_ITERS", 10)
    w = workload(device, B, NA)
    print(f"device={card_name(device)}", file=sys.stderr)
    model, map_feat = w["model"], w["emb"]["map_feat"]
    t_full = measure(w, "full (map re-encode in loop)", n, device)
    with frozen_map(model, map_feat):
        t_nomap = measure(w, "ablated (frozen map feature)", n, device)
    with gather_only(model, map_feat):
        t_gather = measure(w, "crop gather, no CNN", n, device)
    print(f"in-loop map encode share: {100 * (1 - t_nomap / t_full):.0f}%")
    print(f"  gather: {(t_gather - t_nomap) * 1e3:.1f} ms, "
          f"CNN: {(t_full - t_gather) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
