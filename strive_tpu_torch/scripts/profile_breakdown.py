"""Micro-profile of the rollout hot path: map crop, map CNN, interaction
net, decode rollout, decode + gradient.

    python -m strive_tpu_torch.scripts.profile_breakdown
    python -m strive_tpu_torch.scripts.profile_breakdown --device cpu

Port of ``scripts/profile_breakdown.py`` at bench.py's widths
(``bench.workload``: B=4 x NA=8, FT=12, 256 px crops of 4 channels, TF32
off). Each layer is timed alone, on a card with CUDA events
(``utils.timing.cuda_ms``: device ms a call, the calls queued behind a
spin kernel), on the CPU with the host's clock:

- the crop of N = B x NA poses (uniform over the map, random headings, as
  the JAX script draws them) through K1 ``map_crop`` and through its plain
  version (on the CPU both are the plain version);
- the map CNN (``model.map_encoder``) on those N crops;
- the interaction net of the decoder (``model.decoder_net``, the GNN a
  rollout step runs) on a batch of its input width;
- a 12-step ``decode_embedding`` rollout, and the same with the gradient
  of ``sum(future ** 2)`` with respect to the latents alone (as
  ``jax.grad`` takes it: no parameter gradients). A rollout launches
  more kernels than the card's queue holds, so the host's pace shows in
  its events' time; on a card each rollout's line adds its device busy
  ms, the sum of its kernels' times in one ``torch.profiler`` call.

Prints one line a layer, as the JAX script does, and the device on
stderr. ``STRIVE_BENCH_B`` / ``_NA`` set the batch, ``STRIVE_BENCH_ITERS``
the timed calls a layer (10; 5 for the two rollouts, as in the JAX
script). ``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..maps import crop_kernel, queries
from ..utils.timing import device_ms
from .bench import FT, decode_grad, env_int, workload
from .common import card_name, resolve_device


def crop_args(w, N, seed=0):
    """K1's arguments for N crops at poses drawn as the JAX script draws
    them (NHWC, the model's layout)."""
    rng = np.random.default_rng(seed)
    dev = w["store"].packed.device
    pos = torch.from_numpy(np.concatenate(
        [rng.uniform(100, 400, (N, 2)), rng.normal(size=(N, 2))],
        axis=1).astype(np.float32)).to(dev)
    mapix = torch.from_numpy(rng.integers(0, 2, N)).to(dev)
    model = w["model"]
    lo, wo = queries.crop_offsets(model.map_bounds, model.map_obs_size_pix,
                                  model.map_obs_size_pix, dev)
    return (w["store"].packed, w["store"].dx, pos, mapix, lo, wo,
            model.map_channels, "nhwc")


def layer_fns(w, seed=0):
    """{label: fn}: each layer of the rollout as one call."""
    model, scene, emb = w["model"], w["scene"], w["emb"]
    B, NA = scene.mask.shape
    args = crop_args(w, B * NA, seed)
    crop = queries.get_map_crop(args[0], args[1], args[2], args[3],
                                model.map_bounds, model.map_channels,
                                model.map_obs_size_pix,
                                model.map_obs_size_pix, "nhwc")
    net = model.decoder_net
    rng = np.random.default_rng(seed)
    width = net.mlp_in.fc0.in_features
    x = torch.from_numpy(rng.normal(size=(B, NA, width)).astype(
        np.float32)).to(crop.device)
    gpos = torch.from_numpy(rng.normal(size=(B, NA, 4)).astype(
        np.float32)).to(crop.device)
    z = emb["prior_out"][0]
    kernel = crop_kernel.map_crop if crop.is_cuda else \
        crop_kernel.map_crop_plain

    def cnn():
        with torch.no_grad():
            return model.map_encoder(crop.permute(0, 3, 1, 2))

    def gnn():
        with torch.no_grad():
            return net(x, gpos, scene.sem, scene.mask)

    def decode():
        with torch.no_grad():
            return model.decode_embedding(z, emb, scene, w["store"])

    return {"crop_plain": lambda: crop_kernel.map_crop_plain(*args),
            "crop_k1": lambda: kernel(*args), "cnn": cnn, "gnn": gnn,
            "decode": decode, "decode_grad": lambda: decode_grad(w)}


def busy_ms(fn):
    """Device ms of ``fn``'s kernels in one call (``torch.profiler``),
    after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, NA = env_int("STRIVE_BENCH_B", 4), env_int("STRIVE_BENCH_NA", 8)
    n = env_int("STRIVE_BENCH_ITERS", 10)
    N = B * NA
    w = workload(device, B, NA)
    print(f"device={card_name(device)}; "
          + ("device ms (CUDA events)" if device.type == "cuda"
             else "host ms"), file=sys.stderr)
    fns = layer_fns(w)
    ms = {k: device_ms(fn, n if k not in ("decode", "decode_grad")
                       else max(1, n // 2), device)
          for k, fn in fns.items()}
    px, C = w["model"].map_obs_size_pix, w["model"].map_channels
    kernel = "K1 map_crop" if device.type == "cuda" else "plain (CPU)"
    print(f"crop {N} agents {px}x{px}x{C}: plain path "
          f"{ms['crop_plain']:.3f} ms, {kernel} path {ms['crop_k1']:.3f} ms")
    print(f"map CNN {N} crops: {ms['cnn']:.3f} ms")
    print(f"interaction net: {ms['gnn']:.3f} ms")
    busy = {k: (f"; device busy {busy_ms(fns[k]):.3f} ms"
                if device.type == "cuda" else "")
            for k in ("decode", "decode_grad")}
    print(f"decode rollout (FT={FT}): {ms['decode']:.3f} ms  "
          f"({N * FT / (ms['decode'] * 1e-3):.0f} agent-steps/s)"
          f"{busy['decode']}")
    print(f"decode + grad: {ms['decode_grad']:.3f} ms{busy['decode_grad']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
