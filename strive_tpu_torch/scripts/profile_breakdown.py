"""Micro-profile of the rollout hot path: map crop, map CNN, interaction
net, decode rollout, decode + gradient.

    python -m strive_tpu_torch.scripts.profile_breakdown
    python -m strive_tpu_torch.scripts.profile_breakdown --device cpu

Port of ``scripts/profile_breakdown.py`` at bench.py's widths
(``bench.workload``: B=4 x NA=8, FT=12, 256 px crops of 4 channels, TF32
off). The crop, the CNN and the interaction net are each timed alone, on
a card with CUDA events (``utils.timing.cuda_ms``: device ms a call, the
calls queued behind a spin kernel), on the CPU with the host's clock:

- the crop of N = B x NA poses (uniform over the map, random headings, as
  the JAX script draws them) through K1 ``map_crop`` and through its plain
  version (on the CPU both are the plain version);
- the map CNN (``model.map_encoder``) on those N crops;
- the interaction net of the decoder (``model.decoder_net``, the GNN a
  rollout step runs) on a batch of its input width;
- a 12-step ``decode_embedding`` rollout, and the same with the gradient
  of ``sum(future ** 2)`` with respect to the latents alone (as
  ``jax.grad`` takes it: no parameter gradients). A rollout launches
  more kernels than the card's queue holds, so events around it would
  time the host's pace: each rollout is profiled (``torch.profiler``)
  instead, and its line gives, on a card, the device ms a call of its
  kernels and copies by the program's span that launched them
  (``utils.spans.device_by_span``: crop, CNN, GNN, bicycle, GRU, each
  backward beside it), on the CPU the host ms a call under the profiler
  and each span's own host ms (its time less its recorded children's).

Prints one line a layer, as the JAX script does, and the device on
stderr. ``STRIVE_BENCH_B`` / ``_NA`` set the batch, ``STRIVE_BENCH_ITERS``
the timed calls a layer (10; 5 for the two rollouts, as in the JAX
script). ``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..maps import crop_kernel, queries
from ..utils import spans
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


def self_ms(records):
    """Each span's own ms (its time less its recorded children's), summed
    by name."""
    out = {}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + (r.end_ns - r.start_ns) * 1e-6
        if r.parent is not None:
            p = records[r.parent].name
            out[p] = out.get(p, 0.0) - (r.end_ns - r.start_ns) * 1e-6
    return out


def by_span(fn, reps, device):
    """``reps`` calls of ``fn`` under ``torch.profiler``, after a warm-up
    call. :return: (ms a call, {span: ms a call}): on a card the device's
    (``spans.device_by_span``), on the CPU the host's (:func:`self_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    spans.clear()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
        host_s = time.perf_counter() - t0
    rec = spans.records()
    spans.clear()
    if cuda:
        parts = {k: v * 1e3 for k, v in spans.device_by_span(prof).items()}
        total = sum(parts.values())
    else:
        parts, total = self_ms(rec), host_s * 1e3
    return total / reps, {k: v / reps for k, v in parts.items()}


def span_text(parts):
    """``name ms, ...`` by ms, largest first."""
    return ", ".join(f"{k} {v:.3f}" for k, v in
                     sorted(parts.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, NA = env_int("STRIVE_BENCH_B", 4), env_int("STRIVE_BENCH_NA", 8)
    n = env_int("STRIVE_BENCH_ITERS", 10)
    N = B * NA
    w = workload(device, B, NA)
    cuda = device.type == "cuda"
    print(f"device={card_name(device)}; "
          + ("device ms (CUDA events; the rollouts: torch.profiler)" if cuda
             else "host ms"), file=sys.stderr)
    fns = layer_fns(w)
    ms = {k: device_ms(fns[k], n, device)
          for k in ("crop_plain", "crop_k1", "cnn", "gnn")}
    roll = {k: by_span(fns[k], max(1, n // 2), device)
            for k in ("decode", "decode_grad")}
    px, C = w["model"].map_obs_size_pix, w["model"].map_channels
    kernel = "K1 map_crop" if cuda else "plain (CPU)"
    print(f"crop {N} agents {px}x{px}x{C}: plain path "
          f"{ms['crop_plain']:.3f} ms, {kernel} path {ms['crop_k1']:.3f} ms")
    print(f"map CNN {N} crops: {ms['cnn']:.3f} ms")
    print(f"interaction net: {ms['gnn']:.3f} ms")
    what = "device ms" if cuda else \
        "host ms under the profiler; own host ms"
    (dec, dec_parts), (grad, grad_parts) = roll["decode"], roll["decode_grad"]
    print(f"decode rollout (FT={FT}): {dec:.3f} {what} by span: "
          f"{span_text(dec_parts)} ({N * FT / (dec * 1e-3):.0f} "
          f"agent-steps/s)")
    print(f"decode + grad: {grad:.3f} {what} by span: "
          f"{span_text(grad_parts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
