"""Convert a reference STRIVE PyTorch checkpoint (.pth) to a port
checkpoint.

    python -m strive_tpu_torch.scripts.convert_ref_ckpt --pth model_ckpt/traffic_model.pth \\
        --out ./model_ckpt/traffic_model [model config flags...]

Port of ``scripts/convert_ref_ckpt.py``: the reference TrafficModel state
dict (``{"model": state_dict, "epoch": n}`` or the bare state dict) goes
through ``utils.convert.convert_traffic_model_state_dict`` into the port's
parameter names and layouts, is checked against a fresh model of the
given config (the same names and shapes, then one forward pass on a
synthetic scene with finite outputs on ``--device``, default ``cuda``;
``--device cpu`` without a card), and is written as a port checkpoint
directory ``<out>/torch_state.pt``, which ``--ckpt`` reads in every entry
point.
"""

from __future__ import annotations

import os
import sys

import torch

from ..data.synthetic import synthetic_scene_list
from ..maps import synthetic_map_store
from ..normalize import att_normalizer_for, state_normalizer_for
from ..scene import pad_scene_arrays
from ..utils.checkpoint import save_state
from ..utils.config import add_base_args, get_parser
from ..utils.convert import convert_traffic_model_state_dict
from .common import build_model, resolve_device


def main(argv=None):
    """Convert; returns the checkpoint directory."""
    parser = get_parser("Convert reference checkpoint (PyTorch)")
    parser = add_base_args(parser)
    parser.add_argument("--pth", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    args = parser.parse(argv)
    device = resolve_device(args.device)

    ckpt = torch.load(args.pth, map_location="cpu")
    sd = ckpt["model"] if "model" in ckpt else ckpt
    epoch = int(ckpt.get("epoch", 0))

    cats = tuple(sorted(args.agent_types))
    state_norm = state_normalizer_for(cats)
    att_norm = att_normalizer_for(cats)
    nc = len(args.agent_types)
    model = build_model(args, state_norm, att_norm, nc, "cpu")
    params = convert_traffic_model_state_dict(sd, model)

    # sanity: structure must match a fresh model
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if want != got:
        lines = [f"  {k}: model {want.get(k)}, converted {got.get(k)}"
                 for k in sorted(set(want) | set(got))
                 if want.get(k) != got.get(k)]
        sys.exit("Converted parameter tree mismatch:\n" + "\n".join(lines))
    model.load_state_dict(params)
    model.to(device)
    scenes = synthetic_scene_list(num_scenes=1, PT=args.past_len,
                                  FT=args.future_len, NC=nc, max_agents=3)
    scene = pad_scene_arrays(scenes, 4, nc, device=device)
    store = synthetic_map_store(num_maps=2, channels=model.map_channels,
                                device=device)
    with torch.no_grad():
        pred = model(scene, store, use_post_mean=True)
    if not bool(torch.isfinite(pred["future_pred"]).all()):
        sys.exit("Converted model gives non-finite futures")

    out_dir = os.path.dirname(args.out) or "."
    path = save_state(out_dir, os.path.basename(args.out), params, None,
                      cur_epoch=epoch)
    n = sum(v.numel() for v in params.values())
    print(f"Converted {n} params (epoch {epoch}) -> {path}")
    return path


if __name__ == "__main__":
    main()
