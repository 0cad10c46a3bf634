"""Checkpoints with ``torch.save`` / ``torch.load(weights_only=True)``.

Port of ``strive_tpu/utils/checkpoint.py`` (orbax there): the reference's
triple-checkpoint policy (``train_traffic.py:340-357``) names
``best_eval_model``, ``epoch_%08d_model`` and ``latest_model``, each a
directory ``<out_dir>/<name>`` as orbax's are, so a path such as the
configs' ``out/train_synth_prod/checkpoints/latest_model`` names it
unchanged. The directory holds one file, ``torch_state.pt``: ``{params,
opt_state, meta: {epoch, min_val_loss}}`` (reference ``utils/torch.py:20-60``),
``params`` the model's state dict and ``opt_state`` the optimizer's, on
the CPU. A directory without that file (strive_tpu's orbax store) is not
read: the port has no orbax. ``convert_orbax_ckpt.py`` at the repo's root
turns such a store into this format where JAX and orbax are installed;
strive_tpu's trained prior is committed so converted, at
``out/train_synth_prod_torch/checkpoints/latest_model``.
"""

from __future__ import annotations

import os

import torch


STATE_FILE = "torch_state.pt"


def _path(out_dir, name):
    return os.path.abspath(os.path.join(out_dir, name))


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_cpu(v) for v in x]
    return x


def save_state(out_dir, name, params, opt_state, cur_epoch=0,
               min_val_loss=float("inf")):
    """Write ``<out_dir>/<name>/torch_state.pt`` (replacing it whole);
    :return: the checkpoint's path, ``<out_dir>/<name>``."""
    payload = {"params": _cpu(dict(params)),
               "meta": {"epoch": int(cur_epoch),
                        "min_val_loss": float(min_val_loss)}}
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    path = _path(out_dir, name)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = f"{final}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, final)
    return path


def load_state(path):
    """:return: (params, opt_state or None, epoch, min_val_loss), tensors
    on the CPU."""
    path = os.path.abspath(path)
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.exists(state_file):
        if os.path.isdir(path):
            raise ValueError(
                f"{path} holds no {STATE_FILE} (an orbax checkpoint of "
                "strive_tpu?); the port reads what its own train_traffic "
                "writes. Convert an orbax store with `python "
                "convert_orbax_ckpt.py --orbax <store> --out <dir>` where "
                "JAX and orbax are installed")
        raise FileNotFoundError(f"no checkpoint at {path}")
    state = torch.load(state_file, map_location="cpu", weights_only=True)
    meta = state["meta"]
    return (state["params"], state.get("opt_state"), int(meta["epoch"]),
            float(meta["min_val_loss"]))

