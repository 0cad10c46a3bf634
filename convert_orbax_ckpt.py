"""Convert a strive_tpu orbax checkpoint into a strive_tpu_torch checkpoint.

    JAX_PLATFORMS=cpu python convert_orbax_ckpt.py \\
        --orbax out/train_synth_prod/checkpoints/latest_model \\
        --out out/train_synth_prod_torch/checkpoints

A bridge between the two packages, not part of the port: it reads the
orbax store with ``strive_tpu.utils.checkpoint.load_state`` and so needs
JAX and orbax. Run it where those are installed, once per store; the
port's machine has neither and reads only the file this writes. The Flax
parameters become the port's state dict through
``strive_tpu_torch.utils.convert.params_from_flax``, and the port's
``save_state`` writes them with the store's epoch and min val loss, and no
optimizer state, to ``<out>/<name>/torch_state.pt``, ``<name>`` being the
store's directory name (``latest_model``). Every entry point of the port
reads that directory with ``--ckpt``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def convert(orbax_path):
    """:return: (state dict of float32 CPU tensors, epoch, min_val_loss)."""
    import jax

    from strive_tpu.utils.checkpoint import load_state
    from strive_tpu_torch.utils.convert import params_from_flax

    params, _, epoch, min_val_loss = load_state(orbax_path)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params_from_flax(params), epoch, min_val_loss


def main(argv=None):
    """Convert; :return: the written checkpoint directory."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--orbax", required=True,
                        help="strive_tpu checkpoint directory (orbax)")
    parser.add_argument("--out", required=True,
                        help="directory to write <name>/torch_state.pt into")
    args = parser.parse_args(argv)

    from strive_tpu_torch.utils.checkpoint import save_state

    state, epoch, min_val_loss = convert(args.orbax)
    name = os.path.basename(os.path.normpath(args.orbax))
    path = save_state(args.out, name, state, None, epoch, min_val_loss)
    n = sum(t.numel() for t in state.values())
    print(f"{path}: {len(state)} tensors, {n} parameters, epoch {epoch}, "
          f"min val loss {min_val_loss:.4f}")
    return path


if __name__ == "__main__":
    main()
