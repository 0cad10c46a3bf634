"""strive_tpu's trained prior on the port, on the CPU.

The tracked orbax store ``out/train_synth_prod/checkpoints/latest_model``
(``configs/adv_gen_synth_hc_prod.cfg``'s ``ckpt``) is committed converted,
by ``convert_orbax_ckpt.py``, at
``out/train_synth_prod_torch/checkpoints/latest_model/torch_state.pt``.

- The committed file equals a fresh conversion of the store, tensor for
  tensor and bit for bit, with the same epoch and min val loss, and holds
  no optimizer state.
- The port's model built from the config loads it with ``strict=True`` and
  decodes as strive_tpu does from the orbax params: one scene of the
  config's synthetic val split cut to 4 agents, its embed and a decode of
  the prior means cut to 3 of the config's 12 steps, within
  ``tests/test_torch_model.py``'s MODEL tolerance (atol 1e-4 in normalized
  units). The two packages' map stores are first checked to be equal.
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

from torch_helpers import n, scene_to_torch, t

from convert_orbax_ckpt import convert, main as convert_main
from strive_tpu.data.loading import load_environment as j_load
from strive_tpu.normalize import effective_categories
from strive_tpu.utils.checkpoint import load_params
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.normalize import (att_normalizer_for,
                                        state_normalizer_for)
from strive_tpu_torch.scripts import adv_scenario_gen as tgen
from strive_tpu_torch.scripts.common import build_model
from strive_tpu_torch.utils.checkpoint import load_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "adv_gen_synth_hc_prod.cfg")
ORBAX = os.path.join(REPO, "out", "train_synth_prod", "checkpoints",
                     "latest_model")
PORT_CKPT = os.path.join(REPO, "out", "train_synth_prod_torch", "checkpoints",
                         "latest_model")
MODEL = dict(rtol=0, atol=1e-4)  # tests/test_torch_model.py:38
DECODE_STEPS = 3


def test_committed_file_is_a_fresh_conversion(tmp_path):
    params, opt_state, epoch, min_val_loss = load_state(PORT_CKPT)
    fresh, f_epoch, f_loss = convert(ORBAX)
    assert opt_state is None
    assert (epoch, min_val_loss) == (f_epoch, f_loss) == (380, f_loss)
    assert abs(min_val_loss - 3.7223) < 5e-5
    assert sorted(params) == sorted(fresh)
    for k, v in fresh.items():
        assert params[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(params[k], v), k
    # the script writes what convert returns, under the store's own name
    path = convert_main(["--orbax", ORBAX, "--out", str(tmp_path)])
    assert path == str(tmp_path / "latest_model")
    again = load_state(path)
    assert again[1:] == (None, epoch, min_val_loss)
    assert all(torch.equal(again[0][k], v) for k, v in fresh.items())


@pytest.fixture(scope="module")
def prod():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from train_traffic import build_model as j_build  # noqa: E402

    cfg = tgen.parse_cfg(["-c", CFG, "--synth_scenes", "2",
                          "--max_agents", "4"])
    ds, store, _, sn, an = j_load(cfg, cfg.split)
    cats = effective_categories(cfg.agent_types, cfg.reduce_cats)
    jm = j_build(cfg, sn, an, len(cats))
    tm = build_model(cfg, state_normalizer_for(cats), att_normalizer_for(cats),
                     len(cats), "cpu")
    tm.load_state_dict(load_state(PORT_CKPT)[0], strict=True)
    jp = load_params(ORBAX)
    ts = t_store(num_maps=2, size_px=512, channels=4, pix_per_m=4.0,
                 device="cpu")
    return jm, jp, tm.eval(), ds.get_batch([0]), store, ts


def test_decode_matches_strive_tpu_from_orbax(prod):
    jm, jp, tm, scene, js, ts = prod
    assert np.array_equal(n(ts.packed), np.asarray(js.packed))
    assert scene.B == 1 and scene.NA == 4 and int(scene.mask.sum()) >= 2
    tsc = scene_to_torch(scene)
    je = jax.jit(lambda p, s: jm.apply(p, s, js, method="embed"))(jp, scene)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    for k in ("map_feat", "past_feat"):
        np.testing.assert_allclose(n(te[k]), n(je[k]), **MODEL, err_msg=k)
    for k in ("prior_out", "posterior_out"):
        for i in range(2):
            np.testing.assert_allclose(n(te[k][i]), n(je[k][i]), **MODEL,
                                       err_msg=k)
    z = je["prior_out"][0]
    jd = jax.jit(lambda p, z, e: jm.apply(
        p, z, e, scene, js, nfuture=DECODE_STEPS,
        method="decode_embedding"))(jp, z, je)["future_pred"]
    with torch.no_grad():
        td = tm.decode_embedding(t(z), te, tsc, ts,
                                 nfuture=DECODE_STEPS)["future_pred"]
    assert td.shape == (1, 4, DECODE_STEPS, 4)
    np.testing.assert_allclose(n(td), n(jd), **MODEL)
