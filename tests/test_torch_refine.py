"""The port's refinement optimization and its entry point against strive_tpu.

``run_refine_optim`` on both sides with the tiny model of
tests/test_torch_pipeline_stages.py (B=2 scenes x NA=4, FT=6, numpy seed
0, weights ``init_model_params(PRNGKey(0))``), the refine entry point's
weights (coll_veh 100, coll_env 100, init_z 0.01, motion_prior 1),
``samp_future_len`` 8 and ``save_future_len`` 6, from the prior mean:

- 3 Adam iterations (lr 0.05) and 2 L-BFGS iterations (lr 0.5): loss
  history rtol 1e-3, final latents atol 1e-4, and L-BFGS's loss never
  increases (the zoom linesearch's sufficient decrease);
- the refined future atol 1e-4 against strive_tpu's decode of its final
  latents (``decode_embedding``), and atol 1e-2 against the future its
  jitted runner returns: that one differs from strive_tpu's own standalone
  decode of the same latents by up to 9.4e-3 (normalized, after L-BFGS),
  a crop sample on a pixel's rounding tie in the compiled scan (ROADMAP
  §3), while the port's decode agrees with the standalone one to 2e-6.

Then the entry point, ``scripts/refine_traffic_optim.main`` (JAX, on the
CPU) against ``strive_tpu_torch.scripts.refine_traffic_optim.main``
(``--device cpu``) on a synthetic config of the tiny model's widths (8
test scenes, one skipped by ``--feasibility_num`` 3, one batch of 7, 3
Adam iterations): the port gets JAX's weights through ``init_params`` and
JAX's per-batch sample noise through ``prior_noise``. Must match: the
stats dicts, the folder of every scene JSON and its schema, the recorded
past, sizes and classes (atol 1e-4). The trajectories and latents are held
at what was measured, 1.0 m and 0.2 (largest differences 0.884 m and
0.152, printed): the objective is discontinuous at float-noise scale. Its
environment term is a mean over the footprints that are partly off-road,
and a footprint sample that crosses a pixel boundary adds or drops one of
them: at the prior mean of this batch's seven scenes strive_tpu's own
jitted runner takes the loss as 108.6038 where its standalone ``avoid_coll_loss`` gives 108.6570,
and the port 108.7044 (its embed 1e-5 from strive_tpu's moves samples
across boundaries; the port's runner equals its own standalone
evaluation). Adam's per-coordinate normalization turns such gradient
changes into steps of up to lr each. The sampled futures already differ by
up to 0.0125 m (the jitted sampling's rounding ties, as above).

Because a latent bound of 0.2 would also pass latents that were never
refined (3 Adam steps at lr 0.05 move a coordinate by at most 0.15), the
refinement itself is held scene by scene: the sampled latents equal
strive_tpu's (atol 1e-4), each scene's ``z_adv`` is the runner's output,
and the refinement's step from the sampled latents (over the scene's
agents) is as long as strive_tpu's within 5% and points the same way,
cosine at least 0.9 (measured: lengths 1.26-1.93, 2.4% apart at most,
cosines 0.926-0.99995).

The L-BFGS entry point runs on the port alone (the JAX side would double
this file's time): its losses must be finite and never increase, and its
JSONs have the schema.
"""

import json
import glob
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import make_scene, tiny_model, tiny_store
from torch_helpers import n, port_model, scene_to_torch

from strive_tpu.model.traffic_model import init_model_params
from strive_tpu.optim.refine import run_refine_optim as j_refine
from strive_tpu_torch.maps import synthetic_map_store as t_store
from strive_tpu_torch.optim.refine import run_refine_optim
from strive_tpu_torch.scripts import refine_traffic_optim as tref
from strive_tpu_torch.utils.convert import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import refine_traffic_optim as jref  # noqa: E402

WEIGHTS = {"coll_veh": 100.0, "coll_env": 100.0, "init_z": 0.01,
           "motion_prior": 1.0}
FT, SAMP_FT = 6, 8
TRAJ_TOL_M, LATENT_TOL = 1.0, 0.2  # measured (module doc)
STEP_RTOL, STEP_COS = 0.05, 0.9  # measured (module doc)
CONFIG = """\
data_version: synthetic
batch_size: 7
max_agents: 8
synth_scenes: 8
future_len: 6
map_obs_size_pix: 64
map_obs_bounds: [-4.0, -8.0, 12.0, 8.0]
conv_kernel_list: [5, 3, 3]
conv_stride_list: [2, 2, 2]
conv_filter_list: [8, 8, 16]
split: test
feasibility_num: 3
samp_future_len: 8
save_future_len: 6
num_iters: 3
save: true
"""


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = make_scene(rng, B=2, NA=4, PT=4, FT=FT)
    model = tiny_model(FT=FT, PT=4)
    js = tiny_store()
    params = init_model_params(model, scene, js, jax.random.PRNGKey(0))
    je = jax.jit(lambda p, s: model.apply(p, s, js, method="embed"))(params,
                                                                     scene)
    tm = port_model(model, params, 3)
    ts = t_store(num_maps=2, size_px=512, channels=3, device="cpu")
    tsc = scene_to_torch(scene)
    with torch.no_grad():
        te = tm.embed(tsc, ts)
    return model, params, scene, js, je, tm, tsc, ts, te


@pytest.mark.parametrize("optimizer,lr,iters", [("adam", 0.05, 3),
                                                ("lbfgs", 0.5, 2)])
def test_refine_optim_matches(setup, optimizer, lr, iters):
    model, params, scene, js, je, tm, tsc, ts, te = setup
    zj, fj, lj = j_refine(model, params, je["prior_out"][0], lr, WEIGHTS,
                          scene, js, iters, je, je["prior_out"],
                          samp_future_len=SAMP_FT, save_future_len=FT,
                          optimizer=optimizer)
    zt, ft, lt = run_refine_optim(tm, te["prior_out"][0], lr, WEIGHTS, tsc,
                                  ts, iters, te, te["prior_out"],
                                  samp_future_len=SAMP_FT,
                                  save_future_len=FT, optimizer=optimizer)
    assert ft.shape == (scene.B, scene.NA, FT, 4)
    np.testing.assert_allclose(n(lt), n(lj), rtol=1e-3)
    np.testing.assert_allclose(n(zt), n(zj), rtol=0, atol=1e-4)
    standalone = model.apply(params, zj, je, scene, js, None, FT,
                             method="decode_embedding")["future_pred"]
    np.testing.assert_allclose(n(ft), n(standalone), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(ft), n(fj), rtol=0, atol=1e-2)
    if optimizer == "lbfgs":
        assert np.all(np.diff(n(lt)) <= 0)


def test_refine_rejects_unknown_optimizer(setup):
    _, _, _, _, _, tm, tsc, ts, te = setup
    with pytest.raises(ValueError):
        run_refine_optim(tm, te["prior_out"][0], 0.1, WEIGHTS, tsc, ts, 1,
                         te, te["prior_out"], optimizer="sgd")


# ---- the entry point ----------------------------------------------------------

def _jax_noise_stream():
    """JAX's per-batch sample noise: PRNGKey(0), one split a batch."""
    key = jax.random.PRNGKey(0)

    def noise(generator, shape):
        nonlocal key
        key, k1 = jax.random.split(key)
        return torch.from_numpy(np.array(
            jax.random.normal(k1, shape, jnp.float32)))

    return noise


def _scenes(out):
    res = {}
    root = os.path.join(out, "scenario_results")
    for d in ("success", "failed"):
        path = os.path.join(root, d)
        for name in sorted(os.listdir(path)) if os.path.isdir(path) else []:
            with open(os.path.join(path, name)) as f:
                res[(d, name)] = json.load(f)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refine")
    cfg = tmp / "refine.cfg"
    cfg.write_text(CONFIG)
    jout, tout = str(tmp / "jax"), str(tmp / "port")
    captured = {}
    refined = {"jax": [], "port": []}  # (sampled z, refined z) a batch
    mp = pytest.MonkeyPatch()

    def recording(side, fn, z_at):
        def run(*a, **k):
            res = fn(*a, **k)
            refined[side].append((np.array(a[z_at]), np.array(res[0])))
            return res
        return run

    try:
        real_init = jref.init_model_params

        def capture(*a, **k):
            captured["flax"] = real_init(*a, **k)
            return captured["flax"]

        mp.setattr(jref, "init_model_params", capture)
        mp.setattr(jref, "run_refine_optim",
                   recording("jax", jref.run_refine_optim, 2))
        jstats = jref.main(["-c", str(cfg), "--out", jout])

        def jax_weights(model):
            model.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, captured["flax"])))

        mp.setattr(tref, "init_params", jax_weights)
        mp.setattr(tref, "prior_noise", _jax_noise_stream())
        mp.setattr(tref, "run_refine_optim",
                   recording("port", tref.run_refine_optim, 1))
        tstats = tref.main(["-c", str(cfg), "--out", tout, "--device", "cpu"])
    finally:
        mp.undo()
    return jout, tout, jstats, tstats, refined


def test_entry_point_stats_match(runs):
    _, _, jstats, tstats, _ = runs
    assert tstats == jstats
    assert jstats["scenes"] > 0 and jstats["skipped"] > 0


def test_entry_point_scenes_match(runs):
    jout, tout, _, _, _ = runs
    js, ts = _scenes(jout), _scenes(tout)
    assert sorted(ts) == sorted(js) and js
    worst = {}
    for key, want in js.items():
        got = ts[key]
        assert sorted(got) == sorted(want), key
        assert (got["N"], got["dt"], got["map"]) == \
            (want["N"], want["dt"], want["map"])
        np.testing.assert_array_equal(got["sem"], want["sem"])
        for k in ("past", "lw"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
        for k in ("fut_init", "fut_adv", "z_adv"):
            d = float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
            worst[k] = max(worst.get(k, 0.0), d)
    print("largest differences, port against strive_tpu:", worst)
    for k, v in worst.items():
        tol = LATENT_TOL if k == "z_adv" else TRAJ_TOL_M
        assert v <= tol, f"{k}: largest difference {v:.3g} > {tol}"


def test_lbfgs_entry_point_runs(tmp_path):
    cfg = tmp_path / "refine.cfg"
    cfg.write_text(CONFIG)
    timings = {}
    stats = tref.main(["-c", str(cfg), "--out", str(tmp_path / "o"),
                       "--device", "cpu", "--optim_use_lbfgs"],
                      timings=timings)
    assert stats["scenes"] == 7 and stats["skipped"] == 1
    (losses,) = timings["losses"]
    assert np.all(np.isfinite(losses)) and np.all(np.diff(losses) <= 0)
    scenes = _scenes(str(tmp_path / "o"))
    assert len(scenes) == stats["scenes"]
    for sc in scenes.values():
        assert {"N", "dt", "map", "lw", "sem", "past", "fut_init",
                "fut_adv", "z_adv", "z_prior"} <= set(sc)
        assert np.asarray(sc["fut_adv"]).shape == (sc["N"], FT, 4)


def test_entry_point_refuses_what_is_not_ported(tmp_path):
    """What refine once refused now runs as strive_tpu's does: --viz
    renders every refined scene, and real nuScenes without its ETL
    directory raises FileNotFoundError."""
    cfg = tmp_path / "refine.cfg"
    cfg.write_text(CONFIG)
    base = ["-c", str(cfg), "--device", "cpu", "--data_dir",
            str(tmp_path / "no_etl")]
    with pytest.raises(FileNotFoundError):
        tref.main(base + ["--out", str(tmp_path / "d"), "--data_version",
                          "trainval"])
    stats = tref.main(base + ["--out", str(tmp_path / "v"), "--viz",
                              "--num_iters", "1"])
    imgs = glob.glob(str(tmp_path / "v" / "viz_results" / "*" / "*.jpg"))
    assert len(imgs) == stats["scenes"] > 0


def test_refine_k2_args_are_the_avoid_loss(monkeypatch):
    """``kernel_cases.refine_k2`` (the inputs chip_smoke.py and the card
    tests hold K2 to at refine's shape) is what the refine loss hands
    ``get_coll_point``: every agent, its poses interpolated x3 (7,680 cars
    for B=10 x NA=16 x 16 steps)."""
    from strive_tpu_torch import kernel_cases as kc
    from strive_tpu_torch.geometry import interp_traj
    from strive_tpu_torch.losses import adv as tadv
    from strive_tpu_torch.losses import penalties
    from strive_tpu_torch.maps import queries as tq

    store, args = kc.refine_k2("cpu")
    _, scene, (smean, sstd, amean, astd) = kc._full_width_scene("cpu", 16,
                                                                16, 10)
    seen = []

    def spy(*a, **k):
        seen.append(a)
        return tq.get_coll_point(*a, **k)

    monkeypatch.setattr(penalties, "get_coll_point", spy)
    fut = scene.future_gt[..., :4] * sstd + smean
    z = torch.zeros(10, 16, 2)
    tadv.avoid_coll_loss(
        fut, z, (z, torch.ones_like(z)), lw=scene.lw * astd + amean,
        mask=scene.mask, mapixes=scene.map_idx, packed=store.packed,
        dx=store.dx, init_z=z, weights=WEIGHTS, veh_coll_buffer=0.2,
        z_mask=scene.mask)
    (got,) = seen
    assert got[2].shape == (7680, 4) == args[2].shape
    for a, b in zip(got[:5], args[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(torch.equal(got[2], interp_traj(fut, 3).reshape(-1, 4)))


def test_entry_point_refines_the_sampled_latents(runs):
    """The entry point refines the latents it sampled and saves the refined
    ones: each scene's ``z_adv`` is the runner's output, and its step from
    the sampled latents is as long as strive_tpu's and points the same way."""
    jout, tout, _, _, refined = runs
    assert len(refined["port"]) == len(refined["jax"]) == 1
    (z0_t, zf_t), = refined["port"]
    (z0_j, zf_j), = refined["jax"]
    np.testing.assert_allclose(z0_t, z0_j, rtol=0, atol=1e-4)
    saved = {int(name[6:10]): sc for (_, name), sc in _scenes(tout).items()}
    ids = sorted(saved)
    report = []
    for b, i in enumerate(ids):
        na = len(saved[i]["z_adv"])
        np.testing.assert_allclose(saved[i]["z_adv"], zf_t[b, :na], rtol=0,
                                   atol=1e-6)
        st, sj = (zf_t[b, :na] - z0_t[b, :na]).ravel(), \
            (zf_j[b, :na] - z0_j[b, :na]).ravel()
        nt, nj = np.linalg.norm(st), np.linalg.norm(sj)
        report.append((i, float(nt), float(nj),
                       float(st @ sj / (nt * nj))))
    print("scene, step of port, of strive_tpu, cosine:", report)
    for i, nt, nj, cos in report:
        assert nj > 0.5, (i, nj)
        assert abs(nt - nj) <= STEP_RTOL * nj and cos >= STEP_COS, \
            (i, nt, nj, cos)
