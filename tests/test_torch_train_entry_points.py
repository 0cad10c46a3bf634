"""The port's training and evaluation entry points against strive_tpu's.

- ``train_traffic``: ``scripts/train_traffic.main`` (JAX, on the CPU) and
  ``strive_tpu_torch.scripts.train_traffic.main`` (``--device cpu``) on
  ``configs/train_traffic_synthetic.cfg`` (2 epochs of 2 batches, both
  collision priors, a validation pass and the checkpoints every epoch),
  the port with JAX's initial weights and JAX's step noise (``PRNGKey(0)``,
  split as the JAX script and ``Trainer.run_epoch`` split it). The log's
  epoch lines, KL weights and checkpoint events are equal; every train and
  val loss, recon and KL figure rtol 1e-3 (the log prints 4 decimals;
  measured, the second epoch's mean KL 1.8e-4 apart: Adam steps of
  gradients within float noise of 0 differ, tests/test_torch_train.py).
  The checkpoints have the same names (three, one epoch file an epoch).
- Resume: the port's run resumed from its ``latest_model`` restores the
  weights, the optimizer state (Adam's count and moments) and the epoch,
  and its log says so; ``save_state`` -> ``load_state`` is exact.
- ``test_traffic``: ``scripts/test_traffic.main`` against the port on a
  synthetic config of the tiny model's widths, with JAX's weights and JAX's
  sample noise: the posterior-mean metrics rtol 1e-4 / atol 1e-5 (ang_err
  atol 1e-3 deg: arccos near 1), the collision rates exactly, and the
  sample metrics at the samples' tolerance of
  tests/test_torch_pipeline_stages.py (1e-4 normalized, 1.5e-3 m; 1e-2
  deg): measured 3.3e-4 m (pos_minFDE) and 5.9e-4 deg (ang_minFDE).
"""

import os
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (sets the torch thread count)
from strive_tpu_torch import train as ttrain
from strive_tpu_torch.scripts import test_traffic as ttest
from strive_tpu_torch.scripts import train_traffic as ttrain_script
from strive_tpu_torch.utils.checkpoint import load_state, save_state
from strive_tpu_torch.utils.convert import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import test_traffic as jtest  # noqa: E402
import train_traffic as jtrain  # noqa: E402

TRAIN_CFG = os.path.join(REPO, "configs", "train_traffic_synthetic.cfg")
SAMPLE_METRICS = ("pos_minADE", "pos_minFDE", "ang_minADE", "ang_minFDE",
                  "APD")
TEST_CONFIG = """\
data_version: synthetic
batch_size: 4
max_agents: 8
synth_scenes: 8
future_len: 6
map_obs_size_pix: 64
map_obs_bounds: [-4.0, -8.0, 12.0, 8.0]
conv_kernel_list: [5, 3, 3]
conv_stride_list: [2, 2, 2]
conv_filter_list: [8, 8, 16]
split: val
test_sample_num: 3
test_sample_future_len: 6
test_sample_disp_err: true
test_sample_coll_rate: true
test_recon_coll_rate: true
"""
NUM = r"(-?[0-9.]+(?:e-?[0-9]+)?)"


def _capture_init(module, monkeypatch):
    """Record the Flax weights ``module.init_model_params`` draws."""
    captured = {}
    real = module.init_model_params

    def capture(*a, **k):
        out = real(*a, **k)
        # a copy: the JAX trainer donates (deletes) its initial state
        captured["flax"] = jax.tree_util.tree_map(np.array, out)
        return out

    monkeypatch.setattr(module, "init_model_params", capture)
    return captured


def _jax_weights(captured):
    def load(model):
        model.load_state_dict(params_from_flax(captured["flax"]))
    return load


def _jax_step_noise(monkeypatch):
    """Make the port's trainer draw JAX's noise: the script's key,
    PRNGKey(0), split once an epoch pass (train, then val), and that key
    split once a batch, as ``TrafficModel.forward`` splits the batch key."""
    state = {"key": jax.random.PRNGKey(0)}
    real_epoch = ttrain.Trainer.run_epoch

    def run_epoch(self, *a, **k):
        state["key"], state["epoch"] = jax.random.split(state["key"])
        return real_epoch(self, *a, **k)

    def draw_noise(self, scene):
        state["epoch"], sub = jax.random.split(state["epoch"])
        k1, k2 = jax.random.split(sub)
        shape = (scene.B, scene.NA, self.model.latent_size)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, shape, jnp.float32))) for k in (k1, k2))

    monkeypatch.setattr(ttrain.Trainer, "run_epoch", run_epoch)
    monkeypatch.setattr(ttrain.Trainer, "draw_noise", draw_noise)


def _log(out, name):
    with open(os.path.join(out, name)) as f:
        return f.read().splitlines()[2:]  # after the date and the args


def _figures(lines):
    """The numbers of the epoch, loss and checkpoint lines, in order."""
    keep = []
    for line in lines:
        line = re.sub(r" time [0-9.]+s", "", line)
        if re.match(r"(Epoch|  train loss|  val loss|  new best|KL anneal)",
                    line):
            keep.append((re.sub(NUM, "#", line),
                         [float(x) for x in re.findall(NUM, line)]))
    return keep


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    mp = pytest.MonkeyPatch()
    try:
        captured = _capture_init(jtrain, mp)
        jtrain.main(["-c", TRAIN_CFG, "--out", str(tmp / "jax")])
        mp.setattr(ttrain_script, "init_params", _jax_weights(captured))
        _jax_step_noise(mp)
        ttrain_script.main(["-c", TRAIN_CFG, "--out", str(tmp / "port"),
                            "--device", "cpu"])
    finally:
        mp.undo()
    return str(tmp / "jax"), str(tmp / "port")


def test_train_traffic_matches(train_runs):
    jout, tout = train_runs
    want, got = _figures(_log(jout, "train_log.txt")), \
        _figures(_log(tout, "train_log.txt"))
    assert [w for w, _ in got] == [w for w, _ in want]
    assert len(want) >= 6  # 2 epochs: epoch, train and val lines
    for (line, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=line)
    names = sorted(os.listdir(os.path.join(tout, "checkpoints")))
    assert names == ["best_eval_model", "epoch_00000000_model",
                     "epoch_00000001_model", "latest_model"]
    assert names == sorted(os.listdir(os.path.join(jout, "checkpoints")))


def test_checkpoint_round_trip_and_resume(train_runs, tmp_path):
    _, tout = train_runs
    latest = os.path.join(tout, "checkpoints", "latest_model")
    params, opt, epoch, best = load_state(latest)
    assert epoch == 1 and np.isfinite(best)
    assert opt["count"] == 4  # 2 epochs x 2 batches
    path = save_state(str(tmp_path), "copy", params, opt, epoch, best)
    p2, o2, e2, b2 = load_state(path)
    assert (e2, b2) == (epoch, best) and o2["count"] == opt["count"]
    for k in params:
        assert torch.equal(p2[k], params[k]), k
    for a, b in zip(o2["mu"] + o2["nu"], opt["mu"] + opt["nu"]):
        assert torch.equal(a, b)

    # resume for one more epoch: the run starts from the saved state
    seen = {}
    real_epoch = ttrain.Trainer.run_epoch

    def spy(self, *a, **k):  # the state the first epoch starts from
        seen.setdefault("count", self.opt.count)
        seen.setdefault("weights", {k_: v.clone() for k_, v in
                                    self.model.state_dict().items()})
        return real_epoch(self, *a, **k)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ttrain.Trainer, "run_epoch", spy)
        ttrain_script.main(["-c", TRAIN_CFG, "--out", str(tmp_path / "r"),
                            "--device", "cpu", "--ckpt", latest,
                            "--epochs", "2"])
    finally:
        mp.undo()
    assert seen["count"] == 4
    for k, v in params.items():
        assert torch.equal(seen["weights"][k], v), k
    lines = _log(str(tmp_path / "r"), "train_log.txt")
    assert any(l.startswith("Loaded ckpt from epoch 1") for l in lines)
    assert "Epoch 1 (kl weight 0.002000)" in lines
    assert not any(l.startswith("Epoch 0") for l in lines)
    _, o3, e3, _ = load_state(str(tmp_path / "r" / "checkpoints" /
                                  "latest_model"))
    assert e3 == 1 and o3["count"] == 6


def _jax_prior_noise():
    """JAX's per-batch sample noise: PRNGKey(0) split in three a batch,
    the third key for the samples (scripts/test_traffic.py:108-118)."""
    key = jax.random.PRNGKey(0)

    def noise(generator, shape):
        nonlocal key
        key, _, k2 = jax.random.split(key, 3)
        return torch.from_numpy(np.array(
            jax.random.normal(k2, shape, jnp.float32)))

    return noise


def test_test_traffic_metrics_match(tmp_path, monkeypatch):
    cfg = tmp_path / "test.cfg"
    cfg.write_text(TEST_CONFIG)
    captured = _capture_init(jtest, monkeypatch)
    want = jtest.main(["-c", str(cfg), "--out", str(tmp_path / "jax")])
    monkeypatch.setattr(ttest, "init_params", _jax_weights(captured))
    monkeypatch.setattr(ttest, "prior_noise", _jax_prior_noise())
    got = ttest.main(["-c", str(cfg), "--out", str(tmp_path / "port"),
                      "--device", "cpu"])
    assert sorted(got) == sorted(want) and len(want) == 16
    for k in want:
        if "coll_rate" in k:
            assert got[k] == want[k], k
        elif k in SAMPLE_METRICS:
            atol = 1e-2 if k.startswith("ang") else 1.5e-3
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)
        else:
            atol = 1e-3 if k == "ang_err" else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                       err_msg=k)
    assert "==== evaluation results ====" in _log(str(tmp_path / "port"),
                                                  "test_log.txt")
    # the sample overlay renders the first scene of each of the first 3
    # batches, as strive_tpu's does
    ttest.main(["-c", str(cfg), "--out", str(tmp_path / "v"),
                "--device", "cpu", "--test_sample_viz_multi"])
    assert sorted(os.listdir(tmp_path / "v" / "viz")) == [
        f"sample_{i}.jpg" for i in range(2)]  # 8 scenes: 2 batches
