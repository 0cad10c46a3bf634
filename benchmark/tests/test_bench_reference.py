"""The plain reference against strive_tpu_torch at a tiny size on the CPU:
a few adversarial iterations, training steps, the parameter table, and
the TF32 rounding of the control."""

import numpy as np
import pytest
import torch

from benchmark.drivers import optim, train
from benchmark.reference.model import param_shapes, tf32
from benchmark.tests import tiny


@pytest.mark.parametrize("name", ["strive_adv_nusc", "strive_train_nusc"])
def test_parameter_table_is_the_programs(name):
    from benchmark import harness
    from benchmark.inputs import weights

    cfg = tiny.config(name)
    w = weights.draw(cfg["model"], 3, "cpu")
    model = harness.program_model(cfg["model"], w, "cpu")
    got = [(n, tuple(p.shape)) for n, p in model.state_dict().items()]
    assert got == [(n, tuple(s)) for n, s in param_shapes(
        cfg["model"]).items()]
    for n, p in model.state_dict().items():
        assert torch.equal(p, w[n])


def test_weights_follow_the_seed_and_the_distributions():
    from benchmark.inputs import weights

    m = tiny.config("strive_adv_nusc")["model"]
    a, b = weights.draw(m, 5, "cpu"), weights.draw(m, 5, "cpu")
    c = weights.draw(m, 2 ** 31 + 9, "cpu")
    k = "decoder_net.mlp_in.fc1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert float(a[k].abs().max()) <= 2 * (1 / 128) ** 0.5 / .8796 + 1e-6
    assert float(a[k].std()) == pytest.approx((1 / 128) ** 0.5, rel=0.05)
    assert torch.all(a["decoder_net.mlp_in.fc1.bias"] == 0)
    assert torch.all(a["decoder_net.mlp_in.ln1.weight"] == 1)


def test_tf32_rounding():
    # 10 mantissa bits: a step of 2**-10 in [1, 2), 2**-9 in [2, 4);
    # ties go away from zero
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -10, 1.0 + 3 * 2 ** -12,
                      1.0 + 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -3.0 - 2 ** -9, 1.0 + 2 ** -10, 1.0])
    assert torch.equal(tf32(x), want)
    y = torch.randn(1000)
    assert float(((tf32(y) - y) / y).abs().max()) <= 2 ** -11


@pytest.fixture(scope="module")
def adv_run():
    r = tiny.run("strive_adv_nusc", "adv_open_b4")
    optim.setup(r)
    optim.window(r)
    optim.release(r)
    return r


@pytest.fixture(scope="module")
def train_run():
    r = tiny.run("strive_train_nusc", "train_b4")
    train.setup(r)
    train.window(r)
    train.release(r)
    return r


def test_adversarial_iterations_agree(adv_run):
    got = optim.reference_numbers(adv_run)
    # float noise of one CPU decode: the same ops in another layout
    assert got["prior_gap"] < 1e-5 and got["map_feat_gap"] < 1e-5
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-4 and got["step_gap"] < 1e-4


def test_adversarial_control_departs(adv_run):
    low = optim.reference_numbers(adv_run)
    high = optim.reference_numbers(adv_run, "tf32")
    for k in ("prior_gap", "map_feat_gap", "loss_gap", "grad_gap"):
        assert high[k] > 30 * low[k], k


def test_training_steps_agree(train_run):
    got = train.reference_numbers(train_run)
    assert got["loss_gap"] < 1e-5 and got["pose_gap_m"] < 5e-3
    assert got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3


def test_training_control_departs(train_run):
    low = train.reference_numbers(train_run)
    high = train.reference_numbers(train_run, "tf32")
    for k in ("pose_gap_m", "loss_gap", "grad_gap", "change_gap"):
        assert high[k] > 5 * low[k], k


def test_training_reference_order_is_the_feeds():
    from strive_tpu_torch.data.dataset import SceneDataset, batch_iterator

    class DS(SceneDataset):
        def get_batch(self, indices, na=None):
            return list(indices)

    ds = DS([{"past": np.zeros((1, 4, 6))}] * 12, 4, 2, device="cpu")
    got = [i for b in batch_iterator(ds, 4, shuffle=True, seed=[7, 3])
           for i in b]
    assert got == train.order(7, 3, 12).tolist()
