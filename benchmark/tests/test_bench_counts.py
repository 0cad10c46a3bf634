"""The FLOP and byte counts of ``benchmark/metrics/_counts.py`` against
hand counts."""

import json

import torch

from benchmark.harness import BENCH
from benchmark.metrics import _counts

MODEL = json.loads((BENCH / "configs" / "strive_adv_nusc.json").read_text(
))["model"]


def test_cnn_six_convolutions_by_hand():
    # 256 px, VALID, stride 2: 125, 61, 29, 14, 6, 2 px; 2 FLOPs a MAC
    hand = [2 * 125 * 125 * 16 * 7 * 7 * 4,     # 98,000,000
            2 * 61 * 61 * 32 * 5 * 5 * 16,      # 95,257,600
            2 * 29 * 29 * 64 * 5 * 5 * 32,      # 86,118,400
            2 * 14 * 14 * 64 * 3 * 3 * 64,     # 14,450,688
            2 * 6 * 6 * 128 * 3 * 3 * 64,       # 5,308,416
            2 * 2 * 2 * 128 * 3 * 3 * 128]      # 1,179,648
    convs, lin = _counts.conv_layers(MODEL)
    assert [f for f, _ in convs] == hand
    assert [px for _, px in convs] == [125, 61, 29, 14, 6, 2]
    assert lin == 2 * 512 * 64
    assert _counts.cnn(MODEL) == sum(hand) + 2 * 512 * 64 == 300_380_288


def test_mlp_gru_and_gnn_by_hand():
    assert _counts.mlp(38, (128, 128, 128, 64)) == 2 * (
        38 * 128 + 128 * 128 + 128 * 128 + 128 * 64)
    assert _counts.gru(MODEL) == 2 * 3 * 64 * ((4 + 64) + 2 * (64 + 64))
    # decoder net, 2 agents: mlp_in and mlp_out a node, the edge MLP a pair
    n, d_in = 2, 64 + 64 + 2 + 32 + 2
    hand = (n * 2 * (d_in * 128 + 128 * 128 + 128 * 64)
            + n * n * 2 * ((2 * 64 + 4 + 4) * 128 + 128 * 128 + 128 * 64)
            + n * 2 * ((2 * 64 + 2) * 128 + 128 * 64)
            + n * 2 * (64 * 128 + 128 * 128 + 128 * 2))
    assert _counts.gnn(MODEL, n, d_in, 64, 2) == hand


def test_optim_and_train_counts_compose():
    m, B, N, FT = MODEL, 4, 16, 12
    step = _counts.decoder_step(m, N)
    assert _counts.decode(m, N) == FT * (step + N * _counts.cnn(m))
    assert _counts.optim_iteration(m, B, N) == B * (
        _counts.decode(m, N) + 2 * FT * step)
    fwd = B * (_counts.embed(m, N) + 2 * _counts.decode(m, N))
    no_dx = (B * N * 25 * 98_000_000 + B * N * 2 * 38 * 128
             + B * N * 2 * 110 * 128)
    assert _counts.train_step(m, B, N) == 3 * fwd - no_dx


def test_k1_bytes_by_hand():
    # one 6 x 5 map at 1 m a pixel; 2 poses of a 3 x 2 crop
    shape = (1, 6, 5)
    dx = torch.ones(1, 2)
    lo = torch.tensor([0.0, 1.0, 2.0])
    wo = torch.tensor([0.0, 1.0])
    # pose 0 at (1, 1) heading +x: x in {1, 2, 3}, y in {1, 2}: 6 pixels;
    # pose 1 at (1, 2) heading +x: y in {2, 3}: 3 of its 6 are new
    pos = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 2.0, 1.0, 0.0]])
    mapix = torch.zeros(2, dtype=torch.int64)
    n_out = 2 * 3 * 2 * 4  # samples x 4 channels
    inputs = 2 * 4 * 4 + 2 * 8 + 2 * 4 + (3 + 2) * 4
    got = _counts.crop_bytes(shape, dx, pos, mapix, lo, wo, 4, 4)
    assert got == 9 + inputs + n_out * 4
    assert _counts.crop_bytes(shape, dx, pos, mapix, lo, wo, 4, 2) == \
        9 + inputs + n_out * 2
    # off the map: every sample reads pixel (0, 0), one byte
    far = torch.tensor([[100.0, 100.0, 1.0, 0.0]])
    got = _counts.crop_bytes(shape, dx, far, mapix[:1], lo, wo, 4, 4)
    assert got == 1 + 16 + 8 + 8 + 20 + 6 * 4 * 4


def test_readers_of_a_profile():
    """The split readers on a hand-made profile: an idle share, K1's
    roofline share, and nothing read in the other kind of cell."""
    from benchmark import harness
    from benchmark.run import load_metric
    from benchmark.tests import tiny

    run = tiny.run("strive_adv_nusc", "adv_open_b4")
    run.work = {"iters": 3, "batches": 1, "scene_iters": 6, "scenes": 2}
    lo = torch.linspace(-17.0, 60.0, 64)
    wo = torch.linspace(-38.5, 38.5, 64)
    pos = torch.tensor([[400.0, 500.0, 1.0, 0.0]])
    mapix = torch.zeros(1, dtype=torch.int64)
    r, dx = harness.raster(run.cfg["store"], "cpu")
    shape = (r.shape[0],) + tuple(r.shape[2:])
    nbytes = _counts.crop_bytes(shape, dx, pos, mapix, lo, wo, 4, 4)
    t = nbytes / _counts.PEAK_HBM_BYTES / 0.5  # K1 at half its bound
    run.profile = {"busy_s": 0.25, "span_s": 1.0, "units": 2,
                   "kernels": 10,
                   "kernel_s": {"map_crop_kernel(args)": t, "other": 0.2},
                   "k1": [(pos, mapix, lo, wo, 4, torch.float32)]}
    assert load_metric("device_idle_pct.optim").read(run) == 75.0
    assert abs(load_metric("map_crop_roofline.optim").read(run) - 50.0) \
        < 1e-9
    assert load_metric("launches_per_iter").read(run) == 5.0
    for name in ("device_idle_pct.train", "map_crop_roofline.train",
                 "launches_per_step", "mfu_pct.train"):
        assert load_metric(name).read(run) is None
