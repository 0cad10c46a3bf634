"""The Hopper window kernels (K3, K4a, K4b) against their plain PyTorch
versions, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere. Imports no JAX, so
it runs on a machine that has only PyTorch. Run on the card with

    python -m pytest --noconftest tests/test_torch_probes_cuda.py -q

Every comparison is exact (``torch.equal``): the kernels are integer
gathers and copies, and K3's float32 output is a converted byte.
"""

import numpy as np
import pytest
import torch

from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.probes import gather
from strive_tpu_torch.probes import onehot_crop as oc
from strive_tpu_torch.probes import window_kernels as wk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def i32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)


def _same(name, args):
    got = getattr(wk, name)(*args)
    want = getattr(wk, f"{name}_plain")(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
    return got


def _probe_tiles(window, dev):
    probe = oc.PROBES[window]
    x = oc._inputs(probe, dev)
    N, L, W = probe["N"], probe["L"], probe["W"]
    tiles = [oc.tileize(x[k], N, L, W) for k in ("py", "px", "outside")]
    return x["flat"], oc.tile_windows(*tiles, x["mapix"], probe["H"],
                                      probe["Wp"], x["flat"].shape[0], window)


@pytest.mark.parametrize("window", ["dma", "quadrant"])
def test_crop_tiles_matches_plain_at_probe_shape(dev, window):
    flat, origins = _probe_tiles(window, dev)
    _same("window_crop_tiles", (flat, *origins, *oc.WINDOWS[window]))


@pytest.mark.parametrize("window", ["dma", "quadrant"])
def test_crop_tiles_matches_plain_at_edges(dev, window):
    """Windows at the last rows and columns, origins off the 16-byte grid,
    negative or past the raster, indices outside the window."""
    rng = np.random.default_rng(1)
    flat, _ = _probe_tiles(window, dev)
    R, Wp = flat.shape
    WR, WC = oc.WINDOWS[window]
    row0 = i32([[R - WR, R - WR, -9, R + 50], [3, R - WR - 1, 0, -R - 7]], dev)
    col0 = i32([[Wp - WC, Wp - WC - 5, 5, 10 ** 6], [-40, 1, 33, 127]], dev)
    ly = i32(rng.integers(-3, WR + 4, (2, 4, 1024)), dev)
    lx = i32(rng.integers(-3, WC + 4, (2, 4, 1024)), dev)
    _same("window_crop_tiles", (flat, row0, col0, ly, lx, WR, WC))


def test_crop_tiles_refuses_misaligned_rows(dev):
    rng = np.random.default_rng(2)
    flat = torch.from_numpy(rng.integers(0, 256, (256, 1000))
                            .astype(np.uint8)).to(dev)  # Wp % 16 != 0
    args = (i32([[0]], dev), i32([[0]], dev), i32([[[0]]], dev),
            i32([[[0]]], dev), 64, 192)
    with pytest.raises(ValueError, match="16-byte"):
        wk.window_crop_tiles(flat, *args)
    buf = torch.zeros(256 * 1024 + 1, dtype=torch.uint8, device=dev)
    shifted = buf[1:].view(256, 1024)  # rows 16 apart, the first at +1 byte
    with pytest.raises(ValueError, match="16-byte"):
        wk.window_crop_tiles(shifted, *args)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("case", ["probe2", "flat512", "edges"])
def test_extract_matches_plain(dev, dtype, case):
    rng = np.random.default_rng(3)
    M, H, Wp, N = 2, 2048, 2048, 32
    raster = torch.from_numpy(rng.integers(0, 16, (M * H, Wp))
                              .astype(np.uint8)).to(dev).to(dtype)
    if case in ("probe2", "flat512"):
        WIN = 640 if case == "probe2" else 512
        y0 = i32(rng.integers(0, H - WIN, N), dev)
        x0 = i32(rng.integers(0, Wp - WIN, N), dev)
        mapix = i32(rng.integers(0, M, N), dev)
        row0, col0 = gather.map_origins(mapix, y0, x0, H, WIN)
    else:
        WIN = 640
        row0 = i32([-5, M * H - 10, M * H + 100, 0, 7, -M * H - 3], dev)
        col0 = i32([Wp - 3, -7, 5, 10 ** 6, 9, 1], dev)
    _same("window_extract", (raster, row0, col0, WIN))


@pytest.mark.parametrize("dtype,WIN", [(torch.uint8, 100),
                                       (torch.int32, 102)])
def test_extract_refuses_partial_vectors(dev, dtype, WIN):
    """A window row that is not a whole number of 16-byte vectors raises."""
    raster = torch.zeros((256, 256), dtype=dtype, device=dev)
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        wk.window_extract(raster, z, z, WIN)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("case", ["probe1", "out_of_range"])
def test_take_matches_plain(dev, dtype, case):
    rng = np.random.default_rng(4)
    N, S = (32, 512 * 512) if case == "probe1" else (5, 1000)
    wins = torch.from_numpy(rng.integers(0, 16, (N, S))
                            .astype(np.int32)).to(dev).to(dtype)
    if case == "probe1":
        idx = i32(rng.integers(0, S, (N, 256 * 256)), dev)
    else:
        idx = i32(rng.integers(-2 ** 31, 2 ** 31 - 1, (N, 1001)), dev)
        idx[:, :4] = i32([-1, 0, S - 1, S], dev)
    _same("window_take", (wins, idx))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("case", list(kc.take_cases(0)))
def test_take_edge_cases_match_plain(dev, dtype, case):
    """Rows shorter than a vector or off the vector grid (N = 1, Q in
    {1, 3, 5, 1001}; N = 5, Q = 1001), indices far out of range, and
    N = 70,000 windows (more than a grid's y dimension holds)."""
    wins, idx = kc.take_cases(0)[case]
    _same("window_take", (torch.from_numpy(wins).to(dev).to(dtype),
                          torch.from_numpy(idx).to(dev)))


@pytest.mark.parametrize("Q", [5, 77])
def test_take_unaligned_inputs_match_plain(dev, Q):
    """Windows and index rows that start off the 16-byte grid (views one
    element in), with rows shorter than a vector (Q = 5 of uint8) and
    longer."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.integers(0, 256, 4 * 300 + 1)
                           .astype(np.int32)).to(dev)
    flat = i32(rng.integers(-5, 305, 4 * Q + 1), dev)
    idx = flat[1:].view(4, Q)
    assert idx.data_ptr() % 16
    for w in (buf, buf.to(torch.uint8)):
        wins = w[1:].view(4, 300)
        assert wins.data_ptr() % 16
        _same("window_take", (wins, idx))


@pytest.mark.parametrize("name", ["window_crop_tiles", "window_extract",
                                  "window_take"])
def test_wrappers_refuse_a_cpu_raster(dev, name):
    """CUDA indices with a raster left on the CPU raise (CPU tensors alone
    are refused in tests/test_torch_probes.py)."""
    flat = torch.zeros((64, 256), dtype=torch.uint8)
    z1 = torch.zeros(1, dtype=torch.int32, device=dev)
    z2 = z1.reshape(1, 1)
    args = {"window_crop_tiles": (flat, z2, z2, z2[None], z2[None], 64, 192),
            "window_extract": (flat, z1, z1, 32),
            "window_take": (flat, torch.zeros((64, 3), dtype=torch.int32,
                                              device=dev))}
    with pytest.raises(ValueError, match="CUDA"):
        getattr(wk, name)(*args[name])


def test_dispatchers_launch_the_kernels(dev):
    before = dict(wk.LAUNCHES)
    flat, origins = _probe_tiles("dma", dev)
    wk.crop_tiles(flat, *origins, *oc.WINDOWS["dma"])
    wins = wk.extract(flat, i32([0, 5], dev), i32([3, 0], dev), 64)
    wk.take(wins.reshape(2, -1), i32(np.zeros((2, 7)), dev))
    assert {k: wk.LAUNCHES[k] - before[k] for k in wk.LAUNCHES} == dict.fromkeys(
        wk.LAUNCHES, 1)


def test_probe_runs_go_through_the_kernels(dev, monkeypatch):
    monkeypatch.setattr(oc, "REPS", 2)
    monkeypatch.setattr(gather, "REPS", 2)
    for k in wk.LAUNCHES:
        wk.LAUNCHES[k] = 0
    crop = oc.run(dev)
    gath = gather.run(dev)
    assert all(crop[w]["bit_exact"] for w in oc.PROBES)
    assert all(s["correct"] for s in gath["steps"])
    assert all(wk.LAUNCHES.values())
