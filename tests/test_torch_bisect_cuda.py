"""The Hopper kernels of the Mosaic-bisect probes (K5a-K5d) against their
plain PyTorch versions, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere. Imports no JAX, so
it runs on a machine that has only PyTorch. Run on the card with

    python -m pytest --noconftest tests/test_torch_bisect_cuda.py -q

Every comparison is exact (``torch.equal``, dtype too): the kernels copy,
convert bytes, sum modulo 2^32, or multiply once.
"""

import numpy as np
import pytest
import torch

from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.probes import bisect_kernels as bk
from strive_tpu_torch.probes import mosaic_bisect as mb
from strive_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def i32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)


def _same(name, args):
    got = getattr(bk, name)(*args)
    want = getattr(bk, f"{name}_plain")(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
    return got


def _raster(rng, shape, dtype, dev):
    if dtype == torch.float32:
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    return torch.from_numpy(rng.integers(0, 256, shape).astype(
        np.uint8)).to(dev)


@pytest.mark.parametrize("variant", [v for _, _, v in mb.VARIANTS],
                         ids=lambda v: v.__name__)
def test_variants_match_plain_and_want(dev, variant):
    case = variant(dev)
    got = _same(case.kernel, case.args).reshape(case.shape)
    if case.want is not None:
        assert got.dtype == case.want.dtype and torch.equal(got, case.want)


@pytest.mark.parametrize("dtype,R,C,G", [
    (torch.float32, 8192, 1024, 8),   # the path's shape, 16-byte vectors
    (torch.float32, 9, 1001, 3),      # odd rows: one element per thread
    (torch.int32, 12, 256, 4),        # products that wrap
    (torch.int32, 7, 33, 7)])
def test_scale_rows_matches_plain(dev, dtype, R, C, G):
    rng = np.random.default_rng(R)
    if dtype == torch.float32:
        x = torch.from_numpy(rng.standard_normal((R, C)).astype(np.float32))
        f = torch.from_numpy(rng.standard_normal(R // G).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (R, C)).astype(
            np.int32))
        f = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, R // G).astype(
            np.int32))
    _same("scale_rows", (x.to(dev), f.to(dev), G))


def test_scale_rows_unaligned_view(dev):
    """A contiguous view that starts 4 bytes into its buffer takes the
    one-element path."""
    buf = torch.arange(1 + 16 * 64, dtype=torch.float32, device=dev)
    x = buf[1:].view(16, 64)
    _same("scale_rows", (x, torch.full((2,), 3.0, device=dev), 8))


@pytest.mark.parametrize("src_dtype,out_dtype", [
    (torch.uint8, torch.int32), (torch.uint8, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("WC", [192, 61])
def test_window_convert_matches_plain_at_edges(dev, src_dtype, out_dtype, WC):
    """Windows at the last rows and columns, starts off the 16-byte grid,
    negative or past the array; WC 61 is not whole vectors."""
    rng = np.random.default_rng(WC)
    R, C, WR = 300, 1000, 64
    src = _raster(rng, (R, C), src_dtype, dev)
    row0 = i32([R - WR, R - WR - 1, -9, R + 50, 3, 0, -R - 7, 37], dev)
    col0 = i32([C - WC, C - WC - 5, 5, 10 ** 6, -40, 1, 33, 127], dev)
    for side_by_side in (False, True):
        _same("window_convert", (src, row0, col0, WR, WC, out_dtype,
                                 side_by_side))


def test_window_convert_refuses_other_conversions(dev):
    src = torch.zeros((64, 64), dtype=torch.float32, device=dev)
    z = i32([0], dev)
    with pytest.raises(ValueError, match="convert"):
        bk.window_convert(src, z, z, 8, 8, torch.int32)


@pytest.mark.parametrize("case", list(kc.sums_cases()))
def test_window_sums_match_plain_at_edges(dev, case):
    """K5c's shared edge cases (``kernel_cases.sums_cases``): every start
    residue, narrow and whole windows, sums that wrap past 2^31 both ways,
    each load path (16-byte vectors, 4-byte words, bytes), a few outputs
    in wide blocks and more outputs than SMs in narrow ones."""
    got = _same("window_sums", kc.sums_args(kc.sums_cases()[case], dev))
    if case in ("int32", "wrap_C333"):
        assert (got < 0).any() and (got > 0).any()


@pytest.mark.parametrize("offset", [1, 4])
def test_window_sums_unaligned_view(dev, offset):
    """A contiguous uint8 view whose rows are 1024 bytes but start 1 or 4
    bytes into its buffer takes the byte or the word path."""
    rng = np.random.default_rng(offset)
    buf = _raster(rng, (1 + 64 * 1024 + 15,), torch.uint8, dev)
    src = buf[offset:offset + 64 * 1024].view(64, 1024)
    row0 = i32(rng.integers(-64, 128, (5, 2)), dev)
    col0 = i32(rng.integers(-1024, 2048, (5, 2)), dev)
    _same("window_sums", (src, row0, col0, i32([1, -2], dev), 17, 61))


def test_window_sums_at_the_path_shape(dev):
    """2048 windows of 64x192 on a (2048, 1024) uint8 raster, one output
    each: the narrow blocks, 16-byte vectors at every start residue."""
    rng = np.random.default_rng(8)
    src = _raster(rng, (2048, 1024), torch.uint8, dev)
    row0 = i32(rng.integers(0, 2048 - 64, (2048, 1)), dev)
    col0 = i32(rng.integers(0, 1024 - 192, (2048, 1)), dev)
    _same("window_sums", (src, row0, col0, i32([1], dev), 64, 192))


def test_onehot_rows_match_plain_out_of_range(dev):
    rng = np.random.default_rng(6)
    T, R, C, P = 5, 64, 192, 1000
    w = torch.from_numpy(rng.standard_normal((T, R, C)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    idx = i32(rng.integers(-3, R + 3, (T, P)), dev)
    idx[:, :6] = i32([-1, 0, R - 1, R, -2 ** 31, 2 ** 31 - 1], dev)
    _same("onehot_rows", (w, idx))


def test_onehot_rows_match_plain_at_the_path_shape(dev):
    """Byte-valued windows and window-local rows, 256 tiles of the path's
    2048 (the full size runs in chip_smoke.py)."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.integers(0, 256, (256, 64, 192)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    idx = i32(rng.integers(0, 64, (256, 1024)), dev)
    _same("onehot_rows", (w, idx))


@pytest.mark.parametrize("name", list(kc.onehot_cases()))
def test_onehot_rows_match_plain_at_edges(dev, name):
    """``kernel_cases.onehot_cases``: one channel a block, groups that do
    not divide C, tails of 1-3 points, 70,000 tiles on grid x, idx off its
    16 bytes, a w[t] past 48 KB of shared memory."""
    case = kc.onehot_cases()[name]
    w, idx = kc.onehot_args(case, dev)
    got = bk.onehot_rows(w, idx)
    want = bk.onehot_rows_plain(w, idx)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("name", ["scale_rows", "window_convert",
                                  "window_sums", "onehot_rows"])
def test_wrappers_refuse_a_cpu_operand(dev, name):
    """CUDA indices with an operand left on the CPU raise (CPU tensors alone
    are refused in tests/test_torch_bisect.py)."""
    z1 = i32([0], dev)
    args = {"scale_rows": (torch.ones((8, 8)), torch.ones(1, device=dev), 8),
            "window_convert": (torch.zeros((8, 8), dtype=torch.uint8), z1, z1,
                               4, 4, torch.int32),
            "window_sums": (torch.zeros((8, 8), dtype=torch.uint8),
                            z1[None], z1[None], z1, 4, 4),
            "onehot_rows": (torch.zeros((1, 8, 8), dtype=torch.bfloat16),
                            z1[None])}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(bk, name)(*args)


def test_bisect_run_goes_through_the_kernels(dev, monkeypatch):
    monkeypatch.setattr(mb, "REPS", 2)
    for k in bk.LAUNCHES:
        bk.LAUNCHES[k] = 0
    res = mb.run(dev)
    assert all(v["correct"] for v in res["variants"])
    expected = dict.fromkeys(bk.LAUNCHES, 0)
    for v in res["variants"]:
        expected[v["kernel"]] += 1 + timing.calls(2)
    assert bk.LAUNCHES == expected
