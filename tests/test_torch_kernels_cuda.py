"""The Hopper map kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere. Imports no JAX, so
it runs on a machine that has only PyTorch. Run on the card with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

K1 writes float32 and, for the bf16 model, bfloat16: the bf16 crops are
held bit for bit against the plain version's bf16 output (0 and 1 are
exact in both types).

Tolerances: crops, ``valid`` and ``frac`` are exact (the kernels repeat the
plain versions' float32 arithmetic op for op, without FMA contraction).
``coll_pt`` is a mean of up to 624 float32 coordinates: the plain version
sums in float32 in torch's reduction order, the kernel in float64, so they
may differ by the float32 summation error, bounded by
``2e-6 * max|coordinate|`` (about 11 float32 rounding steps of the largest
coordinate).
"""

import numpy as np
import pytest
import torch

from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.maps import crop_kernel, queries
from strive_tpu_torch.maps.store import DEFAULT_BOUNDS, synthetic_map_store

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def store(dev):
    return synthetic_map_store(num_maps=2, size_px=2048, channels=4, seed=3,
                               device=dev)


def _poses(rng, N, lo, hi, unit=True):
    xy = rng.uniform(lo, hi, (N, 2))
    if unit:
        th = rng.uniform(-np.pi, np.pi, N)
        h = np.stack([np.cos(th), np.sin(th)], 1)
    else:
        h = rng.uniform(100, 400, (N, 2))
    return np.concatenate([xy, h], 1).astype(np.float32)


def _crop_both(store, pos, mapix, bounds, L, layout, C=None,
               dtype=torch.float32):
    C = store.C if C is None else C
    lo, wo = queries.crop_offsets(bounds, L, L, pos.device)
    args = (store.packed, store.dx, pos, mapix, lo, wo, C, layout)
    got = crop_kernel.map_crop(*args, dtype)
    assert got.dtype == dtype
    return got, crop_kernel.map_crop_plain(*args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("case", ["interior", "edges", "nan", "small"])
def test_map_crop_matches_plain(dev, store, layout, case, dtype):
    rng = np.random.default_rng(1)
    bounds, L = DEFAULT_BOUNDS, 256
    if case == "interior":  # the main path's shape: 32 agents
        pos = _poses(rng, 32, 150.0, 360.0)
    elif case == "edges":
        pos = _poses(rng, 8, 0.0, 512.0)
        pos[:4, :2] = [[1.0, 1.0], [511.0, 511.0], [-20.0, 50.0], [600.0, 5.0]]
    elif case == "nan":
        pos = _poses(rng, 3, 150.0, 360.0)
        pos[0] = np.nan
        pos[1, 2:] = np.nan
    else:
        pos = _poses(rng, 6, 150.0, 360.0)
        bounds, L = (-4.0, -8.0, 12.0, 8.0), 64
    pos = torch.from_numpy(pos).to(dev)
    mapix = torch.from_numpy(rng.integers(0, 2, len(pos))).to(dev)
    got, ref = _crop_both(store, pos, mapix, bounds, L, layout,
                          dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


def test_map_crop_general_channel_count(dev):
    st = synthetic_map_store(num_maps=2, size_px=600, channels=3, seed=5,
                             device=dev)
    rng = np.random.default_rng(2)
    pos = torch.from_numpy(_poses(rng, 8, 30.0, 120.0)).to(dev)
    mapix = torch.from_numpy(rng.integers(0, 2, 8)).to(dev)
    for layout in ("nhwc", "nchw"):
        for dtype in (torch.float32, torch.bfloat16):
            got, ref = _crop_both(st, pos, mapix, DEFAULT_BOUNDS, 256,
                                  layout, dtype=dtype)
            assert torch.equal(got, ref)


def test_map_crop_refuses_other_output_types(dev, store):
    rng = np.random.default_rng(6)
    pos = torch.from_numpy(_poses(rng, 2, 150.0, 360.0)).to(dev)
    mapix = torch.zeros(2, dtype=torch.long, device=dev)
    lo, wo = queries.crop_offsets(DEFAULT_BOUNDS, 64, 64, dev)
    with pytest.raises(ValueError):
        crop_kernel.map_crop(store.packed, store.dx, pos, mapix, lo, wo, 4,
                             "nhwc", torch.float16)


@pytest.mark.parametrize("P,lw_hi,unit_h,size_px", [
    (1152, 10.0, True, 2048),  # the main path's shape
    (48, 6.0, False, 2048),    # un-normalized headings (|h| ~ 300)
    (36, 18.0, True, 600),     # large trucks, 600 px maps
    (6, 45.0, True, 2048),     # footprints larger than any TPU window
])
def test_footprint_matches_plain(dev, P, lw_hi, unit_h, size_px):
    st = synthetic_map_store(num_maps=2, size_px=size_px, channels=3,
                             seed=11, device=dev)
    rng = np.random.default_rng(3)
    extent = size_px * 0.25
    cars = torch.from_numpy(
        _poses(rng, P, -0.1 * extent, 1.1 * extent, unit=unit_h)).to(dev)
    lw = torch.from_numpy(np.stack([rng.uniform(3, lw_hi, P),
                                    rng.uniform(1.5, 3, P)], 1)
                          .astype(np.float32)).to(dev)
    mapix = torch.from_numpy(rng.integers(0, 2, P)).to(dev)
    lin_l = queries.linspace(-1.0, 1.0, 39, dev)
    lin_w = queries.linspace(-1.0, 1.0, 16, dev)
    args = (st.packed, st.dx, cars, lw, mapix, lin_l, lin_w, 0)
    got = crop_kernel.footprint_coll_point(*args)
    ref = crop_kernel.footprint_coll_point_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1])  # valid
    assert torch.equal(got[2], ref[2])  # frac
    scale = float((cars[:, :2].abs().amax() + lw.amax() * cars[:, 2:].abs().amax()))
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("case", ["grid_7x5", "grid_64x40", "off_map",
                                  "on_road", "one_car"])
def test_footprint_edge_cases_match_plain(dev, store, case):
    """Grids that are no multiple of the block's threads, cars wholly off
    the map or wholly on drivable ground, and P = 1."""
    c = kc.coll_point_cases(2048)[case]
    args = kc.coll_point_args(store, c, dev)
    kc.coll_point_error(args)
    valid, frac = crop_kernel.footprint_coll_point(*args)[1:]
    if case in ("off_map", "on_road"):
        assert not valid.any()
    if case == "on_road":
        assert not frac.any()


def test_footprint_main_path_matches_plain(dev):
    """The 1152 interpolated poses the main path gives K2."""
    _, args = kc.main_path_k2(dev)
    assert args[2].shape == (1152, 4)
    kc.coll_point_error(args)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_map_crop_sampling_shape_matches_plain(dev, layout):
    """K1 at prior sampling's shape: 1 scene x 20 samples x 16 agents =
    320 poses of 256 px in one launch, on the full-width store."""
    args = kc.sampling_crop_args(dev)
    assert args[2].shape == (320, 4)
    args = (*args[:-1], layout)
    got = crop_kernel.map_crop(*args)
    ref = crop_kernel.map_crop_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_footprint_solution_shape_matches_plain(dev):
    """K2 at the solution loss's shape: one car a scene, B=4, its 16 poses
    interpolated x3 (192 cars)."""
    _, args = kc.solution_k2(dev)
    assert args[2].shape == (192, 4)
    kc.coll_point_error(args)


@pytest.mark.parametrize("B", [8, 10])
def test_map_crop_decode_step_matches_plain(dev, B):
    """K1 at a decode step of training (B=8 x 16 agents = 128 poses) and
    of refine (B=10: 160 poses), 256 px, on the full-width store."""
    args = kc.decode_crop_args(dev, B)
    assert args[2].shape == (16 * B, 4)
    got = crop_kernel.map_crop(*args)
    ref = crop_kernel.map_crop_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_footprint_refine_and_training_shapes_match_plain(dev):
    """K2 at the refine loss's shape (B=10 x 16 agents x 48 interpolated
    poses = 7,680 cars) and the training loss's (the ego's 12 poses x B=8
    = 96 cars)."""
    _, args = kc.refine_k2(dev)
    assert args[2].shape == (7680, 4)
    kc.coll_point_error(args)
    _, args = kc.training_k2(dev)
    assert args[2].shape == (96, 4)
    kc.coll_point_error(args)


@pytest.fixture(scope="module")
def nusc(dev):
    """The four nuScenes maps at their extents, 4 px/m (3.05 GB raster on
    the card), and K1's (both layouts) and K2's arguments over the poses
    of ``kernel_cases.nusc_pose_cases``."""
    store = kc.nusc_store(dev)
    cases = kc.nusc_pose_cases(store)
    return store, kc.nusc_kernel_args(store, cases)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_map_crop_nusc_store_matches_plain(nusc, layout):
    """K1 bit-exact on the nuScenes-extent store: per-map dx that is not
    0.25 (the division x / dx at non-dyadic dx), poses at the true edges,
    in the zero padding of the smaller maps, off the stack, on the
    flipped Singapore maps."""
    store, (k1_nhwc, k1_nchw, _) = nusc
    args = k1_nhwc if layout == "nhwc" else k1_nchw
    got, ref = crop_kernel.map_crop(*args), crop_kernel.map_crop_plain(*args)
    bf = crop_kernel.map_crop(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(bf, crop_kernel.map_crop_plain(*args, torch.bfloat16))
    assert float(ref.sum()) > 0


def test_footprint_nusc_store_matches_plain(nusc):
    _, (_, _, k2) = nusc
    kc.coll_point_error(k2)


K1_EDGE_CASES = kc.crop_edge_cases()


@pytest.fixture(scope="module")
def edge_raster(dev):
    return kc.crop_edge_raster(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("case", list(K1_EDGE_CASES))
def test_map_crop_edge_cases_match_plain(edge_raster, case, layout, dtype):
    """K1 on ``kernel_cases.crop_edge_cases``: samples on rounding ties and
    at the extents' edges, non-unit, zero and infinite headings, NaN and
    infinite positions, C in {1, 3, 4, 5, 8}, crops wider than a block, and
    70,000 crops of 8 x 8 (more poses than a grid's y dimension holds)."""
    dev = edge_raster[0].device
    args = kc.crop_edge_args(edge_raster, K1_EDGE_CASES[case], layout, dev)
    got = crop_kernel.map_crop(*args, dtype)
    want = crop_kernel.map_crop_plain(*args, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("d", sorted(
    {0.25, 0.5, 0.1} | set(kc.nusc_dx().reshape(-1).tolist())))
def test_quotient_sweep_finds_no_mismatch(dev, d):
    """K1's division against the IEEE quotient on every float32 g whose
    quotient lies in [-2, 14,749] pixels (nuScenes' widest raster + 1):
    the edge raster's dx, 0.1 and the nuScenes store's."""
    assert crop_kernel.quotient_mismatches(d, -2, 14749, dev)[0] == 0


def test_cuda_dispatch_launches_the_kernels(dev, store):
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(_poses(rng, 4, 150.0, 360.0)).to(dev)
    mapix = torch.zeros(4, dtype=torch.long, device=dev)
    before = dict(crop_kernel.LAUNCHES)
    crop = queries.get_map_crop(store.packed, store.dx, pos, mapix,
                                DEFAULT_BOUNDS, store.C, layout="nhwc",
                                dtype=torch.bfloat16)
    queries.get_coll_point(store.packed, store.dx, pos,
                           torch.full((4, 2), 3.0, device=dev), mapix)
    assert crop_kernel.LAUNCHES["map_crop"] == before["map_crop"] + 1
    assert (crop_kernel.LAUNCHES["footprint_coll_point"]
            == before["footprint_coll_point"] + 1)
    assert crop.shape == (4, 256, 256, 4) and crop.dtype == torch.bfloat16
    # no fallback: a CUDA call with a raster the kernel does not take raises
    with pytest.raises(ValueError):
        queries.get_map_crop(store.packed.float(), store.dx, pos, mapix,
                             DEFAULT_BOUNDS, store.C)
