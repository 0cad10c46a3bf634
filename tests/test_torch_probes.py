"""The port's gather probes against the TPU probe scripts, on the CPU.

K3's plain version is held against both Pallas ``crop_onehot`` kernels
(``scripts/probe_onehot_crop.py``, ``probe_onehot_crop2.py``) run in Pallas'
TPU interpret mode, and the port's whole ``kernel_crop`` against the
quadrant script's. K4's plain versions are held against the scripts'
oracles (vmapped ``jnp.take(mode="clip")`` and ``lax.dynamic_slice``), whose
Pallas kernels are nested inside the scripts' ``main``. Every comparison is
exact: these are integer gathers and copies.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_helpers import n

from strive_tpu_torch.probes import gather
from strive_tpu_torch.probes import onehot_crop as oc
from strive_tpu_torch.probes import window_kernels as wk
from strive_tpu_torch.utils import build

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
_SCRIPTS = {}


def script(name):
    """A probe script imported by path (its ``main`` does not run)."""
    if name not in _SCRIPTS:
        spec = importlib.util.spec_from_file_location(name,
                                                      SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _SCRIPTS[name] = mod
    return _SCRIPTS[name]


def i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


def _raster(rng, R, Wp):
    return rng.integers(0, 256, (R, Wp)).astype(np.uint8)


# --- K3 -------------------------------------------------------------------

@pytest.mark.parametrize("T,col0", [(2, [[0, 128], [192, 64]]),
                                    (4, [[0, 192, 128, 16],
                                         [176, 0, 64, 192]])])
def test_window_crop_tiles_matches_pallas_dma(T, col0):
    """probe_onehot_crop.crop_onehot: a 64x192 window at (row0, col0)."""
    rng = np.random.default_rng(T)
    N, (WR, WC) = 2, oc.WINDOWS["dma"]
    flat = _raster(rng, 512, 384)
    row0 = rng.integers(0, 512 - WR, (N, T)).astype(np.int32)
    col0 = np.asarray(col0, dtype=np.int32)
    ly = rng.integers(0, WR, (N, T, 1, oc.PTS)).astype(np.int32)
    lx = rng.integers(0, WC, (N, T, 1, oc.PTS)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = script("probe_onehot_crop").crop_onehot(
            jnp.asarray(flat), jnp.asarray(ly), jnp.asarray(lx),
            jnp.asarray(row0), jnp.asarray(col0))
    got = wk.crop_tiles(torch.from_numpy(flat), i32(row0), i32(col0),
                        i32(ly[:, :, 0]), i32(lx[:, :, 0]), WR, WC)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), np.asarray(want)[:, :, 0])


@pytest.mark.parametrize("T", [2, 3])
def test_window_crop_tiles_matches_pallas_quadrant(T):
    """probe_onehot_crop2.crop_onehot: 2x2 blocks of 64x128 at (rb, cb)."""
    rng = np.random.default_rng(10 + T)
    N, (WR, WC), (br, bc) = 2, oc.WINDOWS["quadrant"], oc.BLOCK
    flat = _raster(rng, 512, 384)
    rb = rng.integers(0, 512 // br - 1, (N, T)).astype(np.int32)
    cb = rng.integers(0, 384 // bc - 1, (N, T)).astype(np.int32)
    ly = rng.integers(0, WR, (N, T, 1, oc.PTS)).astype(np.int32)
    lx = rng.integers(0, WC, (N, T, 1, oc.PTS)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = script("probe_onehot_crop2").crop_onehot(
            jnp.asarray(flat), jnp.asarray(ly), jnp.asarray(lx),
            jnp.asarray(rb), jnp.asarray(cb))
    got = wk.crop_tiles(torch.from_numpy(flat), i32(rb * br), i32(cb * bc),
                        i32(ly[:, :, 0]), i32(lx[:, :, 0]), WR, WC)
    np.testing.assert_array_equal(n(got), np.asarray(want)[:, :, 0])


def test_window_crop_tiles_clamps_like_dynamic_slice():
    """Origins outside the raster and indices outside the window clamp as
    ``lax.dynamic_slice`` and ``mode="clip"`` clamp them."""
    rng = np.random.default_rng(5)
    R, Wp, WR, WC = 200, 272, 64, 192
    flat = _raster(rng, R, Wp)
    row0 = np.array([[-9, R - 10], [R - WR, 3]], dtype=np.int32)
    col0 = np.array([[Wp, -40], [Wp - WC - 5, 33]], dtype=np.int32)
    ly = rng.integers(-5, WR + 5, (2, 2, 300)).astype(np.int32)
    lx = rng.integers(-5, WC + 5, (2, 2, 300)).astype(np.int32)

    def one(r0, c0, y, x):
        win = jax.lax.dynamic_slice(jnp.asarray(flat), (r0, c0), (WR, WC))
        return win[jnp.clip(y, 0, WR - 1), jnp.clip(x, 0, WC - 1)]

    want = jax.vmap(jax.vmap(one))(row0, col0, ly, lx)
    got = wk.crop_tiles(torch.from_numpy(flat), i32(row0), i32(col0), i32(ly),
                        i32(lx), WR, WC)
    np.testing.assert_array_equal(n(got), np.asarray(want).astype(np.float32))


def test_tileize_matches_script():
    rng = np.random.default_rng(6)
    N, L, W = 2, 64, 96
    a = rng.integers(0, 1000, (N, L, W)).astype(np.int32)
    p1 = script("probe_onehot_crop")
    want = np.asarray(p1.tileize(jnp.asarray(a), N, L, W))[:, :, 0]
    got = oc.tileize(torch.from_numpy(a), N, L, W)
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(oc.untileize(got, N, L, W)), a)
    np.testing.assert_array_equal(
        np.asarray(p1.untileize(jnp.asarray(want), N, L, W)), a)


def _crop_inputs(seed, M=2, H=256, Wp=384, N=2, L=64):
    """Small crops whose centers leave the map on every side."""
    packed, py, px, outside, mapix = oc.synthetic_crop(
        M, H, Wp, N, L, L, cx=(-30, Wp + 30), cy=(-30, H + 30), seed=seed)
    assert outside.any() and not outside.all()
    return packed.reshape(M * H, Wp), py, px, outside, mapix


@pytest.mark.parametrize("seed", [1, 4])
def test_kernel_crop_quadrant_matches_script(seed):
    """The whole crop against probe_onehot_crop2.kernel_crop (interpret
    mode): window origins, clamps, untileize, off-map fix-up."""
    flat, py, px, outside, mapix = _crop_inputs(seed)
    dims = dict(H=256, Wp=384, N=2, L=64, W=64)
    with pltpu.force_tpu_interpret_mode():
        want = script("probe_onehot_crop2").kernel_crop(
            *map(jnp.asarray, (flat, py, px, mapix, outside)), **dims)
    got = oc.kernel_crop(*map(torch.from_numpy,
                              (flat, py, px, mapix, outside)),
                         **dims, window="quadrant")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("seed,H,Wp,L", [(2, 256, 384, 64),
                                         (3, 320, 512, 96)])
@pytest.mark.parametrize("window", ["dma", "quadrant"])
def test_kernel_crop_matches_xla_path(seed, H, Wp, L, window):
    """Both window geometries against the scripts' ``xla_path``
    (probe_onehot_crop.py:162-165), and the port's direct path too."""
    flat, py, px, outside, mapix = _crop_inputs(seed, H=H, Wp=Wp, L=L)
    base = jnp.asarray(mapix)[:, None, None] * (H * Wp)
    want = np.asarray(jnp.take(jnp.asarray(flat).reshape(-1),
                               base + jnp.asarray(py) * Wp + jnp.asarray(px),
                               mode="clip"))
    t = [torch.from_numpy(a) for a in (flat, py, px, mapix, outside)]
    got = oc.kernel_crop(*t, H=H, Wp=Wp, N=2, L=L, W=L, window=window)
    np.testing.assert_array_equal(n(got), want.astype(np.int32))
    np.testing.assert_array_equal(n(oc.direct_path(*t[:4], H, Wp)), want)


# --- K4 -------------------------------------------------------------------

_TAKE_SHAPES = [(3, 9, 11), (1, 1, 1), (1, 1, 3), (1, 1, 5), (1, 7, 143)]


@pytest.mark.parametrize("dtype,shape", [
    pytest.param(d, s, id=d.__name__ + ("" if s == _TAKE_SHAPES[0] else
                                        f"-N{s[0]}-Q{s[1] * s[2]}"))
    for s in _TAKE_SHAPES for d in (np.uint8, np.int32)])
def test_window_take_matches_jnp_take_clip(dtype, shape):
    """pallas_gather_probe.py:69-71, indices out of range on both sides; one
    window with Q in {1, 3, 5, 1001} (rows shorter than a vector, or not a
    whole number of vectors)."""
    rng = np.random.default_rng(7)
    N, WIN = shape[0], 20
    wins = rng.integers(0, 256, (N, WIN, WIN)).astype(dtype)
    idx = rng.integers(-60, WIN * WIN + 60, shape).astype(np.int32)
    ends = [-1, 0, WIN * WIN - 1, WIN * WIN][:shape[2]]
    idx[:, 0, :len(ends)] = ends
    want = jax.vmap(lambda w, i: jnp.take(w.reshape(-1), i, mode="clip"))(
        jnp.asarray(wins), jnp.asarray(idx))
    got = wk.take(torch.from_numpy(wins.reshape(N, -1)),
                  i32(idx.reshape(N, -1)))
    assert got.dtype == torch.from_numpy(wins).dtype
    np.testing.assert_array_equal(n(got).reshape(idx.shape), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("layout", ["maps", "flat"])
def test_window_extract_matches_dynamic_slice(layout, dtype):
    """pallas_gather_probe2.py:47-50 (windows of raster[m]) and
    pallas_gather_probe3.py:105-106 (of the flat raster), with starts that
    clamp."""
    rng = np.random.default_rng(8)
    M, H, Wp, N, WIN = 2, 40, 48, 6, 16
    raster = rng.integers(0, 256, (M, H, Wp)).astype(dtype)
    y0 = np.array([0, 5, H - WIN, H - 3, -4, 30], dtype=np.int32)
    x0 = np.array([Wp - WIN, -7, 3, Wp + 9, 11, 0], dtype=np.int32)
    mapix = np.array([0, 1, 1, 0, 1, 1], dtype=np.int32)
    flat = torch.from_numpy(raster.reshape(M * H, Wp))
    if layout == "maps":
        want = jax.vmap(lambda m, yy, xx: jax.lax.dynamic_slice(
            jnp.asarray(raster)[m], (yy, xx), (WIN, WIN)))(mapix, y0, x0)
        row0, col0 = gather.map_origins(i32(mapix), i32(y0), i32(x0), H, WIN)
    else:
        want = jax.vmap(lambda m, yy, xx: jax.lax.dynamic_slice(
            jnp.asarray(raster).reshape(M * H, Wp), (m * H + yy, xx),
            (WIN, WIN)))(mapix, y0, x0)
        row0, col0 = i32(mapix * H + y0), i32(x0)
    got = wk.extract(flat, row0, col0, WIN)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_fused_extract_take_matches_oracle():
    """pallas_gather_probe2.py:109-114: take from the extracted windows."""
    rng = np.random.default_rng(9)
    M, H, Wp, N, WIN = 2, 48, 40, 4, 24
    raster = rng.integers(0, 16, (M, H, Wp)).astype(np.int32)
    y0 = rng.integers(0, H - WIN, N).astype(np.int32)
    x0 = rng.integers(0, Wp - WIN, N).astype(np.int32)
    mapix = rng.integers(0, M, N).astype(np.int32)
    lidx = rng.integers(0, WIN * WIN, (N, 8, 8)).astype(np.int32)
    wins = jax.vmap(lambda m, yy, xx: jax.lax.dynamic_slice(
        jnp.asarray(raster)[m], (yy, xx), (WIN, WIN)))(mapix, y0, x0)
    want = jax.vmap(lambda w, i: jnp.take(w.reshape(-1), i, mode="clip"))(
        wins, jnp.asarray(lidx))
    row0, col0 = gather.map_origins(i32(mapix), i32(y0), i32(x0), H, WIN)
    got = wk.take(wk.extract(torch.from_numpy(raster.reshape(M * H, Wp)),
                             row0, col0, WIN).reshape(N, -1),
                  i32(lidx.reshape(N, -1)))
    np.testing.assert_array_equal(n(got).reshape(lidx.shape),
                                  np.asarray(want))


# --- dispatch ---------------------------------------------------------------

def test_cpu_calls_launch_nothing():
    """CPU tensors take the plain versions: no launch, no build."""
    before, libs = dict(wk.LAUNCHES), dict(build._LIBS)
    flat, py, px, outside, mapix = map(torch.from_numpy, _crop_inputs(1))
    dims = dict(H=256, Wp=384, N=2, L=64, W=64)
    for window in oc.WINDOWS:
        oc.kernel_crop(flat, py, px, mapix, outside, **dims, window=window)
    oc.direct_path(flat, py, px, mapix, 256, 384)
    wk.extract(flat, i32([0, 9]), i32([5, 0]), 32)
    assert wk.LAUNCHES == before
    assert build._LIBS == libs


@pytest.mark.parametrize("name", ["window_crop_tiles", "window_extract",
                                  "window_take"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches its kernel or raises; it never computes on the
    CPU, and refuses before it builds anything."""
    libs = dict(build._LIBS)
    flat = torch.zeros((64, 256), dtype=torch.uint8)
    args = {"window_crop_tiles": (flat, i32([[0]]), i32([[0]]),
                                  i32([[[0]]]), i32([[[0]]]), 64, 192),
            "window_extract": (flat, i32([0]), i32([0]), 32),
            "window_take": (flat, i32(np.zeros((64, 3))))}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(wk, name)(*args)
    assert build._LIBS == libs


def test_onehot_crop_run_on_cpu(monkeypatch):
    small = {w: dict(M=2, H=256, Wp=384, N=2, L=64, W=64, cx=(-30, 414),
                     cy=(-30, 286)) for w in oc.WINDOWS}
    monkeypatch.setattr(oc, "PROBES", small)
    monkeypatch.setattr(oc, "REPS", 1)
    before = dict(wk.LAUNCHES)
    res = oc.run("cpu")
    assert res["device"] == "cpu" and wk.LAUNCHES == before
    for w in oc.WINDOWS:
        assert res[w]["bit_exact"] and res[w]["elements"] == 2 * 64 * 64
        assert res[w]["k3_ms"] > 0
    assert len(oc.format_lines(res)) == 10


def test_gather_run_on_cpu(monkeypatch):
    small = dict(N=3, L=16, W=16, M=2, H=96, Wp=80, take_wins=(32,),
                 take_wins3=(32, 36, 40), extract_win3=32, extract_win2=40)
    monkeypatch.setattr(gather, "SIZES", small)
    monkeypatch.setattr(gather, "REPS", 1)
    before = dict(wk.LAUNCHES)
    res = gather.run("cpu")
    assert res["device"] == "cpu" and wk.LAUNCHES == before
    assert len(res["steps"]) == 11 and all(s["correct"] for s in res["steps"])
    assert len(res["lines"]) == 11
