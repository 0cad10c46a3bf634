"""The port's Mosaic-bisect probes against the TPU bisect scripts, on the CPU.

Each of the 19 ``v_*`` Pallas kernels of ``scripts/probe_mosaic_bisect.py``,
``probe_mosaic_bisect2.py`` and ``probe_mosaic_bisect3.py`` runs in Pallas'
TPU interpret mode on the script's own inputs, and its output (caught at the
``pallas_call``: the scripts of rounds 2 and 3 return only a flag) must equal
the port's counterpart exactly, dtype too. Each K5 plain version is also held
against a jnp oracle on random inputs: ``lax.dynamic_slice`` + ``astype``
(K5b), ``jnp.sum(..., dtype=int32)`` on windows that overflow (K5c), the
Pallas body's bf16 one-hot ``dot_general`` (K5d), and ``x * f`` (K5a).
K5d's launch (channel groups, 4 points a thread, the grid) is held in plain
Python: :func:`kernel_cases.onehot_blocks` splits the work as the kernel's
blocks do, and must write every output once with the plain version's value.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_helpers import n

from strive_tpu_torch import kernel_cases as kc
from strive_tpu_torch.probes import bisect_kernels as bk
from strive_tpu_torch.probes import mosaic_bisect as mb
from strive_tpu_torch.utils import build

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
_SCRIPTS = {}


class _CatchOutput(types.ModuleType):
    """Stands in for a script's ``pl``: every ``pallas_call`` made through
    it keeps its output in ``outs``."""

    def __init__(self, pl):
        super().__init__("pl")
        self._pl = pl
        self.outs = []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        call = self._pl.pallas_call(*args, **kwargs)

        def caught(*operands):
            out = call(*operands)
            self.outs.append(np.asarray(out))
            return out
        return caught


def script(name):
    """A bisect script imported by path (its ``main`` does not run), its
    ``pl`` replaced by a :class:`_CatchOutput`."""
    if name not in _SCRIPTS:
        spec = importlib.util.spec_from_file_location(name,
                                                      SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.pl = _CatchOutput(mod.pl)
        _SCRIPTS[name] = mod
    return _SCRIPTS[name]


def i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


# --- the 19 variants against the Pallas kernels ----------------------------

@pytest.mark.parametrize("name,variant", [(s, v) for s, _, v in mb.VARIANTS],
                         ids=[v.__name__ for _, _, v in mb.VARIANTS])
def test_variant_matches_pallas(name, variant):
    mod = script(name)
    mod.pl.outs.clear()
    with pltpu.force_tpu_interpret_mode():
        flag = getattr(mod, variant.__name__)()
    want, = mod.pl.outs
    if isinstance(flag, list):  # the script's own check
        assert flag == [True]
    got, script_want = mb.output(variant, "cpu")
    assert n(got).dtype == want.dtype
    np.testing.assert_array_equal(n(got), want)
    if script_want is not None:
        assert script_want.dtype == got.dtype
        np.testing.assert_array_equal(n(script_want), want)


def test_overflowing_sums_wrap_like_pallas():
    """The trap of ``v_prefetch_indexmap``: block (7, 0) sums past 2^31, and
    the plain version must wrap as the int32 Pallas sum does."""
    got, _ = mb.output(mb.v_prefetch_indexmap, "cpu")
    assert int(got[2]) == 4022857728 - 2 ** 32


# --- plain versions against jnp oracles -------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scale_rows_matches_x_times_f(dtype):
    rng = np.random.default_rng(1)
    R, C, G = 12, 40, 3
    if dtype == np.float32:
        x = rng.standard_normal((R, C)).astype(dtype)
        f = rng.standard_normal(R // G).astype(dtype)
    else:
        x = rng.integers(-2 ** 31, 2 ** 31, (R, C)).astype(dtype)
        f = rng.integers(-2 ** 31, 2 ** 31, R // G).astype(dtype)
    want = jnp.asarray(x) * jnp.repeat(jnp.asarray(f), G)[:, None]
    got = bk.scale(torch.from_numpy(x), torch.from_numpy(f), G)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("src,out", [(np.uint8, np.int32),
                                     (np.uint8, np.float32),
                                     (np.float32, np.float32)])
def test_window_convert_matches_dynamic_slice(src, out):
    """Starts that wrap or clamp as ``lax.dynamic_slice`` takes them; both
    output layouts."""
    rng = np.random.default_rng(2)
    R, C, WR, WC = 40, 56, 16, 24
    x = (rng.integers(0, 256, (R, C)) if src == np.uint8
         else rng.standard_normal((R, C))).astype(src)
    row0 = np.array([0, R - WR, R - 3, -4, 200, 7], dtype=np.int32)
    col0 = np.array([C - WC, -7, 5, C + 9, 11, 1], dtype=np.int32)
    want = jax.vmap(lambda r, c: jax.lax.dynamic_slice(
        jnp.asarray(x), (r, c), (WR, WC)).astype(out))(row0, col0)
    dtype = torch.from_numpy(np.zeros(0, out)).dtype
    got = bk.convert(torch.from_numpy(x), i32(row0), i32(col0), WR, WC, dtype)
    assert n(got).dtype == out
    np.testing.assert_array_equal(n(got), np.asarray(want))
    side = bk.convert(torch.from_numpy(x), i32(row0), i32(col0), WR, WC, dtype,
                      side_by_side=True)
    np.testing.assert_array_equal(
        n(side), np.concatenate(list(np.asarray(want)), axis=1))


@pytest.mark.parametrize("case", list(kc.sums_cases()))
def test_window_sums_match_jnp_int32_sum(case):
    """Signed sums of K windows per output on K5c's shared edge cases
    (``kernel_cases.sums_cases``: every start residue, narrow and whole
    windows, one row and every row, each load path); the int32 windows
    overflow both ways and wrap as ``jnp.sum(..., dtype=int32)`` wraps."""
    x, row0, col0, sign, WR, WC = kc.sums_cases()[case]

    def one(rows, cols):
        wins = jax.vmap(lambda r, c: jnp.sum(jax.lax.dynamic_slice(
            jnp.asarray(x), (r, c), (WR, WC)), dtype=jnp.int32))(rows, cols)
        return jnp.sum(wins * jnp.asarray(sign), dtype=jnp.int32)

    want = np.asarray(jax.vmap(one)(row0, col0))
    got = bk.sums(*kc.sums_args((x, row0, col0, sign, WR, WC), "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), want)
    if case in ("int32", "wrap_C333"):
        assert (want < 0).any() and (want > 0).any()


def test_onehot_rows_matches_onehot_dot_general():
    """The Pallas body of ``v_iota_compare_matmul`` on byte-valued w, with
    indices below 0 and at or above R (an all-zero one-hot column)."""
    rng = np.random.default_rng(4)
    T, R, C, P = 3, 64, 192, 300
    w = rng.integers(0, 256, (T, R, C)).astype(np.float32)
    idx = rng.integers(-3, R + 3, (T, P)).astype(np.int32)
    idx[:, :4] = [-1, 0, R - 1, R]

    def body(w_t, idx_t):
        iota = jax.lax.broadcasted_iota(jnp.int32, (R, P), 0)
        onehot = (iota == idx_t[None, :]).astype(jnp.bfloat16)
        return jax.lax.dot_general(w_t, onehot, (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(jax.vmap(body)(wb, jnp.asarray(idx)))
    got = bk.onehot(torch.from_numpy(w).to(torch.bfloat16), i32(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), want)


# --- K5d's launch -------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("name", list(kc.onehot_cases()))
def test_onehot_blocks_write_the_plain_version_once(name, sms):
    """Every edge case of ``kernel_cases.onehot_cases`` split as K5d's
    blocks split it on a card of ``sms`` SMs: each output written once,
    equal to the plain version."""
    case = kc.onehot_cases()[name]
    w, idx = kc.onehot_args(case, "cpu")
    (T, R, C), P = w.shape, idx.shape[1]
    launch = bk.onehot_launch(T, R, C, P, sms)
    # the kernel's 16-byte path: P % 4 == 0, idx (and out) on 16 bytes
    vec = P % 4 == 0 and idx.data_ptr() % 16 == 0
    got, writes = kc.onehot_blocks(w.float().numpy(), idx.numpy(), launch,
                                   vec)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, n(bk.onehot_rows_plain(w, idx)))


@pytest.mark.parametrize("cg", [1, 5, 64, 191, 192])
def test_onehot_blocks_at_a_given_group(cg):
    """Groups set by hand, as ``tools/kernel_variants.py`` sweeps them: one
    that does not divide C, one channel short of C, all of C; a tail of 3
    points."""
    case = kc.onehot_cases()["T5_P1000"]
    w, idx = kc.onehot_args(case, "cpu")
    w, idx = w[:2], idx[:2, :103]
    launch = bk.onehot_launch(2, 64, 192, 103, 132, cg)
    assert launch["grid"] == (2, 1, -(-192 // cg))
    got, writes = kc.onehot_blocks(w.float().numpy(), idx.numpy(), launch,
                                   False)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, n(bk.onehot_rows_plain(w, idx)))


def test_onehot_launch_fills_the_card():
    """One channel a block at the bisect scripts' shape (192 blocks on 132
    SMs), every channel at the gather-probe path's 2048 tiles; groups that
    do not divide C; T on grid x past 65,535."""
    assert bk.onehot_launch(1, 64, 192, 1024, 132) == {
        "cg": 1, "grid": (1, 1, 192), "pitch": 2, "smem": 256}
    assert bk.onehot_launch(2048, 64, 192, 1024, 132) == {
        "cg": 192, "grid": (2048, 1, 1), "pitch": 194, "smem": 64 * 194 * 2}
    assert bk.onehot_launch(5, 64, 192, 1000, 132)["grid"] == (5, 1, 28)
    assert bk.onehot_launch(2, 64, 50, 4099, 132)["grid"] == (2, 5, 17)
    assert bk.onehot_launch(70000, 3, 5, 6, 132)["grid"] == (70000, 1, 1)
    # a w[t] past 48 KB: one channel a block, shared memory opted into
    assert bk.onehot_launch(1, 20000, 4, 8, 132)["smem"] == 80000
    for T, R, C, P in ((1, 64, 192, 1024), (9, 64, 192, 5000),
                       (2048, 64, 192, 1024), (3, 200, 700, 77)):
        got = bk.onehot_launch(T, R, C, P, 132)
        blocks = got["grid"][0] * got["grid"][1] * got["grid"][2]
        assert blocks >= min(132, T * got["grid"][1] * C)
        assert got["smem"] <= 48 * 1024


def test_onehot_launch_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError, match="grid"):
        bk.onehot_launch(1, 64, 192, 65536 * 1024, 132)
    with pytest.raises(ValueError, match="shared memory"):
        bk.onehot_launch(1, 60000, 4, 8, 132)
    for cg in (0, 193):
        with pytest.raises(ValueError, match="channels a block"):
            bk.onehot_launch(1, 64, 192, 8, 132, cg)


def test_onehot_smem_pitch_is_an_odd_number_of_words():
    assert [bk._smem_pitch(c) for c in (1, 2, 3, 4, 7, 192)] == [
        2, 2, 6, 6, 10, 194]
    assert all(bk._smem_pitch(c) // 2 % 2 == 1 for c in range(1, 300))


# --- dispatch ---------------------------------------------------------------

def test_cpu_calls_launch_nothing():
    """CPU tensors take the plain versions: no launch, no build."""
    before, libs = dict(bk.LAUNCHES), dict(build._LIBS)
    for _, _, variant in mb.VARIANTS:
        mb.output(variant, "cpu")
    assert bk.LAUNCHES == before
    assert build._LIBS == libs


@pytest.mark.parametrize("name", ["scale_rows", "window_convert",
                                  "window_sums", "onehot_rows"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches its kernel or raises; it never computes on the
    CPU, and refuses before it builds anything."""
    libs = dict(build._LIBS)
    z = i32([0])
    args = {"scale_rows": (torch.ones((8, 8)), torch.ones(1), 8),
            "window_convert": (torch.zeros((8, 8), dtype=torch.uint8), z, z,
                               4, 4, torch.int32),
            "window_sums": (torch.zeros((8, 8), dtype=torch.uint8), z[None],
                            z[None], z, 4, 4),
            "onehot_rows": (torch.zeros((1, 8, 8), dtype=torch.bfloat16),
                            z[None])}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(bk, name)(*args)
    assert build._LIBS == libs


def test_mosaic_bisect_run_on_cpu(monkeypatch):
    monkeypatch.setattr(mb, "REPS", 1)
    before = dict(bk.LAUNCHES)
    res = mb.run("cpu")
    assert res["device"] == "cpu" and bk.LAUNCHES == before
    assert [v["name"] for v in res["variants"]] == [
        v.__name__ for _, _, v in mb.VARIANTS]
    assert all(v["correct"] and v["ms"] > 0 for v in res["variants"])
    assert len(res["lines"]) == 19
    assert all(line.startswith("PASS  ") for line in res["lines"])
