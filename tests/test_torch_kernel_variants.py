"""The launch-shape sweep of ``tools/kernel_variants.py``, on the CPU: each
variant's copy of ``crop.cu`` (K1, K2), ``window.cu`` or ``bisect.cu`` (K5c,
K5d)
differs from the port's source in the constants it names and nowhere else,
so a change to the kernels that the sweep's edits no longer match fails
here, not on the card.
"""

import pytest

from strive_tpu_torch.utils import build
from tools import kernel_variants as kv

SOURCES = kv.variant_sources()
# the lines each kernel's variants may change
CHANGED = {
    "k1": ("constexpr int kThreads", "constexpr int kCols",
           "constexpr int kRows", "constexpr int kQuotientSteps",
           "if (!kFast) return rintf(__fdiv_rn(g, q.d));"),
    "k2": ("constexpr int kFoot",),
    "take": ("constexpr int kTake", "__stcs(p, v);", "return __ldcs(p);"),
    "sums": ("constexpr int kSum", "const uint4 u = ok ? __ldg(",
             "if constexpr (WIDE) {"),
    "onehot": ("constexpr int kOnehotThreads", kv.ONEHOT_STORE),
}


def test_port_variants_are_the_sources():
    assert SOURCES["k1"]["port"] == ("crop",
                                     (build.CSRC / "crop.cu").read_text())
    assert SOURCES["k2"]["port"] == ("crop",
                                     (build.CSRC / "crop.cu").read_text())
    assert SOURCES["take"]["port"] == ("window",
                                       (build.CSRC / "window.cu").read_text())
    assert SOURCES["sums"]["port"] == ("bisect",
                                       (build.CSRC / "bisect.cu").read_text())
    assert len(SOURCES["k1"]) == len(kv.K1_SHAPES) + 2  # + __fdiv_rn
    assert len(SOURCES["k2"]) == len(kv.K2_SHAPES) + 1
    assert len(SOURCES["take"]) == len(kv.TAKE_SHAPES) + 1
    assert len(SOURCES["sums"]) == len(kv.SUMS_SHAPES) + 3
    assert SOURCES["onehot"]["port"] == SOURCES["sums"]["port"]
    assert len(SOURCES["onehot"]) == len(kv.ONEHOT_SHAPES) + 1
    assert set(SOURCES) == set(kv.KERNELS) == set(kv.SOURCES) == set(CHANGED)


@pytest.mark.parametrize("kernel,label", [
    (k, label) for k, group in SOURCES.items() for label in group
    if label != "port"])
def test_variant_changes_its_constants_alone(kernel, label):
    port = SOURCES[kernel]["port"][1].splitlines()
    text = SOURCES[kernel][label][1].splitlines()
    assert len(text) == len(port)
    diff = [(a, b) for a, b in zip(port, text) if a != b]
    for a, _ in diff:
        assert a.strip().startswith(CHANGED[kernel]), a
    if kernel == "take":  # kTakeVec is replaced in every variant
        assert diff
    if kernel == "k1" and label != "threads256_cols1_rows4_steps2":
        assert diff
    if kernel == "sums" and label != "threads64x16_wide512x2":
        assert diff
    if kernel == "onehot":
        assert diff


def test_ptxas_report_keeps_the_kernels_lines():
    out = """ptxas info    : Compiling entry function '_Z15map_crop_kernelILb1EfLi1EEvPKh' for 'sm_90a'
ptxas info    : Function properties for _Z15map_crop_kernelILb1EfLi1EEvPKh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_Z27footprint_coll_point_kernel' for 'sm_90a'
ptxas info    : Used 56 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert kv.ptxas_report(out, "map_crop_kernel") == {
        "_Z15map_crop_kernelILb1EfLi1EEvPKh": [
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "Used 40 registers, used 0 barriers, 412 bytes cmem[0]"]}


def test_patched_needs_each_text_once():
    assert kv.patched("a b c", {"b": "x"}) == "a x c"
    with pytest.raises(ValueError):
        kv.patched("a b c", {"d": "x"})
    with pytest.raises(ValueError):
        kv.patched("a b b", {"b": "x"})
