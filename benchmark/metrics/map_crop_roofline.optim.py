"""K1's share of its roofline in the profiled span of a adversarial cell, in %
(``_shared.k1_roofline_pct``)."""

from benchmark.metrics import _shared


def read(run):
    return _shared.k1_roofline_pct(run) if "iters" in run.work else None
