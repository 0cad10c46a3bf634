"""K1's share of its roofline in the profiled span of a training cell, in %
(``_shared.k1_roofline_pct``)."""

from benchmark.metrics import _shared


def read(run):
    return _shared.k1_roofline_pct(run) if "steps" in run.work else None
