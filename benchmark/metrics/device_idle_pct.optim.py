"""The card's idle share of the profiled span of a adversarial cell, in %
(``_shared.device_idle_pct``)."""

from benchmark.metrics import _shared


def read(run):
    return _shared.device_idle_pct(run) if "iters" in run.work else None
