"""The card's idle share of the profiled span of a training cell, in %
(``_shared.device_idle_pct``)."""

from benchmark.metrics import _shared


def read(run):
    return _shared.device_idle_pct(run) if "steps" in run.work else None
