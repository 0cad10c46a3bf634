"""Host ms of the backward pull (``train.backward``) a training step
(``train.step``), in the profiled span (``_spans``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.read_ms(run, "train.step", ("train.backward",))
