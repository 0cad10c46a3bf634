"""Host ms of Adam's update of every parameter and its copy back
(``train.adam``) a training step (``train.step``), in the profiled span
(``_spans``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.read_ms(run, "train.step", ("train.adam",))
