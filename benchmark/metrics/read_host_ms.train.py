"""Host ms of the step's scalars read to the host (``train.read``, each
read a synchronize) a training step (``train.step``), in the profiled
span (``_spans``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.read_ms(run, "train.step", ("train.read",))
