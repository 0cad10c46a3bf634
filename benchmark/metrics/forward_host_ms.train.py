"""Host ms of the model's forward pass (``train.forward``: the encoders
and both rollouts) a training step (``train.step``), in the profiled
span (``_spans``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.read_ms(run, "train.step", ("train.forward",))
