"""Host ms of the prior's rollout (``model.decode``) an Adam iteration
(``adv.grad``), in the profiled span (``_spans``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.read_ms(run, "adv.grad", ("model.decode",))
