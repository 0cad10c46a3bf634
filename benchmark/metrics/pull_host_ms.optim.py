"""Host ms of the two autograd pulls (``pull.tgt``, ``pull.adv``) an
Adam iteration (``adv.grad``), in the profiled span (``_spans``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.read_ms(run, "adv.grad", ("pull.tgt", "pull.adv"))
