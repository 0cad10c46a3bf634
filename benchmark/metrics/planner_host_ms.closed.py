"""Host ms of the planner's call (``planner.rollout``) an Adam iteration
(``adv.grad``), in the profiled span (``_spans``); nothing where the
program names no such span."""

from benchmark.metrics import _spans


def read(run):
    if getattr(run, "profile", None) is None:
        return None
    try:
        from strive_tpu_torch.utils import spans
    except ImportError:
        return None
    if not any(r.name == "planner.rollout" for r in spans.records()):
        return None
    return _spans.read_ms(run, "adv.grad", ("planner.rollout",))
