"""Host time a unit of work of the program's own spans
(``strive_tpu_torch.utils.spans``), for the readers of the metrics that
take one phase of an Adam iteration or a training step.

The units are the recorded spans named ``unit`` (``adv.grad``,
``train.step``) of the traced run's profiled span; a phase's value is the
summed duration of its recorded spans with a recorded unit among their
ancestors, over the number of units. The spans are recorded only while
the profiler records, so they carry its cost: compare these numbers
between two versions of the program, never with the window's rates. A
program without the spans, or a run without a unit, reads nothing.
"""

from __future__ import annotations


def _under(records, unit):
    """Indices of the records with a record named ``unit`` above them."""
    out = set()
    for i, r in enumerate(records):
        p = r.parent
        while p is not None:
            if records[p].name == unit:
                out.add(i)
                break
            p = records[p].parent
    return out


def units(records, unit):
    return sum(r.name == unit for r in records)


def per_unit_ms(records, unit, phases):
    """ms a unit of the spans named in ``phases``; None without a unit."""
    n = units(records, unit)
    if not n:
        return None
    inside = _under(records, unit)
    ns = sum(r.end_ns - r.start_ns for i, r in enumerate(records)
             if i in inside and r.name in phases)
    return ns * 1e-6 / n


def read_ms(run, unit, phases):
    """:func:`per_unit_ms` of the program's records in a traced run."""
    if getattr(run, "profile", None) is None:
        return None
    try:
        from strive_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    return per_unit_ms(spans.records(), unit, phases)
