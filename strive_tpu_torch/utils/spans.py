"""Named spans at the port's layer boundaries, on the profiler's clock.

    with span("decode.gnn"):
        dec_out = self.decoder_net(...)

A span costs one check while no ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``): :func:`span` then hands back one
shared context that does nothing. While a profiler records, the span is a
``torch.profiler.record_function`` (so it sits in the profiler's trace
beside the kernels it launches) and, when it ends, one :class:`Record`
is kept in memory: its name, its start and end on the clock of the
trace's events (``time.time_ns``, the epoch clock of
``_KinetoEvent.start_ns``), the index of the innermost recorded span open
on the same thread, and the thread's native id (the id the profiler gives
the thread's events). A span is kept only if the profiler recorded both
at its start and at its end, so a span cut by the profiler's start or
stop leaves no record; its recorded children then point to the innermost
recorded span around them, or to none. Tracing is on exactly while a
profiler records: there is no switch of its own. The profiler's own
export is the exporter; :func:`records` and :func:`clear` read and empty
the list.

:func:`device_by_span` reduces a finished profile to device seconds by
span: each kernel, copy or set goes to the innermost span open on the
thread that launched it, at its launch; one launched by autograd's engine
(the backward pass, on a thread of its own) goes to the span of the
forward operation it differentiates, as ``"<span> (backward)"``.
"""

from __future__ import annotations

import bisect
import itertools
import re
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch

_OFF = nullcontext()
_DONE = []           # the ended _Open spans that were recorded throughout
_SEQ = itertools.count()
_LOCAL = threading.local()  # .stack: the thread's open recorded spans

OUTSIDE = "(outside any span)"
BACKWARD = " (backward)"
_ENGINE = "autograd::engine::evaluate_function"
_CUDA_API = re.compile(r"cuda[A-Z]|cu[A-Z]")  # runtime and driver calls
_NODE = re.compile(r"^autograd::|Backward\d*$")  # backward, not forward, ops


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # index in records() of the recorded span around
    thread: int            # the thread's native id


class _Open:
    """One span while the profiler records: entered with a
    ``record_function``, kept at its end if the profiler still records."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "seq",
                 "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_native_id()
        self.seq = next(_SEQ)
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        self.rf = None  # the profiler's handle, not kept with the record
        _LOCAL.stack.pop()
        if torch.autograd._profiler_enabled():
            _DONE.append(self)
        return False


def span(name):
    """A context naming the work inside it ``name`` in a profile (module
    doc); while no profiler records, a shared context that does nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Open(name)


def records():
    """The kept spans in the order they started (a list of
    :class:`Record`)."""
    done = sorted(_DONE, key=lambda s: s.seq)
    index = {id(s): i for i, s in enumerate(done)}
    out = []
    for s in done:
        p = s.parent
        while p is not None and id(p) not in index:
            p = p.parent
        out.append(Record(s.name, s.start_ns, s.end_ns,
                          None if p is None else index[id(p)], s.thread))
    return out


def clear():
    """Forget the kept spans."""
    _DONE.clear()


# ---- device time by span ---------------------------------------------------

class _Spans:
    """The nested intervals of one thread, for the innermost one open at a
    time: the last to start before it, or the nearest around that one."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (start, -end, key): outer first
        self.starts = [s for s, _, _ in self.spans]
        self.outer = []
        open_ = []
        for i, (s, _, _) in enumerate(self.spans):
            while open_ and -self.spans[open_[-1]][1] < s:
                open_.pop()
            self.outer.append(open_[-1] if open_ else None)
            open_.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if -self.spans[i][1] >= t:
                return self.spans[i][2]
            i = self.outer[i]
        return None


def attribute(spans, ops, launches, device):
    """Device seconds by span, from the events of a profile as plain tuples.

    :param spans: (start_ns, end_ns, thread, name) of each span
    :param ops: (start_ns, end_ns, thread, name, sequence_nr, fwd_thread,
        rf_thread) of each host operation: ``thread`` the native id,
        ``rf_thread`` and ``fwd_thread`` the profiler's own thread ids
    :param launches: {correlation id: (time_ns, thread)} of each launch
    :param device: (duration_ns, correlation id) of each device event
    :return: {span name, ``"<name> (backward)"`` or :data:`OUTSIDE`:
        seconds}
    """
    by_thread = {}
    for s, e, th, name in spans:
        by_thread.setdefault(th, []).append((s, -e, name))
    by_thread = {th: _Spans(v) for th, v in by_thread.items()}
    engine = {}   # thread -> its backward functions, (start, -end, key)
    forward = {}  # (rf_thread, sequence_nr) -> (start, thread) of the op
    for s, e, th, name, seq, fwd, rf in ops:
        if seq < 0:
            continue
        if name.startswith(_ENGINE):
            engine.setdefault(th, []).append((s, -e, (fwd, seq)))
        elif not _NODE.search(name) and (
                (rf, seq) not in forward or s > forward[rf, seq][0]):
            # operations take the number the next autograd node will get:
            # the last to start is the one that made node ``seq``
            forward[rf, seq] = (s, th)
    engine = {th: _Spans(v) for th, v in engine.items()}

    def span_at(t, th):
        found = by_thread.get(th)
        return found.at(t) if found else None

    out = {}
    for dur, corr in device:
        key = OUTSIDE
        if corr in launches:
            t, th = launches[corr]
            name = span_at(t, th)
            if name is not None:
                key = name
            elif th in engine:
                fn = engine[th].at(t)
                if fn in forward:
                    name = span_at(*forward[fn])
                    if name is not None:
                        key = name + BACKWARD
        out[key] = out.get(key, 0.0) + dur * 1e-9
    return out


def device_by_span(prof):
    """Device seconds by span of a finished ``torch.profiler.profile``
    (every user annotation of its trace counts as a span; module doc)."""
    cpu = torch.autograd.DeviceType.CPU
    spans, ops, launches, device = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                device.append((e.duration_ns(), e.linked_correlation_id()))
        elif e.is_user_annotation():
            spans.append((e.start_ns(), e.end_ns(), e.device_resource_id(),
                          e.name()))
        elif _CUDA_API.match(e.name()):
            launches[e.linked_correlation_id() or e.correlation_id()] = (
                e.start_ns(), e.device_resource_id())
        else:
            ops.append((e.start_ns(), e.end_ns(), e.device_resource_id(),
                        e.name(), e.sequence_nr(), e.fwd_thread_id(),
                        e.start_thread_id()))
    return attribute(spans, ops, launches, device)
