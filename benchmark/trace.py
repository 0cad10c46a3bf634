"""The traced run's profiler: a bounded span of whole units of work,
after the measured window.

Once the window has closed, the driver arms the tracer and runs a few
more units of work (Adam iterations, training steps), which the window's
metrics do not count, calling :meth:`Tracer.boundary` at the end of each.
After ``skip`` of them the tracer synchronizes, starts ``torch.profiler``
(CPU and CUDA), and records the arguments of every K1 (``map_crop``)
launch; after ``units`` more it synchronizes and stops. So the window of
a traced run is that of an untraced one: the profiler's start, which
loads CUPTI, and the cost it leaves on every later launch fall outside.

:func:`summarize` reduces the events to what the metric readers take:
kernel and device intervals inside the span, their union (busy time),
kernel time by name, idle gaps by the host operation running at the
gap's middle, and the recorded K1 launches.
"""

from __future__ import annotations

import bisect

import torch

SPAN = "bench.span"
SHORT_GAP_NS = 5000  # idle gaps shorter than this are summed unnamed


class Tracer:
    def __init__(self, skip, units, device):
        self.skip, self.units, self.device = int(skip), int(units), device
        self.count = 0
        self.prof = None
        self.span = None
        self.done = False
        self.k1 = []        # (pos, mapix, lo, wo, C, dtype) of each launch
        self.span_units = 0
        self.armed = False
        self._orig = None

    @property
    def needed(self):
        """Units the driver runs after the window for the span."""
        return self.skip + self.units

    def _patch(self):
        from strive_tpu_torch.maps import crop_kernel

        orig = crop_kernel.map_crop
        rec = self.k1

        def recorded(packed, dx, pos, mapix, lo, wo, num_channels, *a, **k):
            dtype = k.get("dtype", a[1] if len(a) > 1 else torch.float32)
            rec.append((pos.detach().clone(), mapix.clone(), lo, wo,
                        int(num_channels), dtype))
            return orig(packed, dx, pos, mapix, lo, wo, num_channels, *a, **k)

        self._orig = orig
        crop_kernel.map_crop = recorded

    def _unpatch(self):
        from strive_tpu_torch.maps import crop_kernel

        if self._orig is not None:
            crop_kernel.map_crop = self._orig
            self._orig = None

    def boundary(self):
        if self.done or not self.armed:
            return
        self.count += 1
        if self.count == self.skip:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(self.device)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.span = torch.autograd.profiler.record_function(SPAN)
            self.span.__enter__()
            self._patch()
        elif self.count == self.skip + self.units:
            self.span_units = self.units
            self.close()

    def close(self):
        """End the span (at its last unit, or when the driver stops first:
        then it holds the units done so far)."""
        if self.prof is None or self.done:
            self.done = True
            return
        if not self.span_units:
            self.span_units = self.count - self.skip
        torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self._unpatch()
        self.prof.stop()
        self.done = True


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals, lo, hi):
    """Idle intervals of [lo, hi] outside the union of ``intervals``."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(tracer):
    """:return: dict with span_s, units, busy_s, kernels (count), kernel
    seconds by name, device_ops and idle_gaps (top 10 each, seconds),
    k1 (the recorded launches); None when nothing was profiled."""
    if tracer is None or tracer.prof is None or not tracer.span_units:
        return None
    events = tracer.prof.profiler.kineto_results.events()
    span = None
    cpu, dev = [], []
    for e in events:
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == SPAN:
                span = (s, s + d)
            elif d > 0:
                cpu.append((s, s + d, name))
        elif not (e.is_user_annotation() or name == SPAN):
            dev.append((s, s + d, name))
    if span is None:
        return None
    lo, hi = span
    dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    kern = [(s, e, n) for s, e, n in dev
            if not n.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for s, e, n in kern:
        by_name[n] = by_name.get(n, 0) + (e - s)
    busy = _union([(s, e) for s, e, _ in dev])
    # idle gaps named by the innermost host operation at their middle
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = {}
    for a, b in _gaps([(s, e) for s, e, _ in dev], lo, hi):
        if b - a < SHORT_GAP_NS:
            idle["(gaps under 5 us)"] = idle.get("(gaps under 5 us)", 0) \
                + (b - a)
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, e, n in reversed(cpu[max(0, i - 200):i]):
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        key = best[2] if best else "(host, between operations)"
        idle[key] = idle.get(key, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"span_s": (hi - lo) * 1e-9, "units": tracer.span_units,
            "busy_s": busy * 1e-9, "kernels": len(kern),
            "kernel_s": {n: v * 1e-9 for n, v in by_name.items()},
            "device_ops": [[n, v * 1e-9] for n, v in top],
            "idle_gaps": [[n, v * 1e-9] for n, v in gaps],
            "k1": tracer.k1}
