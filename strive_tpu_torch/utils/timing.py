"""Time a function on the device its tensors live on.

On a CUDA device the time is the device's (CUDA events); on the CPU it is
the host's clock, and the caller labels it as such.
"""

from __future__ import annotations

import time

import torch


def calls(reps):
    """How many times :func:`cuda_ms` calls ``fn`` for ``reps``."""
    return 1 + 2 * reps


def cuda_ms(fn, reps):
    """Mean device ms per call over ``reps`` calls (CUDA events), after a
    warm-up. A spin kernel holds the stream until every call is queued, so
    the events time the device, not the host's rate of launching (one
    wrapper call can cost the host about as long as a small kernel runs).
    Calls ``fn`` ``calls(reps)`` times; ``fn`` must not synchronize."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_s = 10_000_000 / (start.elapsed_time(end) * 1e-3)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int(2 * host_s * cycles_per_s))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Mean host ms per call over ``reps`` calls after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, reps, device):
    """:func:`cuda_ms` on a CUDA device, :func:`host_ms` on the CPU."""
    return cuda_ms(fn, reps) if torch.device(device).type == "cuda" \
        else host_ms(fn, reps)
