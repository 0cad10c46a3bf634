"""CUDA kernels in the profiled Adam iterations, over those iterations
(device trace)."""


def read(run):
    p = run.profile
    if p is None or "iters" not in run.work:
        return None
    return p["kernels"] / p["units"]
