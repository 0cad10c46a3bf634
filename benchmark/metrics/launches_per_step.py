"""CUDA kernels in the profiled training steps, over those steps (device
trace)."""


def read(run):
    p = run.profile
    if p is None or "steps" not in run.work:
        return None
    return p["kernels"] / p["units"]
