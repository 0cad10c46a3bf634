"""Scenes of every completed training step, over the window (host
clock)."""


def read(run):
    if "steps" not in run.work or not run.window_s:
        return None
    return run.work["scenes"] / run.window_s
