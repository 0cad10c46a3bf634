"""Scenes x Adam iterations of every batch in the window, over the time
from the window's start to the end of its last batch (host clock)."""


def read(run):
    if "scene_iters" not in run.work or not run.window_s:
        return None
    return run.work["scene_iters"] / run.window_s
