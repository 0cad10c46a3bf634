"""The window's share of the card's float32 peak in a training cell, in
%: the FLOPs of every completed training step (``_counts.train_step``)
over the window's wall time x 67 TFLOP/s (the traced run's profiling
comes after the window)."""

from benchmark.metrics import _counts, _shared


def read(run):
    if "steps" not in run.work or not run.window_s:
        return None
    m, B, N = run.cfg["model"], run.cfg["batch_size"], run.cfg["max_agents"]
    return _shared.mfu_pct(
        run, run.work["steps"] * _counts.train_step(m, B, N))
