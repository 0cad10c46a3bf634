"""The window's share of the card's float32 peak in an adversarial cell,
in %: the FLOPs of every Adam iteration and batch in the window
(``_counts``) over its wall time x 67 TFLOP/s (the traced run's
profiling comes after the window)."""

from benchmark.metrics import _counts, _shared


def read(run):
    if "iters" not in run.work or not run.window_s:
        return None
    m, B, N = run.cfg["model"], run.cfg["batch_size"], run.cfg["max_agents"]
    return _shared.mfu_pct(
        run, run.work["iters"] * _counts.optim_iteration(m, B, N)
        + run.work["batches"] * _counts.optim_batch(m, B, N))
