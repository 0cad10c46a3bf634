"""Share of the device planner's calls served by replaying its captured
CUDA graph (``device_planner.COUNTS``: ``replays`` over ``calls``), over
the whole traced run; nothing where the program keeps no such counter."""


def read(run):
    if getattr(run, "profile", None) is None:
        return None
    try:
        from strive_tpu_torch.planners import device_planner
    except ImportError:
        return None
    counts = getattr(device_planner, "COUNTS", None)
    if not counts or not counts.get("calls") or "replays" not in counts:
        return None
    return counts["replays"] / counts["calls"]
