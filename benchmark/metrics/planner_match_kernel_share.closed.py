"""Share of the device planner's lane-matched poses that its lane-match
kernel served (``device_planner.COUNTS``: ``kernel_matches`` over
``matches``), over the whole traced run; nothing where the program keeps
no such counter."""


def read(run):
    if getattr(run, "profile", None) is None:
        return None
    try:
        from strive_tpu_torch.planners import device_planner
    except ImportError:
        return None
    counts = getattr(device_planner, "COUNTS", None)
    if (not counts or not counts.get("matches")
            or "kernel_matches" not in counts):
        return None
    return counts["kernel_matches"] / counts["matches"]
