"""Pose-edge pairs that the device planner's lane match computes a call
(``device_planner.COUNTS``: ``match_pairs`` over ``calls``), over the
whole traced run; nothing where the program keeps no such counter."""


def read(run):
    if getattr(run, "profile", None) is None:
        return None
    try:
        from strive_tpu_torch.planners import device_planner
    except ImportError:
        return None
    counts = getattr(device_planner, "COUNTS", None)
    if not counts or not counts.get("calls"):
        return None
    return counts["match_pairs"] / counts["calls"]
