"""Faults planted in the closed-loop cell's planner, to show that its
check sees them:

- ``ignore_others``: the device planner plans as if the ego were alone;
- ``held``: each batch's planner function returns its first plan at every
  later call.

Each is a context manager that breaks the program underneath the harness
and puts it back on exit; ``benchmark.faults``' faults apply to the cell
as to ``optim``'s. The benchmark's runs never enter them: the tests and

    python3 -m benchmark.planner_faults --workload adv_closed_b4 --seeds 11 --fault held

do (``benchmark.calibrate``'s options and readings, with these faults
beside ``benchmark.faults``').
"""

from __future__ import annotations

import sys

from .faults import _patched

FAULTS = ("ignore_others", "held")


def fault(name):
    from strive_tpu_torch.planners import device_planner as dp

    if name == "ignore_others":
        orig = dp.plan_rollout

        def alone(tab, cfg, init_state, lw, alive0, *a, **k):
            alive0 = alive0.clone()
            alive0[:, 1:] = False
            return orig(tab, cfg, init_state, lw, alive0, *a, **k)

        return _patched(dp, "plan_rollout", alone)
    if name == "held":
        orig = dp.DeviceRulePlanner.make_fn

        def held(self, *a, **k):
            fn, first = orig(self, *a, **k), []

            def first_plan(pred):
                if not first:
                    first.append(fn(pred))
                return first[0]

            return first_plan

        return _patched(dp.DeviceRulePlanner, "make_fn", held)
    raise ValueError(f"no planner fault {name!r}")


def main(argv=None):
    from . import calibrate, faults

    orig = faults.fault

    def either(name, driver):
        if name in FAULTS:
            return fault(name)
        return orig(name, "optim" if driver == "closed" else driver)

    faults.fault = either
    try:
        return calibrate.main(argv)
    finally:
        faults.fault = orig


if __name__ == "__main__":
    sys.exit(main())
