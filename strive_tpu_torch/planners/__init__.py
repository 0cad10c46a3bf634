from .hardcode import RulePlanner, PLANNER_CONFIGS, PlannerConfig  # noqa: F401
