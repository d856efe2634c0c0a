"""Plan warming of the port (``repro.tune.warm``): a service's channel grid
dispatched once at boot.  The autotuner (``space``, ``cost``, ``search``,
``table``) is ROADMAP queue 1 item 13."""
from .warm import warm_grid, warm_plan

__all__ = ["warm_grid", "warm_plan"]
