"""Infrastructure: config, model-call budgets, segment planning, call pacing.

This package's own copies of the JAX package's ``utils/{config,counter,
budget_planner,pacer}.py``; the logger, progress and note post-processing
modules are not ported yet (ROADMAP.md §1 item 3b).
"""

from .counter import APICounter, APILimitExceeded

__all__ = ["APICounter", "APILimitExceeded"]
