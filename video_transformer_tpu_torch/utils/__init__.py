"""Infrastructure: config, logging, budgets, progress, note post-processing.

This package's own copies of the JAX package's ``utils/`` modules
(``config``, ``counter``, ``budget_planner``, ``pacer``, ``logger``,
``progress``, ``proxy``, ``refiner_contract``, ``refiner``, ``quality``);
``compressor`` and ``tracing`` are not ported yet (ROADMAP.md §1).
"""

from .counter import APICounter, APILimitExceeded

__all__ = ["APICounter", "APILimitExceeded"]
