"""Model-call budget counter.

This package's own copy of the JAX package's ``utils/counter.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

In the reference this limited Gemini cloud calls (src/utils/counter.py);
here it bounds on-device model generations per run. The two-tier semantics
are the contract the pipeline's budget logic depends on: a soft cap the
long-video planner may raise, an optional hard cap it can never exceed, and
budgeting that applies only to the primary generation service (auxiliary
services are counted nowhere).
"""

from __future__ import annotations

__all__ = ["APICounter", "APILimitExceeded", "BUDGETED_SERVICES"]


class APILimitExceeded(RuntimeError):
    """Raised when the budgeted generation count is exhausted."""


# Service names whose calls draw down the budget. "gemini" is kept for
# config compatibility; "local"/"tpu" are the native engine's names.
BUDGETED_SERVICES = frozenset({"gemini", "local", "tpu"})


class APICounter:
    """Two-tier call budget: soft cap (adjustable) under a hard ceiling."""

    def __init__(
        self,
        max_calls: int = 20,
        current_count: int = 0,
        hard_max_calls: int | None = None,
    ):
        self.max_calls = max_calls
        self.current_count = current_count
        self.hard_max_calls = hard_max_calls

    def __repr__(self) -> str:  # aids budget debugging in logs
        return (
            f"APICounter({self.current_count}/{self.limit}"
            f"{'' if self.hard_max_calls is None else f' hard={self.hard_max_calls}'})"
        )

    @property
    def limit(self) -> int:
        """The cap in force right now (soft, clamped by hard when set)."""
        hard = self.hard_max_calls
        return self.max_calls if hard is None else min(self.max_calls, hard)

    # Reference-compatible spelling used by older call sites.
    def _effective_max_calls(self) -> int:
        return self.limit

    def set_max_calls(self, max_calls: int, hard_max_calls: int | None = None) -> int:
        """Move the soft cap (never above the hard ceiling). Returns it."""
        if hard_max_calls is not None:
            self.hard_max_calls = hard_max_calls
        hard = self.hard_max_calls
        self.max_calls = max_calls if hard is None else min(max_calls, hard)
        return self.max_calls

    def increase_max_calls(
        self, additional_calls: int, hard_max_calls: int | None = None
    ) -> int:
        raised = self.max_calls + additional_calls
        return self.set_max_calls(raised, hard_max_calls)

    def increment(self, service: str) -> bool:
        """Record one call. Budgeted services raise APILimitExceeded at the
        cap; everything else passes through uncounted."""
        if service.lower() not in BUDGETED_SERVICES:
            return True
        if self.remaining() == 0:
            raise APILimitExceeded(
                f"Model call limit reached: {self.current_count}/{self.limit}"
            )
        self.current_count += 1
        return True

    def can_call(self) -> bool:
        return self.remaining() > 0

    def remaining(self) -> int:
        return max(self.limit - self.current_count, 0)

    def reset(self) -> None:
        self.current_count = 0
