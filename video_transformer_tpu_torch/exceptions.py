"""Framework exception types.

This package's own copy of the JAX package's ``exceptions.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).
"""

from .utils.counter import APILimitExceeded

__all__ = ["APILimitExceeded", "KeyExhaustedError", "EngineError"]


class KeyExhaustedError(Exception):
    """An API key pool reports every key exhausted (optional cloud seam;
    declared for compatibility with the reference's src/exceptions.py)."""


class EngineError(RuntimeError):
    """The on-device inference engine failed irrecoverably."""
