"""Timestamp display formatting (this package's copy of ``format_seconds``
from the JAX package's ``contracts/timefmt.py``)."""

from __future__ import annotations

__all__ = ["format_seconds"]


def format_seconds(seconds: float) -> str:
    """Format seconds as zero-padded HH:MM:SS."""
    hh = int(seconds // 3600)
    mm = int((seconds % 3600) // 60)
    ss = int(seconds % 60)
    return f"{hh:02d}:{mm:02d}:{ss:02d}"
