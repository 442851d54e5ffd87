"""Timestamp parsing and display formatting for deep-dive sections.

This package's own copy of the JAX package's ``contracts/timefmt.py``, pinned to it by
the CPU parity tests (``tests/test_torch_contracts.py``).

Sections may carry timestamps as seconds, milliseconds (heuristically: any
number > 1000), "MM:SS"/"HH:MM:SS" strings, {start, end} dicts, or free-text
ranges. This module extracts them and formats "(HH:MM:SS–HH:MM:SS)" display
strings, matching reference models.py:655-762.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["parse_time_value", "parse_time_range", "format_seconds", "section_timestamp"]

_CLOCK_RE = re.compile(r"\d{1,2}:\d{2}:\d{2}|\d{1,2}:\d{2}")

# Keys checked, in priority order, for a combined timestamp value.
_RANGE_KEYS = ("timestamp", "time_range", "timecode", "time")


def parse_time_value(value: Any) -> float | None:
    """Parse one timestamp value into seconds (ms auto-detected when > 1000)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        num = float(value)
        return num / 1000.0 if num > 1000 else num
    raw = str(value).strip()
    if not raw:
        return None
    try:
        num = float(raw)
        return num / 1000.0 if num > 1000 else num
    except ValueError:
        pass
    if ":" in raw:
        parts = raw.split(":")
        if len(parts) == 3:
            hh, mm, ss = parts
        elif len(parts) == 2:
            hh, (mm, ss) = "0", parts
        else:
            return None
        try:
            return int(hh) * 3600 + int(mm) * 60 + float(ss)
        except ValueError:
            return None
    return None


def parse_time_range(value: Any) -> tuple[float | None, float | None]:
    """Parse a value that may encode a (start, end) range."""
    if isinstance(value, dict):
        start = parse_time_value(
            value.get("start") or value.get("start_time") or value.get("begin")
        )
        end = parse_time_value(
            value.get("end") or value.get("end_time") or value.get("finish")
        )
        return start, end
    if isinstance(value, str):
        matches = _CLOCK_RE.findall(value)
        if not matches:
            return parse_time_value(value), None
        if len(matches) == 1:
            return parse_time_value(matches[0]), None
        return parse_time_value(matches[0]), parse_time_value(matches[1])
    return parse_time_value(value), None


def format_seconds(seconds: float) -> str:
    """Format seconds as zero-padded HH:MM:SS."""
    hh = int(seconds // 3600)
    mm = int((seconds % 3600) // 60)
    ss = int(seconds % 60)
    return f"{hh:02d}:{mm:02d}:{ss:02d}"


def section_timestamp(section: dict[str, Any]) -> str:
    """Extract + format a section's timestamp for display.

    Returns "(HH:MM:SS–HH:MM:SS)", "(HH:MM:SS)", or "".
    """
    start: float | None = None
    end: float | None = None

    for key in _RANGE_KEYS:
        if key in section:
            start, end = parse_time_range(section.get(key))
            if start is not None or end is not None:
                break

    if start is None and end is None:
        start = parse_time_value(
            section.get("start_time") or section.get("start") or section.get("begin")
        )
        end = parse_time_value(
            section.get("end_time") or section.get("end") or section.get("finish")
        )

    if start is not None and end is not None:
        return f"({format_seconds(start)}–{format_seconds(end)})"
    if start is not None:
        return f"({format_seconds(start)})"
    if end is not None:
        return f"({format_seconds(end)})"
    return ""
