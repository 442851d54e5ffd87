"""Video duration probing with graceful 0.0 fallback.

This package's own copy of the JAX package's ``video/probe.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

Native containers (npzv/y4m) are probed in-process; others fall back to
ffprobe when present. Matches the reference's forgiving contract
(src/utils/video_utils.py:7-38): any failure returns 0.0.
"""

from __future__ import annotations

from pathlib import Path

from .containers import probe_clip

__all__ = ["probe_duration"]


def probe_duration(video_path: str | Path) -> float:
    """Duration in seconds, or 0.0 when the file cannot be probed."""
    try:
        meta = probe_clip(video_path)
    except Exception:
        return 0.0
    if meta is None:
        return 0.0
    return float(meta.duration)
