"""Segment/budget planning for long-video analysis.

This package's own copy of the JAX package's ``utils/budget_planner.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

Given a video duration and a model-call budget, choose a segment length,
overlap, and segment count whose estimated call cost (1 analysis call per
segment + continuations + a consolidation pass + retry buffer) fits the
remaining budget. The NUMERIC behavior — estimation formulas, the
degradation order (drop overlap, then grow segments), and the config
defaults — matches the reference planner (src/utils/budget_planner.py) so
planning decisions agree across implementations; the search is expressed
here as a candidate cascade. The analyzer runs the planned segments as one
batch (or a continuous-batcher sweep) rather than a sequential loop.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Iterator

__all__ = ["SegmentPlan", "plan_segments_with_budget"]


@dataclass(frozen=True)
class SegmentPlan:
    segment_duration: int
    overlap: int
    num_segments: int
    estimated_calls: int
    available_calls: int
    hard_max_calls: int
    fits_budget: bool

    @property
    def empty(self) -> bool:
        return self.num_segments == 0


@dataclass(frozen=True)
class _Knobs:
    """Planner inputs parsed out of the config tree."""

    default_segment: int
    overlap: int
    min_segment: int
    hard_max_calls: int
    max_continuations: int
    retry_buffer: int
    threshold: float | None
    extra_calls: int  # consolidation pass

    @property
    def calls_per_segment(self) -> int:
        return 1 + self.max_continuations

    @property
    def overhead_calls(self) -> int:
        return 1 + self.extra_calls + self.retry_buffer

    def cost(self, num_segments: int) -> int:
        """Worst-case calls: per-segment analysis + continuations, one
        schema/merge call, consolidation, retry headroom."""
        if num_segments <= 0:
            return 0
        return num_segments * self.calls_per_segment + self.overhead_calls


def _int_knob(raw: Any, default: int) -> int:
    if isinstance(raw, (int, float, str)):
        try:
            return int(raw)
        except ValueError:
            pass
    return default


def _bool_knob(raw: Any, default: bool) -> bool:
    if isinstance(raw, bool):
        return raw
    if isinstance(raw, (int, float)):
        return bool(raw)
    if isinstance(raw, str):
        word = raw.strip().lower()
        if word in {"true", "1", "yes", "y", "on"}:
            return True
        if word in {"false", "0", "no", "n", "off"}:
            return False
    return default


def _parse_knobs(config: Mapping[str, Any]) -> _Knobs:
    analyzer = config.get("analyzer")
    analyzer = analyzer if isinstance(analyzer, dict) else {}
    lv = analyzer.get("long_video")
    lv = lv if isinstance(lv, dict) else {}

    raw_threshold = lv.get("duration_threshold_seconds")
    threshold: float | None = None
    if isinstance(raw_threshold, (int, float, str)):
        try:
            threshold = float(raw_threshold)
        except ValueError:
            threshold = None

    return _Knobs(
        default_segment=_int_knob(lv.get("default_segment_seconds"), 480),
        overlap=_int_knob(lv.get("overlap_seconds"), 20),
        min_segment=_int_knob(lv.get("min_segment_seconds"), 90),
        hard_max_calls=_int_knob(lv.get("hard_max_api_calls"), 50),
        max_continuations=_int_knob(analyzer.get("max_continuations"), 3),
        retry_buffer=_int_knob(analyzer.get("retry_times"), 0),
        threshold=threshold,
        extra_calls=1 if _bool_knob(lv.get("consolidate"), True) else 0,
    )


def _segments_covering(duration: float, segment_duration: int, overlap: int) -> int:
    """How many ±overlap segments tile the duration."""
    if duration <= 0:
        return 0
    segment_duration = max(segment_duration, 1)
    overlap = max(min(overlap, segment_duration - 1), 0)
    if duration <= segment_duration:
        return 1
    stride = max(segment_duration - overlap, 1)
    return math.ceil((duration - segment_duration) / stride) + 1


def _candidate_layouts(
    duration: float, knobs: _Knobs, budget: int
) -> Iterator[tuple[int, int]]:
    """(segment_duration, overlap) candidates in degradation order.

    1. the configured layout (or one whole-video segment below threshold);
    2. the same layout with overlap dropped;
    3. ever-longer segments, from the largest count the budget could pay
       for down to a single segment.
    """
    if knobs.threshold is not None and duration < knobs.threshold:
        first = (max(math.ceil(duration), 1), 0)
    else:
        seg = max(knobs.default_segment, knobs.min_segment, 1)
        first = (seg, max(min(knobs.overlap, seg - 1), 0))
    yield first
    yield first[0], 0

    affordable = (budget - knobs.overhead_calls) // knobs.calls_per_segment
    for count in range(affordable, 0, -1):
        yield max(math.ceil(duration / count), knobs.min_segment, 1), 0


def plan_segments_with_budget(
    duration: float,
    config: Mapping[str, Any],
    current_api_count: int,
) -> SegmentPlan:
    """Plan segmentation for ``duration`` seconds within the call budget."""
    knobs = _parse_knobs(config)
    duration = max(float(duration), 0.0)
    budget = max(knobs.hard_max_calls - int(current_api_count), 0)

    if duration > 0 and budget > 0:
        for seg, overlap in _candidate_layouts(duration, knobs, budget):
            count = _segments_covering(duration, seg, overlap)
            cost = knobs.cost(count)
            if cost <= budget:
                return SegmentPlan(
                    segment_duration=seg,
                    overlap=overlap,
                    num_segments=count,
                    estimated_calls=cost,
                    available_calls=budget,
                    hard_max_calls=knobs.hard_max_calls,
                    fits_budget=True,
                )

    return SegmentPlan(
        segment_duration=0,
        overlap=0,
        num_segments=0,
        estimated_calls=0,
        available_calls=budget,
        hard_max_calls=knobs.hard_max_calls,
        fits_budget=False,
    )
