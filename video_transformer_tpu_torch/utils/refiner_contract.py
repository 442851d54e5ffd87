"""Numeric contract for note-length budgeting and takeaway mapping.

This package's own copy of the JAX package's ``utils/refiner_contract.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

The CONSTANTS here are a cross-implementation contract and must stay
byte-identical to the reference's (src/utils/note_refiner_contract.py:8-37):
rendered notes from either implementation carry the same headings, the same
400-lines-per-hour budget clamped to [220, 900] with ±10% tolerance, and the
same `<!-- BUDGET_EXCEEDED -->` marker, so downstream tooling (linters, PDF
export, the compressed-note tool) reads both. The code around the constants
is this repo's own.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, NamedTuple

__all__ = [
    "BudgetSpec",
    "BudgetResult",
    "budget_for_duration",
    "format_budget_warning",
    "count_budget_lines",
    "normalize_topic_title",
    "normalize_takeaway",
    "build_coverage_index_lines",
    "KeyTakeawayMappingRules",
]

# Rebuilt-note section headings, in render order.
NOTE_HEADINGS: dict[str, str] = {
    "mistakes": "## ⚠️ 易错点总结",
    "key_points": "## ⭐ 知识重点",
    "expanded": "## 📚 重点展开",
    "coverage": "## 📌 覆盖清单 (Coverage Index)",
}
HEADING_MISTAKES = NOTE_HEADINGS["mistakes"]
HEADING_KEY_POINTS = NOTE_HEADINGS["key_points"]
HEADING_EXPANDED = NOTE_HEADINGS["expanded"]
HEADING_COVERAGE_INDEX = NOTE_HEADINGS["coverage"]
REQUIRED_OUTPUT_HEADINGS = tuple(NOTE_HEADINGS.values())

# Headings of the source sections the legacy rebuild consumes, and the
# takeaway-mapping appendix surface (grouped like NOTE_HEADINGS; the
# module-level aliases below are the compatibility API).
SOURCE_HEADINGS: dict[str, str] = {
    "key_takeaways": "## 📝 关键结论 (Key Takeaways)",
    "glossary": "## 📖 关键术语表 (Glossary)",
}
MAPPING_SURFACE: dict[str, str] = {
    "section": "## 🔗 关键结论映射 (Key Takeaway Mapping)",
    "unmapped": "## Unmapped Takeaways",
    "table_header": "| Takeaway | Topics | Match Strategy |",
    "table_separator": "| --- | --- | --- |",
    "json_fence": "```json",
    "budget_warning": "<!-- BUDGET_EXCEEDED: actual={actual}, target={target} -->",
}
SOURCE_KEY_TAKEAWAYS_HEADING = SOURCE_HEADINGS["key_takeaways"]
SOURCE_GLOSSARY_HEADING = SOURCE_HEADINGS["glossary"]
MAPPING_SECTION_HEADING = MAPPING_SURFACE["section"]
UNMAPPED_TAKEAWAYS_HEADING = MAPPING_SURFACE["unmapped"]
MAPPING_TABLE_HEADER = MAPPING_SURFACE["table_header"]
MAPPING_TABLE_SEPARATOR = MAPPING_SURFACE["table_separator"]
MAPPING_JSON_FENCE = MAPPING_SURFACE["json_fence"]
BUDGET_WARNING_TEMPLATE = MAPPING_SURFACE["budget_warning"]


class BudgetResult(NamedTuple):
    target_lines: int
    min_lines: int
    max_lines: int


class BudgetSpec(NamedTuple):
    """Duration-scaled line budget: lines/hour with caps and tolerance."""

    lines_per_hour: int = 400
    min_cap: int = 220
    max_cap: int = 900
    tolerance_ratio: float = 0.10

    def resolve(self, duration_seconds: float) -> BudgetResult:
        scaled = math.ceil(self.lines_per_hour * duration_seconds / 3600.0)
        target = min(max(scaled, self.min_cap), self.max_cap)
        slack = self.tolerance_ratio * target
        return BudgetResult(
            target_lines=target,
            min_lines=math.ceil(target - slack),
            max_lines=math.floor(target + slack),
        )


def budget_for_duration(duration_seconds, spec: BudgetSpec | None = None):
    """Resolve the default (or given) BudgetSpec for a video duration."""
    return (spec or BudgetSpec()).resolve(duration_seconds)


def format_budget_warning(actual_lines: int, target_lines: int) -> str:
    return BUDGET_WARNING_TEMPLATE.format(
        actual=actual_lines, target=target_lines
    )


def count_budget_lines(text: str, exclude_code_from_budget: bool = False) -> int:
    """Line count against the budget; fenced code optionally exempt
    (fence markers themselves never count when exempting)."""
    if not exclude_code_from_budget:
        return len(text.splitlines())
    total = 0
    depth = 0
    for raw in text.splitlines():
        if raw.lstrip().startswith("```"):
            depth ^= 1
        elif not depth:
            total += 1
    return total


class KeyTakeawayMappingRules(NamedTuple):
    """Match cascade + output formats for the takeaway→topic appendix."""

    match_order: tuple[str, ...] = (
        "topic_substring",
        "glossary_term",
        "earliest_unmatched",
    )
    mapping_output_formats: tuple[str, ...] = ("markdown_table", "json_fence")
    mapping_section_heading: str = MAPPING_SECTION_HEADING
    unmapped_section_heading: str = UNMAPPED_TAKEAWAYS_HEADING


# Characters ignored when comparing topic titles and takeaways: whitespace,
# ASCII punctuation, and full-width CJK punctuation.
_IGNORED_CHARS = re.compile(
    r"[\s\-—_·`~!@#$%^&*()=+\[\]{};:'\",.<>/?\\|，。！？：；（）【】《》“”‘’、]",
    re.UNICODE,
)


def _comparison_key(text: str) -> str:
    return _IGNORED_CHARS.sub("", text.strip().lower())


def normalize_topic_title(title: str) -> str:
    return _comparison_key(title)


def normalize_takeaway(text: str) -> str:
    return _comparison_key(text)


def build_coverage_index_lines(topics: Iterable[str]) -> list[str]:
    """One `- topic` bullet per entry, render order preserved."""
    return ["- " + topic for topic in topics]
