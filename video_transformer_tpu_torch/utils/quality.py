"""Pre-save quality gates over rendered notes.

This package's own copy of the JAX package's ``utils/quality.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

Four deterministic scrubbing gates run before a note is written to disk:
placeholder line-by-line explanations, concept-index timestamp artifacts,
templated exercise answers, and duplicated chapter headings. The REPORT
SCHEMA (gate names, found/fixed key names, counts block) matches the
reference's quality-report artifact (src/utils/note_quality.py:34-43) so
downstream consumers parse either; the gate machinery here is organized
around a shared block scanner instead of per-gate loops.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, TypedDict

__all__ = ["apply_quality_gates", "QualityReport", "GateReport"]

PLACEHOLDER_LINE_RE = re.compile(r"^\s*\d+[：:]\s*完成关键计算或调用步骤。?\s*$")
EXPLANATION_LINE_RE = re.compile(r"^\s*\d+[：:]")
CONCEPT_INDEX_HEADING_RE = re.compile(r"^###\s+概念索引")
TIMESTAMP_ARTIFACT_RE = re.compile(r":\d{2}-:\d{2}")
CHAPTER_HEADING_RE = re.compile(r"^###\s+第(\d+)章：(.+)$")
TEMPLATED_ANSWER_RE = re.compile(r"^答[:：]因为 .+ 直接影响核心流程的效果与可解释性。$")

PLACEHOLDER_RATIO_THRESHOLD = 0.7
PLACEHOLDER_MIN_LINES = 3
TEMPLATED_ANSWER_RATIO_THRESHOLD = 0.6
TEMPLATED_ANSWER_MIN_COUNT = 2

_GAP_NOTICE = "以下片段未覆盖或分析失败"


class GateReport(TypedDict):
    name: str
    triggered: bool
    found: dict[str, int]
    fixed: dict[str, int]
    sections_removed: list[str]
    sections_rewritten: list[str]
    lines_removed: int
    lines_rewritten: int
    blocks_removed: int
    blocks_rewritten: int
    headings_rewritten: int


class QualityReport(TypedDict):
    version: str
    gates_triggered: list[str]
    issues_found: dict[str, dict[str, int]]
    issues_fixed: dict[str, dict[str, int]]
    sections_removed: list[str]
    sections_rewritten: list[str]
    counts: dict[str, int]
    flags: dict[str, Any]


_COUNT_KEYS = (
    "lines_removed",
    "lines_rewritten",
    "blocks_removed",
    "blocks_rewritten",
    "headings_rewritten",
)


@dataclass
class _Outcome:
    """What one gate did to the note, accumulated as it scans."""

    name: str
    found: dict[str, int] = field(default_factory=dict)
    fixed: dict[str, int] = field(default_factory=dict)
    removed_sections: list[str] = field(default_factory=list)
    rewritten_sections: list[str] = field(default_factory=list)
    counts: dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(_COUNT_KEYS, 0)
    )

    def bump(self, key: str, by: int = 1) -> None:
        self.counts[key] += by

    @property
    def triggered(self) -> bool:
        return any(self.counts.values())

    def as_report(self) -> GateReport:
        return {
            "name": self.name,
            "triggered": self.triggered,
            "found": self.found,
            "fixed": self.fixed,
            "sections_removed": self.removed_sections,
            "sections_rewritten": self.rewritten_sections,
            **self.counts,  # type: ignore[typeddict-item]
        }


def apply_quality_gates(
    markdown: str,
    profile: str,
    config: Mapping[str, Any] | None,
) -> tuple[str, QualityReport]:
    """Run all gates over the markdown; returns (scrubbed text, report)."""
    report = _empty_report(profile, config)
    if not markdown:
        return markdown, report

    lines = markdown.splitlines()
    gates: tuple[Callable[[list[str]], tuple[list[str], _Outcome]], ...] = (
        _scrub_placeholder_explanations,
        _scrub_concept_index,
        _scrub_templated_exercises,
        _demote_duplicate_chapters,
    )
    for gate in gates:
        lines, outcome = gate(lines)
        if outcome.triggered:
            _fold(report, outcome.as_report())

    text = "\n".join(lines)
    return text + "\n" if markdown.endswith("\n") else text, report


def _empty_report(profile: str, config: Mapping[str, Any] | None) -> QualityReport:
    enabled = isinstance(config, Mapping) and bool(config.get("enabled", False))
    return {
        "version": "1.0",
        "gates_triggered": [],
        "issues_found": {},
        "issues_fixed": {},
        "sections_removed": [],
        "sections_rewritten": [],
        "counts": dict.fromkeys(_COUNT_KEYS, 0),
        "flags": {
            "profile": profile,
            "enabled": enabled,
            "placeholder_ratio_threshold": PLACEHOLDER_RATIO_THRESHOLD,
            "templated_answer_ratio_threshold": TEMPLATED_ANSWER_RATIO_THRESHOLD,
        },
    }


def _fold(report: QualityReport, gate: GateReport) -> None:
    report["gates_triggered"].append(gate["name"])
    report["issues_found"][gate["name"]] = gate["found"]
    report["issues_fixed"][gate["name"]] = gate["fixed"]
    report["sections_removed"].extend(gate["sections_removed"])
    report["sections_rewritten"].extend(gate["sections_rewritten"])
    for key in _COUNT_KEYS:
        report["counts"][key] += gate[key]  # type: ignore[literal-required]


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


def _scan_block(
    lines: list[str], start: int, member: Callable[[str], bool]
) -> int:
    """First index >= start whose line fails ``member`` (block end)."""
    cursor = start
    while cursor < len(lines) and member(lines[cursor].strip()):
        cursor += 1
    return cursor


def _scrub_placeholder_explanations(
    lines: list[str],
) -> tuple[list[str], _Outcome]:
    """Remove 逐行说明 blocks where >= 70% of numbered lines are filler."""
    outcome = _Outcome("placeholder_explanations")
    filler = total = 0
    kept: list[str] = []
    idx = 0
    while idx < len(lines):
        if lines[idx].strip() not in ("逐行说明：", "逐行说明:"):
            kept.append(lines[idx])
            idx += 1
            continue
        # Blank lines inside (and trailing) the block are removed with it.
        end = _scan_block(
            lines, idx + 1,
            lambda s: not s or bool(EXPLANATION_LINE_RE.match(s)),
        )
        numbered = [
            s for s in (x.strip() for x in lines[idx + 1 : end])
            if EXPLANATION_LINE_RE.match(s)
        ]
        hits = sum(bool(PLACEHOLDER_LINE_RE.match(s)) for s in numbered)
        filler += hits
        total += len(numbered)
        if (
            len(numbered) >= PLACEHOLDER_MIN_LINES
            and hits / len(numbered) >= PLACEHOLDER_RATIO_THRESHOLD
        ):
            outcome.bump("lines_removed", end - idx)
            outcome.bump("blocks_removed")
            idx = end
        else:
            kept.append(lines[idx])
            idx += 1

    outcome.found = {
        "placeholder_lines": filler,
        "total_explanation_lines": total,
    }
    outcome.fixed = {"blocks_removed": outcome.counts["blocks_removed"]}
    if outcome.triggered:
        outcome.removed_sections.append("逐行说明")
    return kept, outcome


def _scrub_concept_index(lines: list[str]) -> tuple[list[str], _Outcome]:
    """Drop timestamp ranges and gap notices from the concept index."""
    outcome = _Outcome("concept_index_artifacts")
    kept: list[str] = []
    in_index = False
    for line in lines:
        s = line.strip()
        if CONCEPT_INDEX_HEADING_RE.match(s):
            in_index = True
        elif in_index and s.startswith(("## ", "### ")):
            in_index = False
        if in_index and (TIMESTAMP_ARTIFACT_RE.search(s) or _GAP_NOTICE in s):
            outcome.bump("lines_removed")
            continue
        kept.append(line)

    removed = outcome.counts["lines_removed"]
    outcome.found = {"artifact_lines": removed}
    outcome.fixed = {"lines_removed": removed}
    if outcome.triggered:
        outcome.bump("blocks_rewritten")
        outcome.rewritten_sections.append("概念索引（Concept Index）")
    return kept, outcome


_EXERCISE_REPLACEMENT = [
    "练习与答解：",
    "",
    "1. 计算 2 + 3 的结果。",
    "2. 计算 6 ÷ 2 的结果。",
    "3. 计算 7 - 4 的结果。",
    "答：5",
    "答：3",
    "答：3",
    "",
]


def _scrub_templated_exercises(lines: list[str]) -> tuple[list[str], _Outcome]:
    """Swap exercise blocks whose answers are >= 60% template boilerplate
    for a minimal concrete replacement."""
    outcome = _Outcome("templated_exercises")
    templated_total = 0
    kept: list[str] = []
    idx = 0
    while idx < len(lines):
        if lines[idx].strip() not in ("练习与答解：", "练习与答解:"):
            kept.append(lines[idx])
            idx += 1
            continue
        end = _scan_block(
            lines, idx + 1, lambda s: not s.startswith(("## ", "### "))
        )
        answers = [
            s for s in (x.strip() for x in lines[idx + 1 : end])
            if s.startswith("答")
        ]
        hits = sum(bool(TEMPLATED_ANSWER_RE.match(s)) for s in answers)
        templated_total += hits
        if (
            hits >= TEMPLATED_ANSWER_MIN_COUNT
            and answers
            and hits / len(answers) >= TEMPLATED_ANSWER_RATIO_THRESHOLD
        ):
            kept.extend(_EXERCISE_REPLACEMENT)
            outcome.bump("lines_rewritten", end - idx)
            outcome.bump("blocks_rewritten")
            idx = end
        else:
            kept.append(lines[idx])
            idx += 1

    outcome.found = {"templated_answers": templated_total}
    outcome.fixed = {"blocks_rewritten": outcome.counts["blocks_rewritten"]}
    if outcome.triggered:
        outcome.rewritten_sections.append("练习与答解")
    return kept, outcome


def _chapter_key(title: str) -> str | None:
    """Comparison key for a chapter title; None = never deduped."""
    if "（补充" in title or "(补充" in title:
        return None
    head = title
    for sep in ("：", ":"):
        if sep in title:
            prefix = title.split(sep, 1)[0].strip()
            if prefix:
                head = prefix
            break
    key = re.sub(r"[^\w一-鿿]+", "", head)
    return key if len(key) >= 2 else None


def _demote_duplicate_chapters(lines: list[str]) -> tuple[list[str], _Outcome]:
    """Demote repeated chapter headings to `#### 补充：` sub-headings."""
    outcome = _Outcome("duplicated_chapter_titles")
    seen: set[str] = set()
    out = list(lines)
    for idx, line in enumerate(lines):
        match = CHAPTER_HEADING_RE.match(line.strip())
        if not match:
            continue
        title = match.group(2).strip()
        key = _chapter_key(title)
        if key is None:
            continue
        if key in seen:
            out[idx] = f"#### 补充：{title}"
            outcome.bump("headings_rewritten")
        else:
            seen.add(key)

    rewritten = outcome.counts["headings_rewritten"]
    outcome.found = {"duplicate_titles": rewritten}
    outcome.fixed = {"headings_rewritten": rewritten}
    if outcome.triggered:
        outcome.rewritten_sections.append("章节标题")
    return out, outcome
