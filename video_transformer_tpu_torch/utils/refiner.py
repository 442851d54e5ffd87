"""Deterministic note-length refinement.

This package's own copy of the JAX package's ``utils/refiner.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

Applies the duration-scaled line budget (refiner_contract.py: 400 lines/hour
clamped to [220, 900], ±10%) with two strategies, mirroring the reference
(src/utils/note_refiner.py):

- Lecture/textbook notes: a trimming cascade (second+ examples, long bullet
  runs, FAQ items, appendix code blocks, concept-index entries).
- Legacy notes: a full REBUILD into the contract's output structure —
  ## ⚠️ 易错点总结 / ## ⭐ 知识重点 / ## 📚 重点展开 / ## 📌 覆盖清单 plus
  the key-takeaway mapping table (match order: topic substring → glossary
  term → earliest unmatched; refiner_contract.KeyTakeawayMappingRules).

A note still over budget gets the ``<!-- BUDGET_EXCEEDED -->`` marker
appended rather than destructive cuts (coverage is a hard requirement; the
budget is a soft constraint — CoveragePolicy).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable

from .refiner_contract import (
    HEADING_COVERAGE_INDEX,
    HEADING_EXPANDED,
    HEADING_KEY_POINTS,
    HEADING_MISTAKES,
    MAPPING_SECTION_HEADING,
    MAPPING_TABLE_HEADER,
    MAPPING_TABLE_SEPARATOR,
    SOURCE_GLOSSARY_HEADING,
    SOURCE_KEY_TAKEAWAYS_HEADING,
    UNMAPPED_TAKEAWAYS_HEADING,
    BudgetSpec,
    budget_for_duration,
    count_budget_lines,
    format_budget_warning,
    normalize_takeaway,
    normalize_topic_title,
)

__all__ = ["refine_note", "is_lecture_note", "rebuild_legacy_note"]

_HEADING_RE = re.compile(r"^(#{1,6})\s")

LECTURE_MARKERS = ("## 核心概念图谱", "## 主题详解")
TEXTBOOK_MARKERS = ("## 实战与代码", "## FAQ / 避坑指南")


def is_lecture_note(markdown: str) -> bool:
    return any(marker in markdown for marker in LECTURE_MARKERS)


def refine_note(
    markdown: str,
    duration_seconds: float,
    config: Mapping[str, Any] | None = None,
) -> str:
    """Trim the note toward its duration budget (soft constraint)."""
    config = dict(config or {})
    spec = BudgetSpec(
        lines_per_hour=int(config.get("lines_per_hour", 400)),
        min_cap=int(config.get("min_lines", 220)),
        max_cap=int(config.get("max_lines", 900)),
        tolerance_ratio=float(config.get("tolerance_ratio", 0.10)),
    )
    exclude_code = bool(config.get("exclude_code_from_budget", False))
    budget = budget_for_duration(duration_seconds, spec)

    def over_budget(text: str) -> bool:
        return count_budget_lines(text, exclude_code) > budget.max_lines

    if not over_budget(markdown):
        return markdown

    if not is_lecture_note(markdown):
        rebuilt = rebuild_legacy_note(markdown, budget.target_lines)
        if not over_budget(rebuilt):
            return rebuilt
        actual = count_budget_lines(rebuilt, exclude_code)
        return rebuilt + "\n" + format_budget_warning(actual, budget.target_lines) + "\n"

    passes: list[Callable[[str], str]] = [
        _trim_extra_examples,
        lambda t: _trim_long_bullets(t, keep=5),
        lambda t: _trim_faq_items(t, keep=4),
        lambda t: _trim_appendix_code(t, keep=2),
        lambda t: _trim_concept_index(t, keep=30),
        lambda t: _trim_long_bullets(t, keep=3),
    ]
    text = markdown
    for trim in passes:
        text = trim(text)
        if not over_budget(text):
            return text

    actual = count_budget_lines(text, exclude_code)
    return text + "\n" + format_budget_warning(actual, budget.target_lines) + "\n"


# -- legacy rebuild --------------------------------------------------------------


@dataclass
class _LegacyTopic:
    title: str
    explanation: list[str] = field(default_factory=list)
    mistakes: list[str] = field(default_factory=list)


_LEGACY_TOPIC_RE = re.compile(r"^#### \d+\. (.+?)(?:\s+\(\d.*\))?$")
_BOLD_LABEL_RE = re.compile(r"^\*\*(.+?)\*\*[：:]?$")


def _parse_legacy_note(markdown: str):
    """Extract title, takeaways, glossary, and deduped topics from a legacy
    (v1/v2) note."""
    lines = markdown.splitlines()
    title = lines[0].lstrip("# ").strip() if lines else "笔记"

    takeaways: list[str] = []
    glossary: dict[str, str] = {}
    topics: list[_LegacyTopic] = []
    seen_topics: set[str] = set()

    section = None  # takeaways | glossary | None
    current: _LegacyTopic | None = None
    current_label = None  # explanation | mistakes | other

    for line in lines[1:]:
        stripped = line.strip()
        if stripped.startswith("## "):
            section = (
                "takeaways"
                if stripped == SOURCE_KEY_TAKEAWAYS_HEADING.strip()
                else "glossary"
                if stripped == SOURCE_GLOSSARY_HEADING.strip()
                else None
            )
            current = None
            continue
        topic_match = _LEGACY_TOPIC_RE.match(stripped)
        if topic_match:
            name = topic_match.group(1).strip()
            key = normalize_topic_title(name)
            if key in seen_topics:
                current = None  # duplicate topic: merge by dropping body
            else:
                seen_topics.add(key)
                current = _LegacyTopic(title=name)
                topics.append(current)
            current_label = None
            continue

        if section == "takeaways" and stripped.startswith("- "):
            takeaways.append(stripped[2:].strip())
            continue
        if section == "glossary" and stripped.startswith("- **"):
            body = stripped[2:]
            match = re.match(r"\*\*(.+?)\*\*[：:]\s*(.*)", body)
            if match:
                glossary[match.group(1).strip()] = match.group(2).strip()
            continue

        if current is not None:
            label_match = _BOLD_LABEL_RE.match(stripped)
            if label_match:
                label = label_match.group(1)
                if "原理" in label:
                    current_label = "explanation"
                elif "误区" in label:
                    current_label = "mistakes"
                else:
                    current_label = None
                continue
            if not stripped or stripped.startswith("#"):
                continue
            if current_label == "explanation" and not stripped.startswith("```"):
                current.explanation.append(stripped)
            elif current_label == "mistakes" and stripped.startswith("- "):
                current.mistakes.append(stripped[2:].strip())

    return title, takeaways, glossary, topics


def _map_takeaways(
    takeaways: list[str], topics: list[_LegacyTopic], glossary: dict[str, str]
) -> tuple[list[tuple[str, list[str], str]], list[str]]:
    """Match order: topic_substring -> glossary_term -> earliest_unmatched."""
    mapped: list[tuple[str, list[str], str]] = []
    unmapped: list[str] = []
    matched_topics: set[str] = set()

    for takeaway in takeaways:
        norm_takeaway = normalize_takeaway(takeaway)
        hits = [
            topic.title
            for topic in topics
            if normalize_topic_title(topic.title)
            and normalize_topic_title(topic.title) in norm_takeaway
        ]
        strategy = "topic_substring"
        if not hits:
            terms = [
                term
                for term in glossary
                if normalize_takeaway(term) and normalize_takeaway(term) in norm_takeaway
            ]
            if terms:
                hits = [
                    topic.title
                    for topic in topics
                    if any(
                        normalize_takeaway(term)
                        in normalize_topic_title(topic.title)
                        for term in terms
                    )
                ]
                strategy = "glossary_term"
        if not hits:
            leftover = [
                topic.title
                for topic in topics
                if normalize_topic_title(topic.title) not in matched_topics
            ]
            if leftover:
                hits = [leftover[0]]
                strategy = "earliest_unmatched"
        if hits:
            matched_topics.update(normalize_topic_title(h) for h in hits)
            mapped.append((takeaway, hits, strategy))
        else:
            unmapped.append(takeaway)
    return mapped, unmapped


def rebuild_legacy_note(markdown: str, target_lines: int) -> str:
    """Rebuild a legacy note into the contract output structure.

    Emits 易错点总结 / 知识重点 / 重点展开 / 覆盖清单 plus the takeaway
    mapping table, with 重点展开 explanations trimmed toward the budget.
    """
    title, takeaways, glossary, topics = _parse_legacy_note(markdown)
    mapped, unmapped = _map_takeaways(takeaways, topics, glossary)

    # Budget for expanded explanations: whatever the fixed sections leave.
    fixed = (
        8
        + sum(min(len(t.mistakes), 2) for t in topics)
        + len(takeaways)
        + len(topics)
        + len(mapped)
        + len(unmapped)
        + 12
    )
    per_topic = max(1, (target_lines - fixed) // max(len(topics), 1) - 2)

    out: list[str] = [f"# {title}", ""]

    out.extend([HEADING_MISTAKES, ""])
    any_mistake = False
    for topic in topics:
        for mistake in topic.mistakes[:2]:
            out.append(f"- {topic.title}：{mistake}")
            any_mistake = True
    if not any_mistake:
        out.append("- （本笔记未标注易错点）")
    out.append("")

    out.extend([HEADING_KEY_POINTS, ""])
    for takeaway in takeaways:
        out.append(f"- {takeaway}")
    if not takeaways:
        out.append("- （无关键结论）")
    out.append("")

    out.extend([HEADING_EXPANDED, ""])
    for idx, topic in enumerate(topics, 1):
        out.append(f"### {idx}. {topic.title}")
        out.append("")
        for line in topic.explanation[:per_topic]:
            out.append(line)
        out.append("")

    out.extend([HEADING_COVERAGE_INDEX, ""])
    for topic in topics:
        out.append(f"- {topic.title}")
    out.append("")

    out.extend([MAPPING_SECTION_HEADING, ""])
    out.append(MAPPING_TABLE_HEADER)
    out.append(MAPPING_TABLE_SEPARATOR)
    for takeaway, hits, strategy in mapped:
        cell = takeaway.replace("|", "\\|")
        out.append(f"| {cell} | {'、'.join(hits)} | {strategy} |")
    out.append("")
    if unmapped:
        out.extend([UNMAPPED_TAKEAWAYS_HEADING, ""])
        for takeaway in unmapped:
            out.append(f"- {takeaway}")
        out.append("")

    return "\n".join(out)


# -- trimming passes -----------------------------------------------------------


def _split_sections(lines: list[str], level: int) -> list[tuple[str | None, list[str]]]:
    """Partition into (heading, body-lines) chunks at the given heading level."""
    chunks: list[tuple[str | None, list[str]]] = [(None, [])]
    prefix = "#" * level + " "
    for line in lines:
        if line.startswith(prefix):
            chunks.append((line, []))
        else:
            chunks[-1][1].append(line)
    return chunks


def _trim_extra_examples(markdown: str) -> str:
    """In 实战与代码, keep only 示例 1; drop later example subsections."""
    lines = markdown.splitlines()
    out: list[str] = []
    in_practice = False
    dropping = False
    for line in lines:
        if line.startswith("## "):
            in_practice = line.strip().startswith("## 实战与代码")
            dropping = False
        if in_practice and line.startswith("### 示例 "):
            match = re.match(r"### 示例 (\d+)", line)
            dropping = bool(match and int(match.group(1)) >= 2)
        if not dropping:
            out.append(line)
    return "\n".join(out)


def _trim_long_bullets(markdown: str, keep: int) -> str:
    """Cap consecutive bullet runs at ``keep`` items."""
    out: list[str] = []
    run = 0
    for line in markdown.splitlines():
        if re.match(r"^\s*[-*+]\s", line):
            run += 1
            if run > keep:
                continue
        else:
            # Indented continuations belong to the previous bullet.
            if not line.startswith("  ") or not line.strip():
                run = 0
        out.append(line)
    return "\n".join(out)


def _trim_faq_items(markdown: str, keep: int) -> str:
    """In FAQ / 避坑指南, cap 常见坑 bullets and exercise items."""
    lines = markdown.splitlines()
    out: list[str] = []
    in_faq = False
    bullet_count = 0
    exercise_count = 0
    answer_count = 0
    for line in lines:
        if line.startswith("## "):
            in_faq = line.strip().startswith("## FAQ")
            bullet_count = exercise_count = answer_count = 0
        if in_faq:
            if re.match(r"^\s*-\s", line):
                bullet_count += 1
                if bullet_count > keep:
                    continue
            elif re.match(r"^\d+\.\s", line):
                exercise_count += 1
                if exercise_count > keep:
                    continue
            elif line.startswith("答："):
                answer_count += 1
                if answer_count > keep:
                    continue
        out.append(line)
    return "\n".join(out)


def _trim_appendix_code(markdown: str, keep: int) -> str:
    """In 代码与伪代码, keep the first ``keep`` fenced blocks."""
    lines = markdown.splitlines()
    out: list[str] = []
    in_code_appendix = False
    block_count = 0
    dropping = False
    for line in lines:
        if line.startswith("### "):
            in_code_appendix = line.strip().startswith("### 代码与伪代码")
            dropping = False
        if in_code_appendix and line.strip().startswith("```"):
            if not dropping and line.strip() == "```python":
                block_count += 1
                if block_count > keep:
                    dropping = True
            elif dropping and line.strip() == "```":
                dropping = False
                continue
        if not dropping:
            out.append(line)
    return "\n".join(out)


def _trim_concept_index(markdown: str, keep: int) -> str:
    lines = markdown.splitlines()
    out: list[str] = []
    in_index = False
    count = 0
    for line in lines:
        if line.startswith("### "):
            in_index = line.strip().startswith("### 概念索引")
            count = 0
        if in_index and re.match(r"^\s*-\s", line):
            count += 1
            if count > keep:
                continue
        out.append(line)
    return "\n".join(out)
