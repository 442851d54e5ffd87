"""Long-video merge logic: combine per-segment analyses into one note.

This package's own copy of the JAX package's ``analyzer/segmentation.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

The reference analyzes segments sequentially and merges afterwards
(content_analyzer.py:966-1066). Here segments are analyzed as one
batch (parallel/engine.py) and merged with the same semantics:

- key takeaways deduped by normalized text,
- glossary deduped by normalized term (first definition wins; empty
  definitions backfilled),
- sections deduped by signature and dropped when their time range overlaps
  already-merged content (overlap regions are analyzed twice by design),
- uncovered ranges recorded as a gap-note takeaway,
- visual schemas taken from the first segment.

Consolidation acceptance checks (2-6 chapters, unique titles, full field
set — reference content_analyzer.py:1189-1231) are exposed for the optional
model-driven consolidation pass.
"""

from __future__ import annotations

import json
import re
from typing import Any

from ..contracts.normalize import as_chapters, coerce_str_list
from ..contracts.timefmt import format_seconds, parse_time_range, parse_time_value

__all__ = [
    "SegmentOutput",
    "merge_segment_outputs",
    "offset_timestamps",
    "accept_consolidation",
    "format_gap_note",
    "normalize_text",
]

_NORM_RE = re.compile(r"[\W_]+", re.UNICODE)


def normalize_text(text: str) -> str:
    return _NORM_RE.sub("", str(text).strip().lower())


SegmentOutput = dict[str, Any]  # {"start": float, "end": float, "data": dict}


def format_gap_note(start: float, end: float) -> str:
    return f"{format_seconds(start)}-{format_seconds(end)}"


def _section_signature(section: dict[str, Any]) -> str:
    topic = normalize_text(section.get("topic", ""))
    explanation = normalize_text(str(section.get("explanation", ""))[:60])
    return f"{topic}|{explanation}"


def _parse_range(value: Any) -> tuple[float | None, float | None]:
    """Zero-safe range parse: unlike the display-path parser
    (contracts.timefmt, which keeps reference parity), a start of 0 counts."""
    if isinstance(value, dict):
        start = end = None
        for key in ("start", "start_time", "begin"):
            if key in value and value[key] is not None:
                start = parse_time_value(value[key])
                break
        for key in ("end", "end_time", "finish"):
            if key in value and value[key] is not None:
                end = parse_time_value(value[key])
                break
        return start, end
    return parse_time_range(value)


def _section_time_range(section: dict[str, Any]) -> tuple[float | None, float | None]:
    for key in ("timestamp", "time_range", "timecode", "time"):
        if key in section:
            start, end = _parse_range(section.get(key))
            if start is not None or end is not None:
                return start, end
    return None, None


def offset_timestamps(data: dict[str, Any], offset: float) -> dict[str, Any]:
    """Shift segment-relative section timestamps to absolute video time.

    The engine emits "MM:SS" relative to the segment start (the DFA's
    timecode field); merging needs absolute positions.
    """
    if offset == 0:
        return data
    out = dict(data)
    chapters = []
    for chapter in as_chapters(out.get("deep_dive", []) or []):
        new_chapter = dict(chapter)
        sections = []
        for section in chapter.get("sections", []):
            if not isinstance(section, dict):
                continue
            new_section = dict(section)
            start, end = _section_time_range(section)
            if start is not None:
                shifted = {"start": start + offset}
                if end is not None:
                    shifted["end"] = end + offset
                new_section["timestamp"] = shifted
            sections.append(new_section)
        new_chapter["sections"] = sections
        chapters.append(new_chapter)
    out["deep_dive"] = chapters
    return out


def merge_segment_outputs(
    segment_outputs: list[SegmentOutput], gap_notes: list[str]
) -> dict[str, Any]:
    """Merge per-segment note JSON into one note (see module docstring)."""
    if not segment_outputs:
        raise ValueError("no segment outputs to merge")
    ordered = sorted(segment_outputs, key=lambda item: item.get("start", 0.0))
    first = ordered[0]["data"]

    takeaways: list[str] = []
    seen_takeaways: set[str] = set()
    glossary: dict[str, str] = {}
    seen_terms: dict[str, str] = {}
    deep_dive: list[dict[str, Any]] = []
    seen_sections: set[str] = set()
    last_end: float | None = None

    for item in ordered:
        data = item["data"]

        for takeaway in coerce_str_list(data.get("key_takeaways", [])):
            norm = normalize_text(takeaway)
            if norm and norm not in seen_takeaways:
                takeaways.append(takeaway)
                seen_takeaways.add(norm)

        raw_glossary = data.get("glossary", {})
        if isinstance(raw_glossary, dict):
            for term, definition in raw_glossary.items():
                term_text = str(term).strip()
                if not term_text:
                    continue
                norm = normalize_text(term_text)
                if norm in seen_terms:
                    existing = seen_terms[norm]
                    if not glossary.get(existing) and definition:
                        glossary[existing] = str(definition)
                    continue
                glossary[term_text] = str(definition)
                seen_terms[norm] = term_text

        for chapter in as_chapters(data.get("deep_dive", []) or []):
            sections = chapter.get("sections", [])
            if not isinstance(sections, list):
                continue
            kept: list[dict[str, Any]] = []
            for section in sections:
                if not isinstance(section, dict):
                    continue
                signature = _section_signature(section)
                if signature in seen_sections:
                    continue
                start, end = _section_time_range(section)
                # Drop sections whose coverage is behind the merge frontier:
                # those came from the ±overlap region already analyzed.
                if start is not None and last_end is not None and start <= last_end:
                    continue
                kept.append(section)
                seen_sections.add(signature)
                if end is not None:
                    last_end = max(last_end or 0.0, end)
                elif start is not None:
                    last_end = max(last_end or 0.0, start)
            if kept:
                deep_dive.append(
                    {
                        "chapter_title": chapter.get("chapter_title", ""),
                        "chapter_summary": chapter.get("chapter_summary", ""),
                        "sections": kept,
                    }
                )

    if gap_notes:
        takeaways.append(f"注意：以下片段未覆盖或分析失败：{'、'.join(gap_notes)}")

    merged: dict[str, Any] = {
        "title": first.get("title", ""),
        "one_sentence_summary": first.get("one_sentence_summary", ""),
        "key_takeaways": takeaways,
        "deep_dive": deep_dive,
        "glossary": glossary,
    }
    if "visual_schemas" in first:
        merged["visual_schemas"] = first.get("visual_schemas", [])
    elif "visual_schema" in first:
        merged["visual_schema"] = first.get("visual_schema", "")
    return merged


_CONSOLIDATION_REQUIRED = {
    "title",
    "one_sentence_summary",
    "key_takeaways",
    "deep_dive",
    "glossary",
}


def _grounded_in(candidate: str, source: str, threshold: float = 0.6) -> bool:
    """True when >= threshold of the candidate's character bigrams occur in
    the source (both normalized). Short candidates fall back to substring
    containment of their characters."""
    if not candidate:
        return False
    if len(candidate) < 2:
        return candidate in source
    bigrams = [candidate[i : i + 2] for i in range(len(candidate) - 1)]
    hits = sum(1 for b in bigrams if b in source)
    return hits / len(bigrams) >= threshold


def accept_consolidation(
    parsed: Any, merged: dict[str, Any]
) -> dict[str, Any] | None:
    """Validate a consolidation candidate; None when it must be rejected.

    Acceptance: full field set, 2-6 chapters, no duplicate (normalized)
    chapter titles. Visual schemas are inherited from the merged note when
    the candidate lacks them.
    """
    if not isinstance(parsed, dict):
        return None
    if _CONSOLIDATION_REQUIRED - parsed.keys():
        return None
    chapters = as_chapters(parsed.get("deep_dive", []) or [])
    if not 2 <= len(chapters) <= 6:
        return None
    # Content grounding: a consolidation may only REORGANIZE the merged
    # note, not invent chapters. Every candidate chapter title must draw
    # its terms from the source text (bigram overlap) or the candidate is
    # rejected — the deterministic analog of the reference's "strict
    # acceptance" against a competent judge.
    source = normalize_text(json.dumps(merged, ensure_ascii=False))
    seen: set[str] = set()
    for chapter in chapters:
        norm = normalize_text(str(chapter.get("chapter_title", "")))
        if norm in seen:
            return None
        seen.add(norm)
        if not _grounded_in(norm, source):
            return None
    out = dict(parsed, deep_dive=chapters)
    if "visual_schemas" in merged and "visual_schemas" not in out:
        out["visual_schemas"] = merged.get("visual_schemas", [])
    elif "visual_schema" in merged and "visual_schema" not in out:
        out["visual_schema"] = merged.get("visual_schema", "")
    return out
