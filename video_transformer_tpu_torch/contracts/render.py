"""Markdown renderers for KnowledgeDocument.

This package's own copy of the JAX package's ``contracts/render.py``, pinned to it by
the CPU parity tests (``tests/test_torch_contracts.py``).

Five render modes, matching the reference's byte-level output contract
(the reference's src/analyzer/models.py:64-644):

- "static" / "interactive" / "questions_only": legacy v2 active-learning
  layout (per-section challenge/code/explanation/self-check blocks).
- "default": Core+Appendix layout — compact main content, full detail in the
  appendix, chapter-level self-check, coverage index.
- "lecture": textbook layout — concept map, stitched chapter narration,
  code/appendix separation, FAQ, exercises.

The renderer is deliberately organized as one function per mode plus shared
section renderers, so new modes can be registered without touching the data
model.
"""

from __future__ import annotations

import re
from typing import Any, Protocol

from .normalize import as_chapters, coerce_str_list, normalize_field_value
from .timefmt import section_timestamp

__all__ = ["render_markdown", "normalize_mode", "sanitize_lecture_text", "MODES"]

MODES = ("static", "interactive", "questions_only", "default", "lecture")


class DocumentLike(Protocol):
    title: str
    one_sentence_summary: str
    key_takeaways: list[str]
    deep_dive: list[dict[str, Any]]
    glossary: dict[str, str]
    visual_schemas: list[Any]  # VisualSchemaItem


def normalize_mode(mode: str) -> str:
    normalized = (mode or "").strip().lower()
    return normalized if normalized in MODES else "static"


def render_markdown(
    doc: DocumentLike,
    image_paths: list[str] | None = None,
    self_check_mode: str = "static",
    include_concept_index: bool | None = None,
) -> str:
    """Render a KnowledgeDocument into Markdown in the given mode."""
    mode = normalize_mode(self_check_mode)
    if mode == "default":
        return _render_default(doc, image_paths)
    if mode == "lecture":
        return _render_lecture(doc, image_paths, include_concept_index)
    return _render_legacy(doc, image_paths, mode)


# ---------------------------------------------------------------------------
# Shared fragments
# ---------------------------------------------------------------------------


def _header_lines(doc: DocumentLike) -> list[str]:
    lines = [
        f"# {doc.title}",
        "",
        "> 🎯 **一句话核心**",
        f"> {doc.one_sentence_summary}",
        "",
        "## 📝 关键结论 (Key Takeaways)",
        "",
    ]
    for point in doc.key_takeaways:
        lines.append(f"- {point}")
    lines.append("")
    return lines


def _image_lines(doc: DocumentLike, image_paths: list[str] | None) -> list[str]:
    if not image_paths:
        return []
    lines = ["## 🖼️ 核心图解 (Visual Architecture)", ""]
    for idx, img_path in enumerate(image_paths):
        desc = ""
        if idx < len(doc.visual_schemas):
            desc = doc.visual_schemas[idx].description
        label = desc if desc else f"知识蓝图 {idx + 1}"
        lines.append(f"**{label}**")
        lines.append("")
        lines.append(f"![{label}]({img_path})")
        lines.append("")
    return lines


def _glossary_lines(doc: DocumentLike) -> list[str]:
    if not doc.glossary:
        return []
    lines = ["## 📖 关键术语表 (Glossary)", ""]
    for term, definition in doc.glossary.items():
        lines.append(f"- **{term}**: {definition}")
    lines.append("")
    return lines


def _section_heading(num: int, section: dict[str, Any]) -> str:
    topic = section.get("topic", "未知主题")
    stamp = section_timestamp(section)
    return f"#### {num}. {topic} {stamp}" if stamp else f"#### {num}. {topic}"


def _self_check_items(section: dict[str, Any]) -> list[dict[str, str]]:
    raw = section.get("self_check", [])
    if not isinstance(raw, list):
        return []
    return [i for i in raw if isinstance(i, dict) and "q" in i and "a" in i]


# ---------------------------------------------------------------------------
# Legacy v2 mode (static / interactive / questions_only)
# ---------------------------------------------------------------------------


def _render_legacy(
    doc: DocumentLike, image_paths: list[str] | None, mode: str
) -> str:
    lines = _header_lines(doc)
    lines.extend(_image_lines(doc, image_paths))
    lines.extend(["## 🔍 深度解析 (Deep Dive)", ""])

    chapter_num = 0
    section_num = 0
    legacy_answers: list[str] = []

    for chapter in doc.deep_dive:
        chapter_num += 1
        # Flat legacy sections (no chapter wrapper) render directly.
        if "topic" in chapter and "chapter_title" not in chapter:
            section_num += 1
            answers = _render_section_v2(lines, section_num, chapter, mode)
            if mode == "static" and answers:
                legacy_answers.extend(answers)
            continue

        title = chapter.get("chapter_title", f"第{chapter_num}章")
        summary = chapter.get("chapter_summary", "")
        lines.append(f"### 第{chapter_num}章：{title}")
        lines.append("")
        if summary:
            lines.append(f"> {summary}")
            lines.append("")

        chapter_answers: list[str] = []
        for section in chapter.get("sections", []):
            section_num += 1
            answers = _render_section_v2(lines, section_num, section, mode)
            if mode == "static" and answers:
                chapter_answers.extend(answers)

        if mode == "static" and chapter_answers:
            lines.append("#### 📌 本章自测答案")
            lines.append("")
            lines.extend(chapter_answers)

    if mode == "static" and legacy_answers:
        lines.append("### 📌 自测答案")
        lines.append("")
        lines.extend(legacy_answers)

    lines.extend(_glossary_lines(doc))
    return "\n".join(lines)


def _render_section_v2(
    lines: list[str], num: int, section: dict[str, Any], mode: str
) -> list[str]:
    """Render one section in active-learning (v2) layout, v1 fallback.

    Returns the answer lines to collect at chapter end in static mode.
    """
    explanation = section.get("explanation", "")
    example = section.get("example", "")
    code = section.get("code", "")
    connections = section.get("connections", [])
    answer_lines: list[str] = []

    challenge = coerce_str_list(section.get("challenge", []))
    common_mistakes = coerce_str_list(section.get("common_mistakes", []))
    self_check = _self_check_items(section)
    use_v2 = bool(challenge or self_check or common_mistakes)

    lines.append(_section_heading(num, section))

    if use_v2:
        if challenge:
            lines.append("")
            lines.append("**🧩 挑战（先想 20 秒再往下看）**：")
            for c in challenge:
                lines.append(f"- {c}")
            lines.append("")
        if code:
            lines.append("**💻 代码先行**：")
            lines.append("```python")
            lines.append(f"{code}")
            lines.append("```")
            lines.append("")
        if explanation:
            lines.append("**💡 原理拆解**：")
            lines.append(f"{explanation}")
            lines.append("")
        if example:
            lines.append("**🌰 自包含示例（输入 → 过程 → 输出）**：")
            lines.append(f"> {example}")
            lines.append("")
        if common_mistakes:
            lines.append("**⚠️ 常见误区**：")
            for m in common_mistakes:
                lines.append(f"- {m}")
            lines.append("")
        if self_check:
            lines.append("**✅ 自测（做完再看答案）**：")
            topic = section.get("topic", "未知主题")
            question_lines: list[str] = []
            include_answers = mode in {"static", "interactive"}
            for idx, qa in enumerate(self_check, 1):
                label = f"Q{num}.{idx}"
                question = str(qa["q"]).strip()
                question_lines.append(f"- {label}：{question}")
                if include_answers:
                    answer_lines.append(f"- {label}（{topic}）：{question}")
                    answer_lines.append(f"  答案：{qa['a']}")
                    answer_lines.append("")
            lines.extend(question_lines)
            lines.append("")
            if mode == "interactive" and answer_lines:
                lines.append("<details>")
                lines.append("<summary>点击展开答案</summary>")
                lines.append("")
                lines.extend(answer_lines)
                lines.append("</details>")
                lines.append("")
        if connections:
            lines.append("**🔗 关联知识**：")
            for conn in connections:
                lines.append(f"- {conn}")
            lines.append("")
    else:
        lines.append("**💡 原理解析**：")
        lines.append(f"{explanation}")
        lines.append("")
        if example:
            lines.append("**🌰 举个栗子**：")
            lines.append(f"> {example}")
            lines.append("")
        if code:
            lines.append("**💻 代码演示**：")
            lines.append("```python")
            lines.append(f"{code}")
            lines.append("```")
            lines.append("")
        if connections:
            lines.append("**🔗 关联知识**：")
            for conn in connections:
                lines.append(f"- {conn}")
            lines.append("")

    return answer_lines if mode == "static" else []


# ---------------------------------------------------------------------------
# Default mode (Core + Appendix)
# ---------------------------------------------------------------------------


def _render_default(doc: DocumentLike, image_paths: list[str] | None) -> str:
    lines = _header_lines(doc)
    lines.extend(_image_lines(doc, image_paths))
    lines.extend(["## 🔍 深度解析 (Deep Dive)", ""])

    chapters = as_chapters(doc.deep_dive)
    appendix: list[str] = []
    coverage: list[str] = []
    section_num = 0

    for chapter_num, chapter in enumerate(chapters, 1):
        title = chapter.get("chapter_title", f"第{chapter_num}章")
        summary = chapter.get("chapter_summary", "")
        sections = chapter.get("sections", [])

        lines.append(f"### 第{chapter_num}章：{title}")
        lines.append("")
        if summary:
            lines.append(f"> {summary}")
            lines.append("")
        coverage.append(f"- 第{chapter_num}章：{title}")

        appendix.append(f"### 第{chapter_num}章：{title}")
        appendix.append("")
        if summary:
            appendix.append(f"> {summary}")
            appendix.append("")

        chapter_questions: list[dict[str, str]] = []
        for section in sections:
            section_num += 1
            _render_section_compact(lines, section_num, section)
            appendix.extend(_render_section_appendix(section_num, section))
            coverage.append(f"- {section.get('topic', '未知主题')}")
            chapter_questions.extend(_self_check_items(section))

        if chapter_questions:
            lines.append(f"### 📋 第{chapter_num}章自测")
            lines.append("")
            for idx, qa in enumerate(chapter_questions, 1):
                label = f"Q{chapter_num}.{idx}"
                lines.append(f"- {label}：{str(qa['q']).strip()}")
                lines.append(f"- {label} -> 答案：{str(qa['a']).strip()}")
            lines.append("")

    lines.extend(["## 📌 覆盖清单 (Coverage Index)", ""])
    lines.extend(coverage)
    lines.append("")

    lines.extend(["## 📎 附录 (Appendix)", ""])
    if appendix:
        lines.extend(appendix)
    else:
        lines.append("- （无附录内容）")
    lines.append("")

    lines.extend(_glossary_lines(doc))
    return "\n".join(lines)


def _render_section_compact(
    lines: list[str], num: int, section: dict[str, Any]
) -> None:
    lines.append(_section_heading(num, section))
    lines.append("")
    explanation = section.get("explanation", "")
    example = section.get("example", "")
    if explanation:
        lines.append("**💡 原理解析**：")
        lines.append(f"{explanation}")
        lines.append("")
    if example:
        lines.append("**🌰 示例**：")
        lines.append(f"> {example}")
        lines.append("")


def _render_section_appendix(num: int, section: dict[str, Any]) -> list[str]:
    lines: list[str] = [_section_heading(num, section), ""]
    explanation = section.get("explanation", "")
    example = section.get("example", "")
    code = section.get("code", "")
    connections = section.get("connections", [])
    common_mistakes = coerce_str_list(section.get("common_mistakes", []))

    if explanation:
        lines.append("**💡 原理拆解**：")
        lines.append(f"{explanation}")
        lines.append("")
    if example:
        lines.append("**🌰 自包含示例**：")
        lines.append(f"> {example}")
        lines.append("")
    if code:
        lines.append("**💻 完整代码**：")
        lines.append("```python")
        lines.append(f"{code}")
        lines.append("```")
        lines.append("")
    if common_mistakes:
        lines.append("**⚠️ 常见误区**：")
        for m in common_mistakes:
            lines.append(f"- {m}")
        lines.append("")
    if connections:
        lines.append("**🔗 关联知识**：")
        for conn in connections:
            lines.append(f"- {conn}")
        lines.append("")
    return lines


# ---------------------------------------------------------------------------
# Lecture mode (textbook layout)
# ---------------------------------------------------------------------------

_LECTURE_SCRUB_PATTERNS = [
    r"\$[^$]+\$",
    r"\\\([^)]+\\\)",
    r"\\\[[^\]]+\\\]",
    r"<details>",
    r"</details>",
    r"<summary>",
    r"</summary>",
    r"\b\d{1,2}:\d{2}\b",
    r"\(\d{1,2}:\d{2}[–—-]\d{1,2}:\d{2}\)",
]

_SENTENCE_SPLIT_RE = re.compile(r"[。！？!?]")
_CLOCK_IN_TEXT_RE = re.compile(r"\b\d{1,2}:\d{2}(:\d{2})?\b")
_RANGE_ARTIFACT_RE = re.compile(r":\d{2}\s*[-–—]\s*:\d{2}")
_FULL_RANGE_RE = re.compile(r"\b\d{1,2}:\d{2}\s*[-–—]\s*\d{1,2}:\d{2}\b")


def sanitize_lecture_text(text: Any) -> str:
    """Strip LaTeX, HTML details tags, and bare timecodes from lecture text.

    Mirrors reference models.py:988-1016.
    """
    if text is None:
        return ""
    if not isinstance(text, str):
        text = str(text)
    cleaned_lines: list[str] = []
    for line in text.splitlines():
        cleaned = line
        for pattern in _LECTURE_SCRUB_PATTERNS:
            cleaned = re.sub(pattern, "", cleaned)
        cleaned = " ".join(cleaned.split())
        if cleaned:
            cleaned_lines.append(cleaned)
    return "\n".join(cleaned_lines).strip()


def _is_gap_note_or_timecode(value: str) -> bool:
    text = (value or "").strip()
    if not text:
        return False
    if "未覆盖" in text or "分析失败" in text or "未分析" in text:
        return True
    if _CLOCK_IN_TEXT_RE.search(text):
        return True
    if _RANGE_ARTIFACT_RE.search(text):
        return True
    if _FULL_RANGE_RE.search(text):
        return True
    return False


def _render_lecture(
    doc: DocumentLike,
    image_paths: list[str] | None,
    include_concept_index: bool | None,
) -> str:
    if include_concept_index is None:
        include_concept_index = True

    def cleaned(value: Any) -> str:
        return sanitize_lecture_text(value)

    def cleaned_main(value: Any) -> str:
        return cleaned(value).replace("```", "").strip()

    def code_block(value: Any) -> str:
        text = cleaned(normalize_field_value(value))
        if not text:
            return ""
        return "\n".join(
            ln for ln in text.splitlines() if ln.strip() != "```"
        ).strip()

    def sentences(text: str) -> list[str]:
        if not text:
            return []
        return [p.strip() for p in _SENTENCE_SPLIT_RE.split(text) if p.strip()]

    def unique_sentences(text: str, seen: set[str]) -> list[str]:
        out = []
        for s in sentences(text):
            if s not in seen:
                seen.add(s)
                out.append(s)
        return out

    def chapter_topics(sections: list[dict[str, Any]]) -> list[str]:
        topics = []
        for section in sections:
            topic = cleaned_main(section.get("topic", ""))
            if topic:
                topics.append(topic)
        return topics

    lines: list[str] = [f"# {doc.title}", ""]
    chapters = as_chapters(doc.deep_dive) if doc.deep_dive else []

    # Concept map
    lines.extend(["## 核心概念图谱", ""])
    thesis = cleaned_main(doc.one_sentence_summary)
    if not thesis and doc.key_takeaways:
        thesis = cleaned_main(doc.key_takeaways[0])
    lines.append(thesis if thesis else "本讲围绕核心概念与实践脉络展开。")
    lines.append("")

    if chapters:
        for chapter_num, chapter in enumerate(chapters, 1):
            title = cleaned_main(chapter.get("chapter_title", f"第{chapter_num}章"))
            if not title:
                title = f"第{chapter_num}章"
            lines.append(f"- 第{chapter_num}章：{title}")
            topics = chapter_topics(chapter.get("sections", []))
            if topics:
                for topic in topics:
                    lines.append(f"  - {topic}")
            else:
                summary = cleaned_main(chapter.get("chapter_summary", ""))
                if summary:
                    lines.append(f"  - {summary}")
    else:
        lines.append("- 本讲围绕关键主题逐步展开")
    lines.append("")

    # Chapter narration
    lines.extend(["## 主题详解", ""])
    concept_index: list[str] = []
    code_blocks: list[tuple[str, str]] = []

    for chapter_num, chapter in enumerate(chapters, 1):
        title = cleaned_main(chapter.get("chapter_title", f"第{chapter_num}章"))
        if not title:
            title = f"第{chapter_num}章"
        summary = cleaned_main(chapter.get("chapter_summary", ""))
        chapter_sections = chapter.get("sections", [])

        lines.append(f"### 第{chapter_num}章：{title}")
        lines.append("")

        topics = chapter_topics(chapter_sections)
        if summary:
            lines.append(summary)
        elif topics:
            lines.append(f"本章围绕 {'、'.join(topics)} 展开。")
        else:
            lines.append(f"本章梳理 {title} 的关键问题与应用场景。")
        lines.append("")

        if title:
            concept_index.append(title)
        concept_index.extend(topics)

        stitched: list[str] = []
        seen: set[str] = set()
        for section in chapter_sections:
            explanation = cleaned_main(
                normalize_field_value(section.get("explanation", ""))
            )
            example = cleaned_main(normalize_field_value(section.get("example", "")))
            stitched.extend(unique_sentences(explanation, seen))
            stitched.extend(unique_sentences(example, seen))
            code = code_block(section.get("code", ""))
            if code:
                label = cleaned_main(section.get("topic", "")) or title
                code_blocks.append((label, code))

        lines.append("内容串讲：")
        lines.append("")
        if stitched:
            for sentence in stitched[:8]:
                lines.append(f"- {sentence}")
        else:
            lines.append(f"- 本章聚焦 {title} 的核心逻辑与落地路径。")
        lines.append("")

    if not chapters:
        lines.append("本讲内容以关键概念串联，暂无章节拆分。")
        lines.append("")

    # Practice + code
    lines.extend(["## 实战与代码", ""])
    if code_blocks:
        for idx, (label, code) in enumerate(code_blocks[:2], 1):
            lines.append(f"### 示例 {idx}：{label}")
            lines.append("")
            code_lines = [ln for ln in code.splitlines() if ln.strip()]
            if not code_lines:
                lines.append("本示例仅给出思路，代码略。")
                lines.append("")
                continue
            lines.append("代码：")
            lines.append("")
            for line_num, ln in enumerate(code_lines, 1):
                lines.append(f"{line_num}. {ln}")
            lines.append("")
    else:
        lines.append("本讲无可复用代码片段")
        lines.append("")

    # FAQ / pitfalls
    lines.extend(["## FAQ / 避坑指南", ""])
    pitfalls: list[str] = []
    for chapter in chapters:
        for section in chapter.get("sections", []):
            for mistake in coerce_str_list(section.get("common_mistakes", [])):
                text = cleaned_main(mistake)
                if text:
                    pitfalls.append(text)
    deduped: list[str] = []
    seen_pitfalls: set[str] = set()
    for p in pitfalls:
        if p not in seen_pitfalls:
            seen_pitfalls.add(p)
            deduped.append(p)
    if not deduped:
        deduped = [
            "只看训练效果，忽略验证集表现。",
            "关键假设未检验，导致结论偏差。",
        ]
    lines.append("常见坑：")
    lines.append("")
    for p in deduped[:6]:
        lines.append(f"- {p}")
    lines.append("")

    # Exercises (chapter-level self-check)
    exercises: list[tuple[str, str]] = []
    for chapter in chapters:
        raw = chapter.get("chapter_self_check", [])
        if isinstance(raw, list):
            for item in raw:
                if not isinstance(item, dict):
                    continue
                q = cleaned_main(item.get("q", ""))
                a = cleaned_main(item.get("a", ""))
                if q and a:
                    exercises.append((q, a))
    deduped_ex: list[tuple[str, str]] = []
    seen_q: set[str] = set()
    for q, a in exercises:
        if q not in seen_q:
            seen_q.add(q)
            deduped_ex.append((q, a))
    selected = deduped_ex[:4]
    if selected:
        lines.append("练习与答解：")
        lines.append("")
        for idx, (q, _) in enumerate(selected, 1):
            lines.append(f"{idx}. {q}")
        for _, a in selected:
            lines.append(f"答：{a}")
        lines.append("")

    # Appendix
    lines.extend(["## 📎 附录 (Appendix)", ""])
    lines.append("### 图解（知识蓝图）")
    lines.append("")
    if image_paths:
        for idx, img_path in enumerate(image_paths):
            desc = ""
            if idx < len(doc.visual_schemas):
                desc = cleaned(doc.visual_schemas[idx].description)
            label = desc if desc else f"知识蓝图 {idx + 1}"
            lines.append(f"**{label}**")
            lines.append("")
            lines.append(f"![{label}]({img_path})")
            lines.append("")
    elif doc.visual_schemas:
        for schema in doc.visual_schemas:
            description = cleaned(schema.description)
            if description:
                lines.append(f"- {description}")
            schema_text = cleaned(schema.schema)
            if schema_text:
                lines.append("```")
                lines.append(schema_text)
                lines.append("```")
                lines.append("")
    else:
        lines.append("- 暂无图解内容")
        lines.append("")

    lines.append("### 术语表（Glossary）")
    lines.append("")
    if doc.glossary:
        for term, definition in doc.glossary.items():
            t = cleaned(term)
            d = cleaned(definition)
            if t and d:
                lines.append(f"- **{t}**：{d}")
    else:
        lines.append("- 暂无术语补充")
    lines.append("")

    if include_concept_index:
        lines.append("### 概念索引（Concept Index）")
        lines.append("")
        index_items: list[str] = []
        if doc.key_takeaways:
            index_items.extend(cleaned(t) for t in doc.key_takeaways)
        index_items.extend(concept_index)
        if doc.glossary:
            index_items.extend(cleaned(k) for k in doc.glossary)
        seen_idx: set[str] = set()
        for item in index_items:
            if not item or _is_gap_note_or_timecode(item):
                continue
            if item in seen_idx:
                continue
            seen_idx.add(item)
            lines.append(f"- {item}")
        if not seen_idx:
            lines.append("- 暂无概念索引")
        lines.append("")

    lines.append("### 代码与伪代码")
    lines.append("")
    if code_blocks:
        for label, code in code_blocks:
            if label:
                lines.append(f"**{label}**")
                lines.append("")
            lines.append("```python")
            lines.append(code)
            lines.append("```")
            lines.append("")
    else:
        lines.append("- 本讲无可复用代码片段")
        lines.append("")

    return "\n".join(lines)
