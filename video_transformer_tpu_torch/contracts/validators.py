"""Markdown structure validation and stub-output detection.

This package's own copy of the JAX package's ``contracts/validators.py``, pinned to it by
the CPU parity tests (``tests/test_torch_contracts.py``).

Behavioral contract shared with the reference implementation
(the reference's src/analyzer/validators.py): the heading/pattern constants
and the exact error strings are cross-checked by downstream tooling and the
render-contract tests, so they are byte-identical; the checking machinery is
this repo's own rule-pipeline.
"""

from __future__ import annotations

import re
from typing import Protocol

__all__ = [
    "APPENDIX_HEADING",
    "REQUIRED_HEADINGS_DEFAULT",
    "FORBIDDEN_PATTERNS_DEFAULT",
    "validate_markdown_structure",
    "detect_stub_output",
    "validate_knowledge_document",
]

APPENDIX_HEADING = "## 📎 附录 (Appendix)"
REQUIRED_HEADINGS_DEFAULT = [
    "## 📌 覆盖清单 (Coverage Index)",
    APPENDIX_HEADING,
]
FORBIDDEN_PATTERNS_DEFAULT = [
    "**🧩 挑战",
    "**✅ 自测（做完再看答案）**",
]

_HEADING = re.compile(r"^#{1,6}\s+")
# Strips blockquote/bullet/ordered-list prefixes in one pass.
_LIST_PREFIXES = re.compile(r"^(?:\s*>+\s*)?(?:\s*[-*+]\s+)?(?:\s*\d+\.\s+)?")
_SUBSTANCE = re.compile(r"[A-Za-z0-9一-鿿]")


def _default_mode_rules(markdown: str) -> list[str]:
    """Error messages for the 'default' render mode's hard requirements."""
    rules: list[tuple[bool, str]] = []
    rules += [
        (heading not in markdown, f"缺少必需标题: {heading}")
        for heading in REQUIRED_HEADINGS_DEFAULT
    ]
    rules += [
        (pattern in markdown, f"禁用内容命中: {pattern}")
        for pattern in FORBIDDEN_PATTERNS_DEFAULT
    ]
    appendix = markdown.find(APPENDIX_HEADING)
    fence = markdown.find("```")
    rules.append(
        (appendix >= 0 and 0 <= fence < appendix, "代码围栏出现在附录之前")
    )
    return [message for failed, message in rules if failed]


def validate_markdown_structure(markdown: str, mode: str) -> tuple[bool, list[str]]:
    """Check structural rules for the given render mode.

    Only "default" mode has hard structural requirements; other modes always
    pass. Returns (ok, errors).
    """
    if (mode or "").strip().lower() != "default":
        return True, []
    errors = _default_mode_rules(markdown)
    return not errors, errors


def _looks_like_bare_report_label(markdown: str) -> bool:
    collapsed = " ".join(markdown.lower().split())
    if collapsed in ("final report", "final report.", "final"):
        return True
    return collapsed.startswith("final report") and len(collapsed) <= 30


def _meaningful_lines(markdown: str) -> list[str]:
    """Non-blank lines that aren't pure markup (rules, fences are kept as
    markers for the section check but excluded from substance)."""
    return [line.strip() for line in markdown.splitlines() if line.strip()]


def _carries_substance(line: str) -> bool:
    if line.startswith(("#", "```")) or line in ("---", "***"):
        return False
    return bool(_SUBSTANCE.search(_LIST_PREFIXES.sub("", line)))


def _adjacent_headings(lines: list[str]) -> bool:
    """Two headings with nothing but blank lines between = empty section."""
    return any(
        _HEADING.match(a) and _HEADING.match(b)
        for a, b in zip(lines, lines[1:])
    )


def detect_stub_output(markdown: str) -> bool:
    """Placeholder / empty generations: bare 'final report' labels, documents
    with no substantive text, or any heading-then-heading empty section."""
    if not markdown.strip():
        return True
    if _looks_like_bare_report_label(markdown):
        return True
    lines = _meaningful_lines(markdown)
    if not any(_carries_substance(line) for line in lines):
        return True
    return _adjacent_headings(lines)


class _DocumentLike(Protocol):
    def to_markdown(
        self,
        image_paths: list[str] | None = None,
        self_check_mode: str = "static",
        include_concept_index: bool | None = None,
    ) -> str: ...


def validate_knowledge_document(
    doc: _DocumentLike, mode: str
) -> tuple[bool, list[str]]:
    """Render a document and run both stub detection and structure checks."""
    markdown = doc.to_markdown(self_check_mode=mode)
    errors: list[str] = []
    if detect_stub_output(markdown):
        errors.append("检测到疑似占位/空内容输出")
    errors.extend(validate_markdown_structure(markdown, mode)[1])
    return not errors, errors
