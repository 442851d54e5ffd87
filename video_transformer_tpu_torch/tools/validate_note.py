"""Offline note linter: pandoc/PDF-readiness checks over generated notes.

This package's own copy of the JAX package's ``tools/validate_note.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

Capability parity with reference src/tools/validate_note.py: title check,
format detection (lecture/textbook vs deep-lecture vs legacy),
required-section checks, per-chapter pedagogical skeleton for the deep
format (8 required #### subsections, >=3 numbered exercises — reference
validate_note.py:61-70,183), forbidden patterns (inline/display LaTeX,
HTML details, placeholder text, python dict-repr leaks, stock template
garbage), bare timestamps in main text — profile-aware ("pdf" allows
display math and TikZ fences).

CLI: python -m video_transformer_tpu_torch.tools.validate_note NOTE.md [--profile pdf]
"""

from __future__ import annotations

import argparse
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["NoteReport", "validate_note", "validate_file", "main"]

LECTURE_REQUIRED_SECTIONS = (
    "## 核心概念图谱",
    "## 主题详解",
    "## 实战与代码",
    "## FAQ / 避坑指南",
    "## 📎 附录 (Appendix)",
)
# The reference's long-form deep-lecture layout (validate_note.py:40-47
# REQUIRED_SECTIONS there): per-chapter pedagogical skeleton enforced.
DEEP_REQUIRED_SECTIONS = (
    "## 学习目标",
    "## 先修知识与快速回顾",
    "## 学习路线图（本讲你会走到哪里）",
    "## 🔍 讲义正文",
    "## 📌 覆盖清单 (Coverage Index)",
    "## 📎 附录 (Appendix)",
)
LEGACY_REQUIRED_SECTIONS = (
    "## 📝 关键结论 (Key Takeaways)",
    "## 🔍 深度解析 (Deep Dive)",
)

# Every lecture chapter must carry the full pedagogical skeleton
# (reference src/tools/validate_note.py:61-70 REQUIRED_CHAPTER_SUBSECTIONS).
CHAPTER_REQUIRED_SUBSECTIONS = (
    "#### 动机：为什么要学这个？",
    "#### 直觉：用一句话抓住本质",
    "#### 推导/机制：用纯文本公式讲清楚",
    "#### 工程实践：怎么用、怎么调、怎么排查",
    "#### 示例：输入→步骤→输出",
    "#### 常见误区：错在哪里/怎么改",
    "#### 本章练习",
    "#### 本章参考答案",
)
_CHAPTER_HEAD_RE = re.compile(r"^###\s+第\d+章：", re.MULTILINE)
_EXERCISE_BLOCK_RE = re.compile(r"####\s+本章练习\s*\n(.*?)(?=####|\Z)", re.DOTALL)
_NUMBERED_ITEM_RE = re.compile(r"^\d+\.", re.MULTILINE)

# Patterns that should never appear in prose output.
_INLINE_MATH_RE = re.compile(r"(?<!\$)\$[^$\n]+\$(?!\$)")
_LATEX_PAREN_RE = re.compile(r"\\\([^)]*\\\)")
_LATEX_BRACKET_RE = re.compile(r"\\\[[^\]]*\\\]")
_HTML_DETAILS_RE = re.compile(r"</?(?:details|summary)>")
_DICT_REPR_RE = re.compile(r"\{'[^']+':")
_PLACEHOLDER_RE = re.compile(r"(?:TODO|FIXME|XXX|占位符|待补充|未在源笔记中显式给出|\bTBD\b)")
_BARE_TIMESTAMP_RE = re.compile(r"(?<![\d:])\b\d{1,2}:\d{2}(?::\d{2})?\b")
_TIKZ_FENCE_RE = re.compile(r"```\{=latex\}")
_DISPLAY_MATH_RE = re.compile(r"\$\$")
# Template/garbage leaks the reference screens for (validate_note.py:90-96):
# stock filler sentences and the broken ":MM-:MM" timestamp artifact.
_GARBAGE_RES = {
    "模板占位句(完成关键计算或调用步骤)": re.compile(r"完成关键计算或调用步骤"),
    "模板练习句(因为 X 直接影响…)": re.compile(
        r"因为 X 直接影响核心流程的效果与可解释性"
    ),
    "残缺时间戳(:MM-:MM)": re.compile(r":\d{2}-:\d{2}"),
}


@dataclass
class NoteReport:
    path: str = ""
    format: str = "unknown"  # lecture | deep | legacy | unknown
    errors: list[str] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def detect_format(markdown: str) -> str:
    if any(marker in markdown for marker in LECTURE_REQUIRED_SECTIONS[:2]):
        return "lecture"
    if any(marker in markdown for marker in DEEP_REQUIRED_SECTIONS[:4]):
        return "deep"
    if any(marker in markdown for marker in LEGACY_REQUIRED_SECTIONS):
        return "legacy"
    return "unknown"


def _main_text(markdown: str) -> str:
    """Everything before the appendix (timestamps are allowed in appendix)."""
    idx = markdown.find("## 📎 附录 (Appendix)")
    return markdown if idx == -1 else markdown[:idx]


def _outside_code_fences(markdown: str) -> str:
    out: list[str] = []
    in_fence = False
    for line in markdown.splitlines():
        if line.strip().startswith("```"):
            in_fence = not in_fence
            continue
        if not in_fence:
            out.append(line)
    return "\n".join(out)


def _check_chapters(markdown: str) -> list[str]:
    """Per-chapter structure: each ### 第N章 must contain all eight ####
    subsections, and 本章练习 must list at least 3 numbered exercises."""
    heads = list(_CHAPTER_HEAD_RE.finditer(markdown))
    if not heads:
        return ["主题详解缺少章节 (### 第N章：)"]
    errors: list[str] = []
    spans = [h.start() for h in heads] + [len(markdown)]
    for head, start, end in zip(heads, spans[:-1], spans[1:]):
        body = markdown[start:end]
        title = head.group(0).strip()
        for subsection in CHAPTER_REQUIRED_SUBSECTIONS:
            if subsection not in body:
                errors.append(f"{title} 缺少必需小节: {subsection}")
        exercises = _EXERCISE_BLOCK_RE.search(body)
        if exercises:
            count = len(_NUMBERED_ITEM_RE.findall(exercises.group(1)))
            if count < 3:
                errors.append(f"{title} 练习数量不足 ({count} < 3)")
    return errors


def validate_note(markdown: str, profile: str = "default") -> NoteReport:
    report = NoteReport()
    report.format = detect_format(markdown)

    lines = markdown.splitlines()
    if not lines or not lines[0].startswith("# ") or len(lines[0]) <= 2:
        report.errors.append("缺少一级标题 (# 标题)")

    required = {
        "lecture": LECTURE_REQUIRED_SECTIONS,
        "deep": DEEP_REQUIRED_SECTIONS,
    }.get(report.format, LEGACY_REQUIRED_SECTIONS)
    if report.format == "unknown":
        report.errors.append("无法识别笔记格式 (lecture / legacy)")
    else:
        for section in required:
            if section not in markdown:
                report.errors.append(f"缺少必需章节: {section}")

    if report.format == "lecture":
        # Textbook layout needs chapters, but their inner skeleton is free.
        if not _CHAPTER_HEAD_RE.search(markdown):
            report.errors.append("主题详解缺少章节 (### 第N章：)")
    elif report.format == "deep":
        report.errors.extend(_check_chapters(markdown))

    prose = _outside_code_fences(markdown)

    if profile != "pdf":
        if _DISPLAY_MATH_RE.search(prose):
            report.errors.append("默认 profile 不允许 display math ($$)")
        if _TIKZ_FENCE_RE.search(markdown):
            report.errors.append("默认 profile 不允许 TikZ 代码块")
    if _INLINE_MATH_RE.search(prose):
        report.errors.append("正文包含内联 LaTeX 公式 ($...$)")
    if _LATEX_PAREN_RE.search(prose):
        report.errors.append("正文包含 \\(...\\) LaTeX 标记")
    if _LATEX_BRACKET_RE.search(prose) and profile != "pdf":
        report.errors.append("正文包含 \\[...\\] display LaTeX 标记")
    if _HTML_DETAILS_RE.search(prose):
        report.errors.append("正文包含 HTML details/summary 标签")
    if _DICT_REPR_RE.search(prose):
        report.errors.append("正文疑似泄漏 Python dict 字面量")
    if _PLACEHOLDER_RE.search(prose):
        report.warnings.append("正文包含占位符文本")
    for label, pattern in _GARBAGE_RES.items():
        if pattern.search(prose):
            report.errors.append(f"正文包含垃圾输出: {label}")

    if report.format in ("lecture", "deep"):
        main_prose = _outside_code_fences(_main_text(markdown))
        stamps = _BARE_TIMESTAMP_RE.findall(main_prose)
        if stamps:
            report.warnings.append(
                f"主文包含 {len(stamps)} 个裸时间戳 (应只出现在附录)"
            )

    return report


def validate_file(path: str | Path, profile: str = "default") -> NoteReport:
    path = Path(path)
    report = validate_note(path.read_text(encoding="utf-8"), profile)
    report.path = str(path)
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="validate generated notes")
    parser.add_argument("paths", nargs="+", help="note markdown files")
    parser.add_argument("--profile", default="default", choices=["default", "pdf"])
    args = parser.parse_args(argv)

    failed = 0
    for path in args.paths:
        report = validate_file(path, args.profile)
        status = "PASS" if report.ok else "FAIL"
        print(f"[{status}] {path} (format={report.format})")
        for error in report.errors:
            print(f"  error: {error}")
        for warning in report.warnings:
            print(f"  warn:  {warning}")
        if not report.ok:
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
