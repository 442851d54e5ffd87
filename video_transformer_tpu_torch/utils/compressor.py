"""Note compressor: long note -> bounded-length chaptered digest.

This package's own copy of the JAX package's ``utils/compressor.py``:
topics are parsed from any lecture or legacy note, grouped into at most
``max_chapters`` chapters in their order, and re-emitted as a digest capped
at ``max_lines``. The digest is byte-equal to the JAX package's.

CLI: python -m video_transformer_tpu_torch.utils.compressor NOTE.md -o OUT.md
"""

from __future__ import annotations

import argparse
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Topic", "parse_topics", "build_digest", "compress_note", "main"]

_CHAPTER_RE = re.compile(r"^### 第(\d+)章：(.+)$")
_TOPIC_RE = re.compile(r"^####\s+(?:\d+\.\s+)?(.+?)(?:\s+\(\d.*\))?$")


@dataclass
class Topic:
    title: str
    chapter: str
    bullets: list[str] = field(default_factory=list)


_MAP_CHAPTER_RE = re.compile(r"^- 第(\d+)章：(.+)$")
_MAP_TOPIC_RE = re.compile(r"^  - (.+)$")


def parse_topics(markdown: str) -> list[Topic]:
    """Extract topics with their first few content bullets.

    Legacy notes carry topics as `#### N. topic` section headings; lecture
    notes carry them as concept-map sub-bullets (with 内容串讲 bullets as
    the supporting content).
    """
    topics = _parse_legacy_topics(markdown)
    if topics:
        return topics
    return _parse_lecture_topics(markdown)


def _parse_legacy_topics(markdown: str) -> list[Topic]:
    topics: list[Topic] = []
    chapter = ""
    for line in markdown.splitlines():
        chapter_match = _CHAPTER_RE.match(line.strip())
        if chapter_match:
            chapter = chapter_match.group(2).strip()
            continue
        topic_match = _TOPIC_RE.match(line.strip())
        if line.startswith("#### ") and topic_match:
            title = topic_match.group(1).strip()
            if title.startswith(("📌", "📋", "补充：")):
                continue
            topics.append(Topic(title=title, chapter=chapter))
            continue
        if topics and line.strip().startswith("- ") and len(topics[-1].bullets) < 2:
            text = line.strip()[2:].strip()
            if text:
                topics[-1].bullets.append(text)
    return topics


def _parse_lecture_topics(markdown: str) -> list[Topic]:
    """Concept-map sub-bullets become topics; 内容串讲 bullets back them."""
    topics: list[Topic] = []
    chapter = ""
    in_map = False
    narration_chapter = ""
    narration: dict[str, list[str]] = {}

    for line in markdown.splitlines():
        if line.startswith("## "):
            in_map = line.strip() == "## 核心概念图谱"
        if in_map:
            chapter_match = _MAP_CHAPTER_RE.match(line)
            if chapter_match:
                chapter = chapter_match.group(2).strip()
                continue
            topic_match = _MAP_TOPIC_RE.match(line)
            if topic_match and chapter:
                topics.append(Topic(title=topic_match.group(1).strip(), chapter=chapter))
                continue
        chapter_heading = _CHAPTER_RE.match(line.strip())
        if chapter_heading:
            narration_chapter = chapter_heading.group(2).strip()
            narration.setdefault(narration_chapter, [])
            continue
        if narration_chapter and line.strip().startswith("- "):
            narration[narration_chapter].append(line.strip()[2:].strip())

    # Attach the chapter's narration bullets to its first topic.
    seen_chapters: set[str] = set()
    for topic in topics:
        if topic.chapter not in seen_chapters:
            seen_chapters.add(topic.chapter)
            topic.bullets = narration.get(topic.chapter, [])[:2]
    return topics


def build_digest(
    title: str,
    topics: list[Topic],
    max_chapters: int = 6,
    max_lines: int = 300,
) -> str:
    """Group topics into <= max_chapters ordered chapters, cap total lines."""
    if not topics:
        return f"# {title}（精简版）\n\n（无可压缩主题）\n"

    # Preserve original chapter grouping, merging the tail when over limit.
    ordered_chapters: list[str] = []
    for topic in topics:
        name = topic.chapter or "核心内容"
        if name not in ordered_chapters:
            ordered_chapters.append(name)
    if len(ordered_chapters) > max_chapters:
        keep = ordered_chapters[: max_chapters - 1]
        merge_name = "综合与补充"
        mapping = {
            name: (name if name in keep else merge_name)
            for name in ordered_chapters
        }
        ordered_chapters = keep + [merge_name]
    else:
        mapping = {name: name for name in ordered_chapters}

    grouped: dict[str, list[Topic]] = {name: [] for name in ordered_chapters}
    for topic in topics:
        grouped[mapping[topic.chapter or "核心内容"]].append(topic)

    lines: list[str] = [f"# {title}（精简版）", ""]
    for idx, name in enumerate(ordered_chapters, 1):
        chapter_topics = grouped[name]
        if not chapter_topics:
            continue
        lines.append(f"## 第{idx}章：{name}")
        lines.append("")
        for topic in chapter_topics:
            lines.append(f"- **{topic.title}**")
            for bullet in topic.bullets[:1]:
                lines.append(f"  - {bullet}")
        lines.append("")
        if len(lines) > max_lines:
            break

    if len(lines) > max_lines:
        lines = lines[: max_lines - 1] + ["…（已截断）"]
    return "\n".join(lines) + "\n"


def compress_note(
    markdown: str, max_chapters: int = 6, max_lines: int = 300
) -> str:
    first_line = markdown.splitlines()[0] if markdown.splitlines() else "# 笔记"
    title = first_line.lstrip("# ").strip() or "笔记"
    return build_digest(title, parse_topics(markdown), max_chapters, max_lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="compress a knowledge note")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--max-chapters", type=int, default=6)
    parser.add_argument("--max-lines", type=int, default=300)
    args = parser.parse_args(argv)

    markdown = Path(args.input).read_text(encoding="utf-8")
    digest = compress_note(markdown, args.max_chapters, args.max_lines)
    Path(args.output).write_text(digest, encoding="utf-8")
    print(f"compressed {args.input} -> {args.output} ({len(digest.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
