"""Tolerant normalization of model-emitted JSON fields.

This package's own copy of the JAX package's ``contracts/normalize.py``, pinned to it by
the CPU parity tests (``tests/test_torch_contracts.py``).

Video-LM (and LLM) structured output drifts in type: strings arrive as lists,
examples arrive as {input, steps, output} dicts, timestamps arrive in ms or
"MM:SS" strings. This module coerces all of that into the canonical shapes the
renderer expects, matching the semantics of the reference implementation
(the reference's src/analyzer/models.py:1080-1225) so the Markdown contract is
byte-identical.
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "coerce_str_list",
    "normalize_field_value",
    "normalize_list_field",
    "normalize_section_fields",
    "normalize_deep_dive",
    "as_chapters",
]

# Keys that mark a dict-shaped "example" value (rendered as 输入/步骤/输出).
_IO_KEYS = ("input", "steps", "output")


def coerce_str_list(value: Any) -> list[Any]:
    """Coerce a value into a list; strings split on newlines.

    Mirrors reference models.py:646-653 (_coerce_list).
    """
    if isinstance(value, list):
        return value
    if isinstance(value, str) and value.strip():
        return [ln.strip() for ln in value.split("\n") if ln.strip()]
    return []


def _bullet(text: str) -> list[str]:
    """Format a possibly-multiline item as a markdown bullet with hanging indent."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    out = [f"- {lines[0]}"]
    out.extend(f"  {ln}" for ln in lines[1:])
    return out


def _ordered(items: list[str]) -> list[str]:
    """Format items as a numbered list with hanging indent."""
    out: list[str] = []
    for idx, item in enumerate(items, 1):
        lines = [ln for ln in item.splitlines() if ln.strip()]
        if not lines:
            continue
        out.append(f"{idx}. {lines[0]}")
        out.extend(f"   {ln}" for ln in lines[1:])
    return out


def _normalize_steps(value: Any) -> list[str]:
    if value is None:
        return []
    if isinstance(value, list):
        steps = []
        for item in value:
            text = normalize_field_value(item)
            if text:
                steps.append(text)
        return steps
    if isinstance(value, str):
        return [ln.strip() for ln in value.splitlines() if ln.strip()]
    text = normalize_field_value(value)
    return [text] if text else []


def normalize_field_value(value: Any) -> str:
    """Normalize any JSON value into display text.

    - str: stripped as-is.
    - dict with input/steps/output keys: rendered as a 输入/步骤/输出 block
      (extra keys collected under 其他：).
    - other dicts: sorted-key bullet list.
    - list: each item normalized and bulleted (already-bulleted items pass
      through untouched).

    Mirrors reference models.py:1118-1172.
    """
    if value is None:
        return ""
    if isinstance(value, str):
        return value.strip()
    if isinstance(value, dict):
        if not value:
            return ""
        if any(k in value for k in _IO_KEYS):
            parts: list[str] = []
            input_text = normalize_field_value(value.get("input"))
            if input_text:
                parts.append(f"输入：{input_text}")
            steps = _normalize_steps(value.get("steps"))
            if steps:
                parts.append("步骤：")
                parts.extend(_ordered(steps))
            output_text = normalize_field_value(value.get("output"))
            if output_text:
                parts.append(f"输出：{output_text}")
            extras = sorted(k for k in value if k not in _IO_KEYS)
            if extras:
                parts.append("其他：")
                for key in extras:
                    text = normalize_field_value(value.get(key))
                    parts.extend(_bullet(f"{key}: {text}" if text else f"{key}:"))
            return "\n".join(parts).strip()
        lines: list[str] = []
        for key in sorted(value.keys()):
            text = normalize_field_value(value.get(key))
            lines.extend(_bullet(f"{key}: {text}" if text else f"{key}:"))
        return "\n".join(lines).strip()
    if isinstance(value, list):
        lines = []
        for item in value:
            text = normalize_field_value(item)
            if not text:
                continue
            item_lines = [ln for ln in text.splitlines() if ln.strip()]
            if not item_lines:
                continue
            if all(ln.startswith("- ") for ln in item_lines):
                lines.extend(item_lines)
            else:
                lines.extend(_bullet("\n".join(item_lines)))
        return "\n".join(lines).strip()
    return str(value).strip()


def normalize_list_field(value: Any) -> list[str]:
    """Normalize a value expected to be a list of display strings.

    Mirrors reference models.py:1175-1193.
    """
    if value is None:
        return []
    if isinstance(value, list):
        items: list[str] = []
        for item in value:
            text = normalize_field_value(item)
            if not text:
                continue
            lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
            if lines and all(ln.startswith("- ") for ln in lines):
                items.extend(ln[2:].strip() for ln in lines)
            else:
                items.append("\n".join(lines))
        return items
    if isinstance(value, str):
        return [ln.strip() for ln in value.splitlines() if ln.strip()]
    text = normalize_field_value(value)
    return [text] if text else []


def normalize_section_fields(section: dict[str, Any]) -> dict[str, Any]:
    """Normalize the free-text fields of one deep-dive section.

    Mirrors reference models.py:1196-1205.
    """
    out = dict(section)
    out["explanation"] = normalize_field_value(section.get("explanation"))
    out["example"] = normalize_field_value(section.get("example"))
    out["code"] = normalize_field_value(section.get("code"))
    out["common_mistakes"] = normalize_list_field(section.get("common_mistakes"))
    out["connections"] = normalize_list_field(section.get("connections"))
    return out


def normalize_deep_dive(deep_dive: Any) -> list[dict[str, Any]]:
    """Normalize the full deep_dive structure (chaptered or flat).

    Mirrors reference models.py:1208-1225.
    """
    if not isinstance(deep_dive, list):
        return []
    normalized: list[dict[str, Any]] = []
    for item in deep_dive:
        if not isinstance(item, dict):
            continue
        if isinstance(item.get("sections"), list):
            chapter = dict(item)
            chapter["sections"] = [
                normalize_section_fields(sec)
                for sec in item.get("sections", [])
                if isinstance(sec, dict)
            ]
            normalized.append(chapter)
        else:
            normalized.append(normalize_section_fields(item))
    return normalized


def as_chapters(deep_dive: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Wrap a flat (legacy) deep_dive in a single default chapter.

    Mirrors reference models.py:976-986.
    """
    if any("chapter_title" in item for item in deep_dive):
        return deep_dive
    return [
        {
            "chapter_title": "核心要点",
            "chapter_summary": "",
            "sections": deep_dive,
        }
    ]
