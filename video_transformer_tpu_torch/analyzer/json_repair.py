"""Deterministic JSON repair — the safety net behind constrained decoding.

This package's own copy of the JAX package's ``analyzer/json_repair.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

With the DFA decoder (ops/constrained.py) engine output is valid by
construction, so this module exists for the seams where arbitrary JSON can
still enter: optional cloud fallbacks, checkpoint-resumed partial segment
outputs, and operator-supplied files. It reimplements the reference's repair
ladder (content_analyzer.py:1714-1996) as composable strategies:

  direct parse -> escape sanitization -> backtick quotes -> unquoted keys ->
  close truncation -> truncate to last complete item -> control-char strip

Each strategy is pure text -> text; ``repair_json`` walks the ladder and
returns the first parseable result.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Any, Callable

__all__ = ["repair_json", "RepairError", "STRATEGIES", "dump_failed_json"]


class RepairError(ValueError):
    """Raised when no repair strategy yields parseable JSON."""


_FENCE_RE = re.compile(r"^```(?:json)?\s*|\s*```$", re.MULTILINE)
_PREFIX_RE = re.compile(r"^[^{\[]*", re.DOTALL)
_BAD_ESCAPE_RE = re.compile(r"\\(?![\"\\/bfnrtu])")
_BARE_KEY_RE = re.compile(r"([{,]\s*)([A-Za-z_][A-Za-z0-9_]*)(\s*:)")
_BACKTICK_STRING_RE = re.compile(r"`([^`]*)`")
_TRAILING_COMMA_RE = re.compile(r",(\s*[}\]])")
_CTRL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]")


def strip_wrappers(text: str) -> str:
    """Drop markdown fences and any chatter before the first { or [."""
    text = _FENCE_RE.sub("", text.strip())
    match = re.search(r"[{\[]", text)
    return text[match.start():] if match else text


def sanitize_escapes(text: str) -> str:
    """Double invalid backslash escapes (LaTeX fragments like \\alpha)."""
    return _BAD_ESCAPE_RE.sub(r"\\\\", text)


def fix_backtick_quotes(text: str) -> str:
    """Convert `backtick` strings to proper double-quoted strings."""
    return _BACKTICK_STRING_RE.sub(
        lambda m: json.dumps(m.group(1), ensure_ascii=False), text
    )


def fix_unquoted_keys(text: str) -> str:
    """Quote bare object keys: {key: ...} -> {"key": ...}."""
    return _BARE_KEY_RE.sub(r'\1"\2"\3', text)


def drop_trailing_commas(text: str) -> str:
    return _TRAILING_COMMA_RE.sub(r"\1", text)


def strip_control_chars(text: str) -> str:
    return _CTRL_RE.sub("", text)


def close_truncated(text: str) -> str:
    """Close a generation that was cut off mid-structure.

    Walks the text tracking string/escape state and the open-bracket stack,
    trims a dangling partial token, then closes every open scope.
    """
    stack: list[str] = []
    in_string = False
    escaped = False
    last_complete = 0
    for i, ch in enumerate(text):
        if in_string:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_string = False
                last_complete = i + 1
            continue
        if ch == '"':
            in_string = True
        elif ch in "{[":
            stack.append("}" if ch == "{" else "]")
            last_complete = i + 1
        elif ch in "}]":
            if stack:
                stack.pop()
            last_complete = i + 1
        elif ch in ",:":
            pass
        else:
            last_complete = i + 1

    trimmed = text[:last_complete] if in_string else text
    # Drop a dangling comma/colon fragment before closing.
    trimmed = re.sub(r"[,:\s]+$", "", trimmed)
    # A value may be missing after a key — pad with null.
    if re.search(r'"\s*:\s*$', trimmed):
        trimmed += " null"
    return trimmed + "".join(reversed(stack))


def truncate_to_last_item(text: str) -> str:
    """Drop trailing broken items: cut at successive commas until parseable.

    Handles truncations that close_truncated alone cannot, like a dangling
    object key ('..., "key"' with no value) buried under closed scopes.
    """
    candidate = close_truncated(text)
    try:
        json.loads(candidate)
        return candidate
    except json.JSONDecodeError:
        pass

    base = text
    for _ in range(32):
        cut = base.rfind(",")
        if cut <= 0:
            break
        base = base[:cut]
        candidate = close_truncated(base)
        try:
            json.loads(candidate)
            return candidate
        except json.JSONDecodeError:
            continue
    return candidate


STRATEGIES: list[tuple[str, Callable[[str], str]]] = [
    ("direct", lambda t: t),
    ("sanitize_escapes", sanitize_escapes),
    ("backtick_quotes", lambda t: fix_backtick_quotes(sanitize_escapes(t))),
    ("unquoted_keys", lambda t: fix_unquoted_keys(sanitize_escapes(t))),
    (
        "trailing_commas",
        lambda t: drop_trailing_commas(fix_unquoted_keys(sanitize_escapes(t))),
    ),
    ("close_truncated", lambda t: close_truncated(sanitize_escapes(t))),
    ("last_item", lambda t: truncate_to_last_item(sanitize_escapes(t))),
    (
        "control_chars",
        lambda t: strip_control_chars(close_truncated(sanitize_escapes(t))),
    ),
]


def dump_failed_json(text: str, log_dir: str | Path) -> Path:
    """Persist an unrepairable payload for offline diagnosis.

    Mirrors the reference's failed-JSON artifact (content_analyzer.py:
    1635-1646: raw dump to data/output/logs/failed_json_*.txt). The
    timestamped filename keeps successive failures from clobbering each
    other; a monotonic suffix disambiguates same-second failures.
    """
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = log_dir / f"failed_json_{stamp}.txt"
    n = 1
    while path.exists():
        path = log_dir / f"failed_json_{stamp}_{n}.txt"
        n += 1
    path.write_text(text, encoding="utf-8")
    return path


def repair_json(text: str) -> tuple[dict[str, Any] | list[Any], str]:
    """Parse possibly-malformed JSON; returns (value, strategy_name).

    Raises RepairError when every strategy fails.
    """
    base = strip_wrappers(text)
    errors: list[str] = []
    for name, strategy in STRATEGIES:
        try:
            candidate = strategy(base)
            return json.loads(candidate), name
        except (json.JSONDecodeError, ValueError) as exc:
            errors.append(f"{name}: {exc}")
    raise RepairError(
        "JSON repair exhausted all strategies: " + " | ".join(errors[-3:])
    )
