"""The knowledge-note output schema, compiled to a decoding DFA.

This package's own copy of the grammars of the JAX package's
``analyzer/schema.py``: every generation under one is valid JSON with exactly
its schema's fields. Field budgets are in bytes.
"""

from __future__ import annotations

import functools

from ..models.tokenizer import ByteTokenizer
from ..ops.constrained import DfaBuilder, JsonDfa

__all__ = ["note_dfa", "segment_note_dfa", "schema_dfa", "validator_dfa", "audit_dfa"]


def _scaled(scale: float, min_len: int, max_len: int) -> tuple[int, int]:
    lo = max(1, int(min_len * min(scale, 1.0)))
    hi = max(lo + 1, int(max_len * scale))
    return lo, hi


def _qa_item(b: DfaBuilder, s: float) -> None:
    b.literal('{"q": ').free_string(*_scaled(s, 5, 60))
    b.literal(', "a": ').free_string(*_scaled(s, 5, 60))
    b.literal("}")


def _section_item(b: DfaBuilder, s: float) -> None:
    b.literal('{"topic": ').free_string(*_scaled(s, 3, 40))
    b.literal(', "timestamp": ').timecode()
    b.literal(', "explanation": ').free_string(*_scaled(s, 10, 160))
    b.literal(', "example": ').free_string(*_scaled(s, 8, 120))
    b.literal(', "code": ').free_string(*_scaled(s, 4, 80))
    b.literal(', "common_mistakes": ').string_list(*_scaled(s, 5, 60))
    b.literal(', "connections": ').string_list(*_scaled(s, 3, 40))
    b.literal(', "self_check": ').loop_list(lambda bb: _qa_item(bb, s))
    b.literal("}")


def _chapter_item(b: DfaBuilder, s: float) -> None:
    b.literal('{"chapter_title": ').free_string(*_scaled(s, 4, 40))
    b.literal(', "chapter_summary": ').free_string(*_scaled(s, 8, 100))
    b.literal(', "chapter_self_check": ').loop_list(lambda bb: _qa_item(bb, s))
    b.literal(', "sections": ').loop_list(lambda bb: _section_item(bb, s))
    b.literal("}")


def _visual_schema_item(b: DfaBuilder, s: float) -> None:
    b.literal('{"type": "overview", "description": ').free_string(*_scaled(s, 5, 60))
    b.literal(', "schema": ').free_string(*_scaled(s, 10, 200))
    b.literal("}")


@functools.lru_cache(maxsize=8)
def note_dfa(vocab_size: int = 512, scale: float = 1.0, unicode_text: bool = True) -> JsonDfa:
    """Full knowledge-note schema: the single-pass analysis grammar.

    ``scale`` multiplies all free-field length budgets; ``unicode_text``
    admits well-formed CJK UTF-8 in free fields.
    """
    b = DfaBuilder(ByteTokenizer(vocab_size), unicode_text=unicode_text)
    b.literal('{"title": ').free_string(*_scaled(scale, 6, 60))
    b.literal(', "one_sentence_summary": ').free_string(*_scaled(scale, 10, 120))
    b.literal(', "key_takeaways": ').string_list(*_scaled(scale, 5, 80))
    b.literal(', "deep_dive": ').loop_list(lambda bb: _chapter_item(bb, scale))
    b.literal(', "glossary": ').string_dict(*_scaled(scale, 2, 24), *_scaled(scale, 5, 80))
    b.literal(', "visual_schemas": ').loop_list(lambda bb: _visual_schema_item(bb, scale))
    b.literal("}")
    return b.finish()


@functools.lru_cache(maxsize=8)
def segment_note_dfa(vocab_size: int = 512, scale: float = 1.0) -> JsonDfa:
    """Per-segment grammar: the note's shape, kept apart from ``note_dfa``
    so that segment and consolidation budgets can diverge."""
    return note_dfa(vocab_size, scale)


@functools.lru_cache(maxsize=8)
def schema_dfa(vocab_size: int = 512) -> JsonDfa:
    """Standalone visual-schema generation (the fallback pass)."""
    b = DfaBuilder(ByteTokenizer(vocab_size))
    b.literal('{"visual_schemas": ').loop_list(lambda bb: _visual_schema_item(bb, 1.0)).literal("}")
    return b.finish()


_TWO_DIGITS = [tuple(range(0x30, 0x3A))] * 2


@functools.lru_cache(maxsize=8)
def validator_dfa(vocab_size: int = 512) -> JsonDfa:
    """Consistency-validator scoring grammar (rubric 40/30/20/10)."""
    b = DfaBuilder(ByteTokenizer(vocab_size))
    b.literal('{"accuracy": ').quoted_pattern(_TWO_DIGITS)
    b.literal(', "completeness": ').quoted_pattern(_TWO_DIGITS)
    b.literal(', "visualization": ').quoted_pattern(_TWO_DIGITS)
    b.literal(', "logic": ').quoted_pattern(_TWO_DIGITS)
    b.literal(', "feedback": ').free_string(5, 160).literal("}")
    return b.finish()


@functools.lru_cache(maxsize=8)
def audit_dfa(vocab_size: int = 512) -> JsonDfa:
    """Image-audit grammar: score, pass flag and feedback."""
    b = DfaBuilder(ByteTokenizer(vocab_size))
    b.literal('{"score": ').quoted_pattern(_TWO_DIGITS)
    b.literal(', "passed": ').choice(["true", "false"])
    b.literal(', "feedback": ').free_string(5, 160).literal("}")
    return b.finish()
