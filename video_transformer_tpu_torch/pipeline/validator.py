"""Consistency validator: scores visual-schema vs note coherence.

The reference sends the pair to Kimi K2 over HTTP and parses a 100-point
rubric — accuracy 40 / completeness 30 / visualization 20 / logic 10, pass at
>= threshold (consistency_validator.py:89-257). Here the same rubric is
scored by the local engine under a constrained grammar (validator_dfa), with
a deterministic structural scorer as fallback, preserving the reference's
fail-safe: an unparseable judgment scores 0 and fails.

This package's own copy of the JAX package's ``pipeline/validator.py``,
pinned to it by the CPU parity tests (``tests/test_torch_pipeline*.py``).
Unlike the JAX copy, an error from torch or naming CUDA is never turned
into the 0-score fail-safe: it propagates (a device fault is not a verdict).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Any

from ..analyzer.schema import validator_dfa
from ..utils.counter import APICounter
from ..utils.pacer import _is_device_error

__all__ = ["ValidationResult", "ConsistencyValidator"]

DIMENSION_WEIGHTS = {
    "accuracy": 40,
    "completeness": 30,
    "visualization": 20,
    "logic": 10,
}


@dataclass
class ValidationResult:
    total_score: float
    passed: bool
    feedback: str
    dimension_scores: dict[str, float] = field(default_factory=dict)


class ConsistencyValidator:
    """Scores schema/note consistency on the local engine."""

    def __init__(
        self,
        config: dict[str, Any],
        api_counter: APICounter,
        logger: logging.Logger | None = None,
        engine: Any = None,
    ):
        self.config = config
        self.api_counter = api_counter
        self.logger = logger or logging.getLogger("video_transformer")
        validator_config = config.get("validator", {})
        self.threshold = float(validator_config.get("threshold", 75))
        self.use_engine = bool(validator_config.get("use_engine", False))
        self._engine = engine

    def attach_engine(self, engine: Any) -> None:
        """Late-bind the shared inference engine (built lazily by the
        analyzer); only consulted when validator.use_engine is set —
        the deterministic structural scorer outranks an unjudged model."""
        if self.use_engine and engine is not None:
            self._engine = engine

    def validate(
        self, mind_map_structure: str, knowledge_doc_content: str
    ) -> ValidationResult:
        """Score the pair; any scoring failure but a device error returns
        the 0-score fail-safe."""
        if not mind_map_structure:
            return self._fail_safe("Visual Schema 为空")
        try:
            if self._engine is not None:
                result = self._model_score(mind_map_structure, knowledge_doc_content)
            else:
                result = self._structural_score(
                    mind_map_structure, knowledge_doc_content
                )
            self.api_counter.increment("validator")
            return result
        except Exception as exc:
            if _is_device_error(exc):
                raise
            self.logger.warning(f"event=validation_failed error={exc}")
            return self._fail_safe(str(exc))

    def _fail_safe(self, reason: str) -> ValidationResult:
        return ValidationResult(
            total_score=0.0,
            passed=False,
            feedback=f"校验失败，按未通过处理: {reason}",
            dimension_scores={k: 0.0 for k in DIMENSION_WEIGHTS},
        )

    def _model_score(self, schema: str, note: str) -> ValidationResult:
        """Model judgment GATED by the independent structural scorer.

        The engine that scores is the engine that wrote the note, so its
        judgment alone would rubber-stamp (the reference avoids this with a
        separate judge service, consistency_validator.py:180-211). The
        deterministic term-grounding scorer cannot be swayed by the writer;
        taking the per-dimension minimum keeps the model's ability to fail a
        note while denying it the ability to pass one its own text does not
        support.
        """
        from ..analyzer.prompts import render_prompt

        prompt = render_prompt(
            "validator", {"note_excerpt": note[:1200], "schema": schema[:600]}
        )
        dfa = self._engine.wrap_grammar(validator_dfa(self._engine.byte_vocab))
        text = self._engine.generate_text([prompt], dfa=dfa)[0]
        parsed = json.loads(text)
        independent = self._structural_score(schema, note)
        scores: dict[str, float] = {}
        for name, weight in DIMENSION_WEIGHTS.items():
            # Grammar emits "NN" in 0..99; clamp into the dimension weight,
            # then gate by the independent structural signal.
            raw = min(float(parsed.get(name, 0)), float(weight))
            scores[name] = min(raw, independent.dimension_scores[name])
        total = sum(scores.values())
        return ValidationResult(
            total_score=total,
            passed=total >= self.threshold,
            feedback=str(parsed.get("feedback", "")) or independent.feedback,
            dimension_scores=scores,
        )

    def _structural_score(self, schema: str, note: str) -> ValidationResult:
        """Deterministic fallback scorer: term overlap + structure heuristics.

        Checks that schema node labels appear in the note (accuracy),
        estimates topic coverage (completeness), rewards explicit structure
        markers (visualization), and penalizes empty/flat schemas (logic).
        """
        schema_tokens = {
            token.strip().lower()
            for token in _tokenize(schema)
            if len(token.strip()) >= 2
        }
        note_lower = note.lower()

        if not schema_tokens:
            return self._fail_safe("schema 无有效节点")

        grounded = sum(1 for token in schema_tokens if token in note_lower)
        accuracy = 40.0 * grounded / len(schema_tokens)

        note_headings = [
            line for line in note.splitlines() if line.strip().startswith("#")
        ]
        covered = sum(
            1
            for heading in note_headings
            if any(token in heading.lower() for token in schema_tokens)
        )
        completeness = 30.0 * (covered / len(note_headings)) if note_headings else 15.0

        structure_markers = sum(schema.count(m) for m in ("->", "→", "-", "|", ":"))
        visualization = min(20.0, 4.0 * min(structure_markers, 5))

        lines = [line for line in schema.splitlines() if line.strip()]
        logic = 10.0 if len(lines) >= 2 or "->" in schema else 5.0

        scores = {
            "accuracy": round(accuracy, 1),
            "completeness": round(completeness, 1),
            "visualization": visualization,
            "logic": logic,
        }
        total = sum(scores.values())
        feedback = (
            "结构与内容基本一致"
            if total >= self.threshold
            else "蓝图节点与笔记主题的对应不足，建议让节点文本引用笔记中的标题与术语"
        )
        return ValidationResult(
            total_score=total,
            passed=total >= self.threshold,
            feedback=feedback,
            dimension_scores=scores,
        )


def _tokenize(text: str) -> list[str]:
    import re

    return re.split(r"[\s\->|:,;()\[\]{}→、，]+", text)
