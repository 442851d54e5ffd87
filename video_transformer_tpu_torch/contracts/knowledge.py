"""Core data model: VisualSchemaItem, KnowledgeDocument, AnalysisResult.

This package's own copy of the JAX package's ``contracts/knowledge.py``, pinned to it by
the CPU parity tests (``tests/test_torch_contracts.py``).

The JSON contract gate is ``AnalysisResult.from_api_response`` — every engine
output (on-device constrained decoding, merged segment analyses, repaired
JSON) passes through it. Matches the reference contract at
the reference's src/analyzer/models.py:18-61 and 1228-1382.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from .normalize import normalize_deep_dive, normalize_field_value, normalize_list_field
from .render import render_markdown
from .validators import detect_stub_output, validate_markdown_structure

__all__ = ["VisualSchemaItem", "KnowledgeDocument", "AnalysisResult"]

# Fields without which a meaningful document cannot be built.
CRITICAL_FIELDS = frozenset(
    {"title", "one_sentence_summary", "key_takeaways", "deep_dive"}
)


@dataclass
class VisualSchemaItem:
    """One knowledge-blueprint visual schema."""

    type: str
    """Diagram archetype: overview / detail_flow / comparison."""

    description: str
    """Human-readable (Chinese) description of the diagram."""

    schema: str
    """The Visual Schema markdown/prompt string fed to the renderer."""


@dataclass
class KnowledgeDocument:
    """Structured "elite knowledge note" produced by the analyzer.

    ``deep_dive`` is a list of chapters::

        {chapter_title, chapter_summary, chapter_self_check: [{q, a}],
         sections: [{topic, challenge, code, explanation, example,
                     common_mistakes, self_check, connections, timestamp...}]}

    Legacy flat section lists (no chapter wrapper) are also accepted.
    """

    title: str
    one_sentence_summary: str
    key_takeaways: list[str]
    deep_dive: list[dict[str, Any]]
    glossary: dict[str, str]
    visual_schemas: list[VisualSchemaItem] = field(default_factory=list)

    def to_markdown(
        self,
        image_paths: list[str] | None = None,
        self_check_mode: str = "static",
        include_concept_index: bool | None = None,
    ) -> str:
        """Render this note as Markdown in the given mode.

        Modes: static / interactive / questions_only (legacy v2), default
        (Core+Appendix), lecture (textbook).
        """
        return render_markdown(
            self,
            image_paths=image_paths,
            self_check_mode=self_check_mode,
            include_concept_index=include_concept_index,
        )


@dataclass
class AnalysisResult:
    """Complete result of analyzing one video."""

    video_path: str | Path
    knowledge_doc: KnowledgeDocument
    metadata: dict[str, Any] = field(default_factory=dict)
    """Engine metadata: duration, segments, segment_gaps, device stats..."""

    @property
    def title(self) -> str:
        return self.knowledge_doc.title

    @property
    def glossary(self) -> dict[str, str]:
        return self.knowledge_doc.glossary

    def to_markdown(
        self,
        image_paths: list[str] | None = None,
        self_check_mode: str = "static",
        include_concept_index: bool | None = None,
    ) -> str:
        """Render and validate the final Markdown document.

        Validation failures raise in "default" mode and warn in legacy modes
        (reference models.py:1251-1295).
        """
        markdown = self.knowledge_doc.to_markdown(
            image_paths=image_paths,
            self_check_mode=self_check_mode,
            include_concept_index=include_concept_index,
        )

        normalized_mode = (self_check_mode or "").strip().lower()
        if normalized_mode not in {
            "static",
            "interactive",
            "questions_only",
            "default",
        }:
            normalized_mode = "static"

        errors: list[str] = []
        if detect_stub_output(markdown):
            errors.append("检测到疑似占位/空内容输出")
        _, structure_errors = validate_markdown_structure(markdown, normalized_mode)
        errors.extend(structure_errors)

        if errors:
            message = "Markdown 校验失败: " + "; ".join(errors)
            if normalized_mode == "default":
                raise ValueError(message)
            warnings.warn(f"Markdown 校验警告(legacy 模式): {message}")

        return markdown

    @classmethod
    def from_api_response(
        cls,
        video_path: str | Path,
        response_data: dict[str, Any],
        metadata: dict[str, Any] | None = None,
    ) -> "AnalysisResult":
        """Build an AnalysisResult from engine JSON output (the contract gate).

        Raises ValueError when a critical field is missing. Visual schemas are
        accepted both as the current list-of-dicts form and the legacy single
        ``visual_schema`` string.
        """
        missing = CRITICAL_FIELDS - response_data.keys()
        if missing:
            raise ValueError(f"API 响应缺少必需字段: {', '.join(sorted(missing))}")

        visual_schemas: list[VisualSchemaItem] = []
        raw_schemas = response_data.get("visual_schemas", [])
        if isinstance(raw_schemas, list) and raw_schemas:
            for item in raw_schemas:
                if isinstance(item, dict):
                    visual_schemas.append(
                        VisualSchemaItem(
                            type=item.get("type", "overview"),
                            description=item.get("description", ""),
                            schema=item.get("schema", ""),
                        )
                    )
                elif isinstance(item, str):
                    visual_schemas.append(
                        VisualSchemaItem(type="overview", description="", schema=item)
                    )
        else:
            legacy_schema = response_data.get("visual_schema", "")
            if legacy_schema:
                visual_schemas.append(
                    VisualSchemaItem(
                        type="overview",
                        description="总览知识导图",
                        schema=legacy_schema,
                    )
                )

        # Top-level type drift is coerced like section fields are (the
        # reference normalized only deep_dive internals, models.py:1369-1375;
        # hardening found by fuzzing: scalar key_takeaways / non-dict
        # glossary must not crash rendering).
        raw_takeaways = response_data["key_takeaways"]
        if isinstance(raw_takeaways, list):
            key_takeaways = raw_takeaways
        else:
            key_takeaways = normalize_list_field(raw_takeaways)
        raw_glossary = response_data.get("glossary", {})
        glossary = raw_glossary if isinstance(raw_glossary, dict) else {}

        knowledge_doc = KnowledgeDocument(
            title=normalize_field_value(response_data["title"]),
            one_sentence_summary=normalize_field_value(
                response_data["one_sentence_summary"]
            ),
            key_takeaways=key_takeaways,
            deep_dive=normalize_deep_dive(response_data["deep_dive"]),
            glossary=glossary,
            visual_schemas=visual_schemas,
        )

        return cls(
            video_path=video_path,
            knowledge_doc=knowledge_doc,
            metadata=metadata or {},
        )
