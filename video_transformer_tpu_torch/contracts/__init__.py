"""Output-contract layer: pure-Python data model and renderers.

This package's own copy of the JAX package's ``contracts/``: the JSON and
Markdown contracts the analyzer's notes pass through. Its rendered Markdown
is byte-equal to the JAX package's for the same note JSON
(``tests/test_torch_contracts.py``). The reference's
src/analyzer/models.py and src/analyzer/validators.py define the byte-level
contract (headings, orderings, normalization semantics).
"""

from .knowledge import AnalysisResult, KnowledgeDocument, VisualSchemaItem
from .results import BatchResult, ProcessResult
from .validators import (
    detect_stub_output,
    validate_knowledge_document,
    validate_markdown_structure,
)

__all__ = [
    "AnalysisResult",
    "KnowledgeDocument",
    "VisualSchemaItem",
    "ProcessResult",
    "BatchResult",
    "detect_stub_output",
    "validate_knowledge_document",
    "validate_markdown_structure",
]
