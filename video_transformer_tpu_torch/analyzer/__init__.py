"""Analysis engine: the on-device replacement for the reference's cloud LLM.

This package's own copy of the JAX package's ``analyzer/``, serving through
the port's ``InferenceEngine``. Public surface mirrors the reference
(src/analyzer/__init__.py): ContentAnalyzer, AnalysisResult,
KnowledgeDocument. ``schema.py`` holds the output-schema grammars for
constrained decoding, ``prompts.py`` the prompt templates.
"""

from ..contracts import AnalysisResult, KnowledgeDocument
from .content_analyzer import ContentAnalyzer

__all__ = ["ContentAnalyzer", "AnalysisResult", "KnowledgeDocument"]
