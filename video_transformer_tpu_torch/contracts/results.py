"""Orchestrator result records (per-video and batch).

This package's own copy of the JAX package's ``contracts/results.py``, pinned to it by
the CPU parity tests (``tests/test_torch_contracts.py``).

The ``to_dict()`` JSON layout and the CLI-facing ``__str__`` strings are
cross-implementation contracts (reference src/models.py:14-118) consumed by
result files and the terminal summary; the record machinery here leans on
``dataclasses.asdict`` instead of hand-written field lists.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

__all__ = ["ProcessResult", "BatchResult"]


@dataclass
class ProcessResult:
    """Result of processing a single video through the pipeline.

    ``api_calls_used`` counts model-call budget consumed by this video
    (on-device generations, in this framework).
    """

    video_id: str
    url: str
    success: bool
    document_path: str | None = None
    blueprint_path: str | None = None
    api_calls_used: int = 0
    error_message: str | None = None
    processing_time: float = 0.0
    validation_score: float = 0.0
    audit_score: float = 0.0

    def __str__(self) -> str:
        status = "✅ 成功" if self.success else "❌ 失败"
        return (
            f"{status} | {self.video_id} | "
            f"API调用: {self.api_calls_used} | "
            f"耗时: {self.processing_time:.1f}s"
        )


@dataclass
class BatchResult:
    """Aggregate result over a batch of videos."""

    total: int
    successful: int
    failed: int
    results: list[ProcessResult] = field(default_factory=list)
    total_api_calls: int = 0
    total_time: float = 0.0

    def add_result(self, result: ProcessResult) -> None:
        self.results.append(result)
        self.total_api_calls += result.api_calls_used
        self.total_time += result.processing_time

    def to_dict(self) -> dict[str, Any]:
        # Field declaration order IS the serialized key order, for both the
        # batch summary and each per-video record (asdict preserves it).
        summary = asdict(self)
        per_video = summary.pop("results")
        summary["results"] = per_video
        return summary

    @property
    def success_rate(self) -> float:
        return self.successful / self.total * 100 if self.total else 0.0

    def __str__(self) -> str:
        return (
            f"批量处理结果: {self.successful}/{self.total} 成功 "
            f"({self.success_rate:.1f}%) | "
            f"API调用: {self.total_api_calls} | "
            f"总耗时: {self.total_time:.1f}s"
        )
