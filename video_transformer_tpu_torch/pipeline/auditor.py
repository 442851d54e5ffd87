"""Quality auditor: judges a rendered blueprint image against the note.

The reference uploads the PNG to Gemini vision and parses 评分/反馈/通过 lines
(quality_auditor.py:151-343), defaulting to pass on a parse failure. The
TPU-native auditor combines deterministic image forensics (resolution,
blankness, contrast, ink coverage — cheap host-side checks that catch the
actual failure modes of diagram renderers) with an optional engine pass under
the audit grammar. Parse/engine failures keep the reference's default-pass
semantics.

This package's own copy of the JAX package's ``pipeline/auditor.py``,
without PIL: the PNG is read by ``png.py`` (luma as PIL's ``convert("L")``)
and the still clip scaled by ``raster.resize_bicubic`` (PIL's default
``resize``, byte for byte). Unlike the JAX copy, an error from torch or
naming CUDA is never turned into the default pass: it propagates.
``tests/test_torch_pipeline*.py`` hold it to the JAX auditor.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from ..utils.counter import APICounter
from ..utils.pacer import _is_device_error
from .png import decode_png, to_luma
from .raster import resize_bicubic

__all__ = ["AuditResult", "QualityAuditor"]


@dataclass
class AuditResult:
    score: float
    passed: bool
    feedback: str


class QualityAuditor:
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
        auditor_config = config.get("auditor", {})
        self.threshold = float(auditor_config.get("threshold", 75.0))
        self.use_engine = bool(auditor_config.get("use_engine", False))
        self._engine = engine

    def attach_engine(self, engine: Any) -> None:
        """Late-bind the shared inference engine; only consulted when
        auditor.use_engine is set (image forensics are the default judge)."""
        if self.use_engine and engine is not None:
            self._engine = engine

    def audit_image(
        self, image_path: str | Path, knowledge_doc_content: str
    ) -> AuditResult:
        """Audit the rendered diagram; failures but a device error default
        to pass (reference quality_auditor.py:336-343)."""
        try:
            score, feedback = self._forensic_score(Path(image_path))
            if self._engine is not None:
                model_score, model_feedback = self._model_score(
                    Path(image_path), knowledge_doc_content
                )
                score = 0.5 * score + 0.5 * model_score
                feedback = f"{feedback}；{model_feedback}"
            self.api_counter.increment("auditor")
            return AuditResult(
                score=round(score, 1),
                passed=score >= self.threshold,
                feedback=feedback,
            )
        except Exception as exc:
            if _is_device_error(exc):
                raise
            self.logger.warning(f"event=audit_parse_failed default=pass error={exc}")
            return AuditResult(
                score=self.threshold,
                passed=True,
                feedback=f"审核过程异常，默认通过: {exc}",
            )

    def _forensic_score(self, image_path: Path) -> tuple[float, str]:
        """Deterministic diagram forensics: size, blankness, contrast, ink."""
        luma = to_luma(decode_png(image_path.read_bytes()))
        height, width = luma.shape
        pixels = luma.astype(np.float32)

        issues: list[str] = []
        score = 100.0

        if width < 320 or height < 240:
            score -= 40
            issues.append("分辨率过低")
        std = float(pixels.std())
        if std < 5.0:
            score -= 50
            issues.append("图片近乎空白")
        elif std < 20.0:
            score -= 20
            issues.append("对比度偏低")
        # Ink coverage: fraction of pixels departing from the background.
        background = float(np.median(pixels))
        ink = float((abs(pixels - background) > 40).mean())
        if ink < 0.005:
            score -= 30
            issues.append("内容覆盖过少")
        elif ink > 0.6:
            score -= 15
            issues.append("画面过于密集")

        feedback = "、".join(issues) if issues else "图像质量检查通过"
        return max(score, 0.0), feedback

    def _model_score(self, image_path: Path, note: str) -> tuple[float, str]:
        """Vision-grounded audit: the rendered PNG goes through the VLM's
        vision tower alongside the note excerpt, mirroring the reference's
        image upload to the vision judge (quality_auditor.py:151-245). The
        still image is tiled to the encoder's clip length so the standard
        video preprocess path serves it unchanged."""
        from ..analyzer.prompts import render_prompt
        from ..analyzer.schema import audit_dfa

        prompt = render_prompt(
            "audit",
            {"note_excerpt": note[:1200], "threshold": int(self.threshold)},
        )
        dfa = self._engine.wrap_grammar(audit_dfa(self._engine.byte_vocab))
        frames = self._image_clip(image_path)
        text = self._engine.generate(frames, [prompt], dfa=dfa)[0]
        parsed = json.loads(text)
        return float(parsed.get("score", 0)), str(parsed.get("feedback", ""))

    def _image_clip(self, image_path: Path) -> np.ndarray:
        """PNG -> uint8 [1, T, H, W, 3] still clip at the engine's frame
        count. Host-side downscale bounds the device resize matmul; the
        exact target size comes from preprocess_frames."""
        num_frames = int(self._engine.config.encoder.num_frames)
        still = decode_png(image_path.read_bytes())
        still = np.repeat(still, 3, axis=2) if still.shape[2] == 1 else still[:, :, :3]
        height, width = still.shape[:2]
        long_edge = max(width, height)
        if long_edge > 512:
            scale = 512 / long_edge
            still = resize_bicubic(
                still,
                max(1, round(width * scale)),
                max(1, round(height * scale)),
            )
        return np.broadcast_to(
            still[None, None], (1, num_frames) + still.shape
        ).copy()
