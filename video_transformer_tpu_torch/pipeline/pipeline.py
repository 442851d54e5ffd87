"""VideoPipeline: the end-to-end orchestrator.

Five-step per-video flow, matching reference src/pipeline.py:115-358:

  [1/5] download -> [2/5] analyze (on-device engine) -> [3/5] validate +
  rewrite loop -> [4/5] render blueprint image -> [5/5] audit image,
  then refine + quality-gate + save.

Differences by design: one engine instance is shared across all components
(model weights live on the card once), there is no per-video API-key
allocation in local mode (the key-pool seam no-ops unless configured), and
batch mode can pre-download while the device crunches the previous video.

This package's own copy of the JAX package's ``pipeline/pipeline.py``, on
the port's ``ContentAnalyzer`` and engine (``device`` "cuda" by default,
"cpu" for the kernels' plain versions). Greedy on the CPU its results,
notes, quality reports, lint lines and progress files equal the JAX
pipeline's (``tests/test_torch_pipeline_e2e.py``). Two differences:

- an engine the first analyzer builds is kept and injected into every
  later one, where the JAX pipeline builds one per video unless one was
  injected;
- an error from torch or naming CUDA (``utils/pacer._is_device_error``) is
  never turned into a failed result, a Markdown-only note, a kept image, a
  per-video re-run of a sharded batch or a broken-off validation loop: it
  propagates, and the CLI exits non-zero with its traceback. Every other
  exception is handled as the JAX pipeline handles it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import re
import time
from pathlib import Path
from typing import Any

from ..analyzer.content_analyzer import ContentAnalyzer
from ..contracts import BatchResult, ProcessResult
from ..utils.counter import APICounter, APILimitExceeded
from ..utils.pacer import _is_device_error
from ..utils.progress import ProgressTracker
from ..utils.quality import apply_quality_gates
from ..utils.refiner import refine_note
from .auditor import QualityAuditor
from .downloader import VideoDownloader
from .validator import ConsistencyValidator
from .visualizer import ImageGenerator

__all__ = ["VideoPipeline"]

_MODES = {"static", "interactive", "questions_only", "default", "lecture"}


class VideoPipeline:
    def __init__(
        self,
        config: dict[str, Any],
        logger: logging.Logger,
        api_counter: APICounter,
        progress_tracker: ProgressTracker | None = None,
        engine: Any = None,
        device: str = "cuda",
    ):
        """``device`` is where an engine built from ``config["engine"]``
        lives ("cuda", or "cpu"); an injected ``engine`` keeps its own."""
        self.config = config
        self.device = device
        self.logger = logger
        self.api_counter = api_counter
        self.progress_tracker = progress_tracker
        self._engine = engine

        self.downloader = VideoDownloader(config, logger)
        self.validator = ConsistencyValidator(
            config=config, api_counter=api_counter, logger=logger
        )
        self.generator = ImageGenerator(config=config, logger=logger)

        self.output_dir = Path(config["system"]["output_dir"])
        self.doc_dir = self.output_dir / "documents"
        self.blueprint_dir = self.output_dir / "blueprints"
        self.doc_dir.mkdir(parents=True, exist_ok=True)
        self.blueprint_dir.mkdir(parents=True, exist_ok=True)

        self.self_check_mode = self._resolve_self_check_mode(config)
        self.include_concept_index = self._resolve_include_concept_index(config)

        validator_config = config.get("validator", {})
        self.validation_threshold = float(validator_config.get("threshold", 75.0))
        self.max_validation_rounds = int(validator_config.get("max_rounds", 3))

        self.logger.info("VideoPipeline 初始化完成")

    # -- per-video flow --------------------------------------------------------

    def process_single_video(self, url: str) -> ProcessResult:
        start_time = time.time()
        video_id = self._extract_video_id(url)
        self.logger.info(f"event=video_start video_id={video_id}")

        if self.progress_tracker and self.progress_tracker.is_processed(video_id):
            self.logger.info(f"视频 {video_id} 已处理,跳过")
            return ProcessResult(
                video_id=video_id,
                url=url,
                success=True,
                error_message="已处理(跳过)",
                processing_time=0.0,
            )

        api_calls_start = self.api_counter.current_count
        analyzer = ContentAnalyzer(
            config=self.config,
            api_counter=self.api_counter,
            logger=self.logger,
            engine=self._engine,
            device=self.device,
        )
        # Components share the analyzer's engine (lazily built once).
        auditor = QualityAuditor(
            config=self.config, api_counter=self.api_counter, logger=self.logger
        )

        try:
            self.logger.info("[1/5] 下载/定位视频...")
            video_path = self.downloader.download_video(url)
            if not video_path:
                raise RuntimeError("视频下载失败")

            self.logger.info("[2/5] 分析视频内容 (on-device)...")
            analysis_result = analyzer.analyze_video(video_path)
            self.logger.info(
                f"✅ 分析完成 (章节: {len(analysis_result.knowledge_doc.deep_dive)})"
            )
            return self._finalize_video(
                video_id, url, analysis_result, analyzer, auditor,
                start_time, api_calls_start,
            )

        except APILimitExceeded as exc:
            processing_time = time.time() - start_time
            self.logger.error(
                f"event=video_failed video_id={video_id} "
                f"elapsed_s={processing_time:.1f} error=API_LIMIT_EXCEEDED"
            )
            return ProcessResult(
                video_id=video_id,
                url=url,
                success=False,
                error_message=f"API 调用超限: {exc}",
                processing_time=processing_time,
            )
        except Exception as exc:
            if _is_device_error(exc):
                raise
            processing_time = time.time() - start_time
            self.logger.error(
                f"event=video_failed video_id={video_id} "
                f"elapsed_s={processing_time:.1f} error={exc}",
                exc_info=True,
            )
            if self.progress_tracker:
                self.progress_tracker.mark_failed(video_id, str(exc))
            return ProcessResult(
                video_id=video_id,
                url=url,
                success=False,
                error_message=str(exc),
                processing_time=processing_time,
            )

    def _finalize_video(
        self,
        video_id: str,
        url: str,
        analysis_result,
        analyzer: ContentAnalyzer,
        auditor: QualityAuditor,
        start_time: float,
        api_calls_start: int,
    ) -> ProcessResult:
        """Steps 3-5 + save: validation loop, blueprint render, audit, output.

        Shared by the sequential per-video flow and the sharded batch flow.
        """
        # The analyzer's engine exists by now (analysis ran); components
        # that opted into model scoring (use_engine config) share it.
        shared_engine = getattr(analyzer, "_engine", None)
        if self._engine is None:
            self._engine = shared_engine  # later videos' analyzers reuse it
        if hasattr(self.validator, "attach_engine"):
            self.validator.attach_engine(shared_engine)
        if hasattr(auditor, "attach_engine"):
            auditor.attach_engine(shared_engine)

        self.logger.info("[3/5] 校验知识蓝图 Visual Schema...")
        schemas = analysis_result.knowledge_doc.visual_schemas
        first_schema = schemas[0].schema if schemas else ""
        note_markdown = analysis_result.knowledge_doc.to_markdown(
            self_check_mode=self.self_check_mode,
            include_concept_index=self.include_concept_index,
        )
        final_structure, validation_score = self._validation_loop(
            first_schema, note_markdown, analyzer
        )

        image_data = None
        audit_result = None
        image_timeout = False
        if final_structure:
            self.logger.info("[4/5] 生成知识蓝图图片...")
            try:
                image_data = self.generator.generate_blueprint(final_structure)
            except RuntimeError as exc:
                if _is_device_error(exc):
                    raise
                reason = "timeout" if "timeout" in str(exc) else "error"
                self.logger.warning(
                    f"event=image_generation_failed reason={reason} "
                    f"video_id={video_id} error={exc}"
                )
                image_data = None
                image_timeout = reason == "timeout"
            except Exception as exc:
                if _is_device_error(exc):
                    raise
                self.logger.error(f"图片生成失败: {exc}")
                image_data = None

            if image_data:
                self.logger.info("[5/5] 审核图片质量...")
                temp_png = self.output_dir / "temp" / f"{video_id}_temp.png"
                temp_png.parent.mkdir(parents=True, exist_ok=True)
                try:
                    self.generator.save_image(image_data, temp_png)
                    audit_result = auditor.audit_image(
                        image_path=temp_png,
                        knowledge_doc_content=note_markdown,
                    )
                    if not audit_result.passed:
                        self.logger.warning(
                            f"审核未通过 ({audit_result.score:.1f} < "
                            f"{auditor.threshold}); 丢弃图片"
                        )
                        image_data = None
                        audit_result = None
                except Exception as exc:
                    if _is_device_error(exc):
                        raise
                    # Audit crash (not a quality verdict): keep the image.
                    self.logger.warning(f"审核过程出错，保留原图: {exc}")
                finally:
                    if temp_png.exists():
                        temp_png.unlink()
        else:
            self.logger.warning("Visual Schema 为空，跳过图片生成与审核")

        image_relative_path = (
            f"../blueprints/{video_id}_mind_map.png" if image_data else None
        )
        document_content = analyzer.generate_report(
            analysis_result,
            image_relative_path,
            self_check_mode=self.self_check_mode,
        )
        if image_timeout:
            document_content = (
                "⚠️ Image generation timed out, Markdown-only output\n\n"
                + document_content
            )

        doc_path, blueprint_path = self._save_outputs(
            video_id=video_id,
            document_content=document_content,
            image_data=image_data,
            duration=analysis_result.metadata.get("duration"),
        )

        api_calls_used = self.api_counter.current_count - api_calls_start
        processing_time = time.time() - start_time
        if self.progress_tracker:
            self.progress_tracker.mark_processed(video_id)

        self.logger.info(
            f"event=video_complete video_id={video_id} "
            f"elapsed_s={processing_time:.1f}"
        )
        return ProcessResult(
            video_id=video_id,
            url=url,
            success=True,
            document_path=str(doc_path),
            blueprint_path=str(blueprint_path) if blueprint_path else None,
            api_calls_used=api_calls_used,
            processing_time=processing_time,
            validation_score=validation_score,
            audit_score=audit_result.score if audit_result else 0.0,
        )


    # -- batch flow --------------------------------------------------------------

    def process_batch(self, urls: list[str]) -> BatchResult:
        total = len(urls)
        self.logger.info(f"开始批量处理 {total} 个视频")
        result = BatchResult(total=total, successful=0, failed=0)

        for idx, url in enumerate(urls, 1):
            self.logger.info(f"处理进度: {idx}/{total}")
            if not self.api_counter.can_call():
                self.logger.warning(
                    f"API 调用次数已达上限,终止批量处理 (已处理 {idx - 1}/{total})"
                )
                break
            video_result = self.process_single_video(url)
            result.add_result(video_result)
            if video_result.success:
                result.successful += 1
            else:
                result.failed += 1

        self.logger.info(f"批量处理完成: {result}")
        return result

    def process_batch_sharded(self, urls: list[str]) -> BatchResult:
        """Batch mode that shards ANALYSIS across devices.

        All videos are resolved first, analyzed together through
        ContentAnalyzer.analyze_videos (short clips batch over the mesh data
        axis; long ones run their internally-batched segmented path), then
        post-processed per video. Falls back to the sequential flow when the
        batched analysis fails as a whole.
        """
        total = len(urls)
        self.logger.info(f"开始分片批量处理 {total} 个视频")
        result = BatchResult(total=total, successful=0, failed=0)

        analyzer = ContentAnalyzer(
            config=self.config,
            api_counter=self.api_counter,
            logger=self.logger,
            engine=self._engine,
            device=self.device,
        )
        auditor = QualityAuditor(
            config=self.config, api_counter=self.api_counter, logger=self.logger
        )

        # Phase 1: resolve every video (downloads overlap nothing on-device).
        pending: list[tuple[str, str, Path]] = []  # (url, video_id, path)
        start_times: dict[str, float] = {}
        for url in urls:
            start_times[url] = time.time()
            video_id = self._extract_video_id(url)
            if self.progress_tracker and self.progress_tracker.is_processed(
                video_id
            ):
                result.add_result(
                    ProcessResult(
                        video_id=video_id, url=url, success=True,
                        error_message="已处理(跳过)", processing_time=0.0,
                    )
                )
                result.successful += 1
                continue
            path = self.downloader.download_video(url)
            if not path:
                result.add_result(
                    ProcessResult(
                        video_id=video_id, url=url, success=False,
                        error_message="视频下载失败",
                        processing_time=time.time() - start_times[url],
                    )
                )
                result.failed += 1
                if self.progress_tracker:
                    self.progress_tracker.mark_failed(video_id, "视频下载失败")
                continue
            pending.append((url, video_id, path))

        if not pending:
            return result

        # Phase 2: one sharded analysis pass over everything pending.
        analysis_calls_start = self.api_counter.current_count
        try:
            analyses = analyzer.analyze_videos([p for _, _, p in pending])
        except Exception as exc:
            if _is_device_error(exc):
                raise
            self.logger.warning(
                f"event=sharded_batch_fallback error={exc}; 退回逐视频处理"
            )
            for url, _, _ in pending:
                video_result = self.process_single_video(url)
                result.add_result(video_result)
                if video_result.success:
                    result.successful += 1
                else:
                    result.failed += 1
            return result

        # Phase 3: per-video validation / render / audit / save. The shared
        # analysis cost is attributed evenly; finalize calls per video.
        analysis_share = (
            self.api_counter.current_count - analysis_calls_start
        ) // max(len(pending), 1)
        for (url, video_id, _), analysis in zip(pending, analyses):
            try:
                finalize_start = self.api_counter.current_count
                video_result = self._finalize_video(
                    video_id, url, analysis, analyzer, auditor,
                    start_times[url], finalize_start - analysis_share,
                )
            except Exception as exc:
                if _is_device_error(exc):
                    raise
                self.logger.error(
                    f"event=video_failed video_id={video_id} error={exc}"
                )
                if self.progress_tracker:
                    self.progress_tracker.mark_failed(video_id, str(exc))
                video_result = ProcessResult(
                    video_id=video_id, url=url, success=False,
                    error_message=str(exc),
                    processing_time=time.time() - start_times[url],
                )
            result.add_result(video_result)
            if video_result.success:
                result.successful += 1
            else:
                result.failed += 1

        self.logger.info(f"分片批量处理完成: {result}")
        return result

    # -- validation loop -----------------------------------------------------------

    def _validation_loop(
        self,
        initial_structure: str,
        knowledge_content: str,
        analyzer: ContentAnalyzer,
    ) -> tuple[str, float]:
        """Validate/rewrite up to max_rounds; never fails the video (a
        device error propagates).

        Returns (final structure, last validation score).
        """
        current = initial_structure
        last_score = 0.0
        if not current:
            self.logger.warning("Visual Schema 为空，跳过校验")
            return "", last_score

        for round_num in range(1, self.max_validation_rounds + 1):
            self.logger.info(f"  第 {round_num} 轮校验...")
            try:
                validation = self.validator.validate(
                    mind_map_structure=current,
                    knowledge_doc_content=knowledge_content,
                )
                last_score = validation.total_score
                self.logger.info(f"  校验得分: {validation.total_score:.1f}/100")
                if validation.passed:
                    return current, last_score
                self.logger.info(f"  反馈: {validation.feedback}")
                if round_num < self.max_validation_rounds:
                    current = analyzer.rewrite_visual_schema(
                        original_structure=current,
                        feedback=validation.feedback,
                    )
                else:
                    self.logger.warning(
                        f"  已达最大校验轮次 ({self.max_validation_rounds}),"
                        "使用当前结构"
                    )
            except Exception as exc:
                if _is_device_error(exc):
                    raise
                self.logger.error(f"  校验失败: {exc}")
                break
        return current, last_score

    # -- output --------------------------------------------------------------------

    def _save_outputs(
        self,
        video_id: str,
        document_content: str,
        image_data: bytes | None,
        duration: float | None = None,
    ) -> tuple[Path, Path | None]:
        system = self.config.get("system", {})
        refine_config = system.get("note_refine", {})
        if bool(refine_config.get("enabled", False)) and duration is not None:
            document_content = refine_note(
                document_content, duration_seconds=duration, config=refine_config
            )

        quality_config = system.get("quality_gates", {})
        if bool(quality_config.get("enabled", False)):
            note_profile = system.get("note_profile", "default")
            document_content, report = apply_quality_gates(
                document_content, str(note_profile), quality_config
            )
            report_path = self.doc_dir / f"{video_id}_quality_report.json"
            report_path.write_text(
                json.dumps(report, ensure_ascii=True, indent=2), encoding="utf-8"
            )
            self.logger.info(f"质量报告已保存: {report_path}")

        doc_path = self.doc_dir / f"{video_id}_knowledge_note.md"
        doc_path.write_text(document_content, encoding="utf-8")
        self.logger.info(f"文档已保存: {doc_path}")

        # Post-save lint (offline QA tool run inline): failures never block
        # the save, but they are visible in logs for operators.
        try:
            from ..tools.validate_note import validate_note

            profile = str(system.get("note_profile", "default"))
            lint = validate_note(document_content, profile=profile)
            if lint.errors:
                self.logger.warning(
                    f"event=note_lint video_id={video_id} status=fail "
                    f"errors={len(lint.errors)}: {'; '.join(lint.errors[:3])}"
                )
            else:
                self.logger.info(
                    f"event=note_lint video_id={video_id} status=pass "
                    f"format={lint.format} warnings={len(lint.warnings)}"
                )
        except Exception as exc:
            self.logger.warning(f"event=note_lint_error video_id={video_id} {exc}")

        blueprint_path = None
        if image_data:
            blueprint_path = self.blueprint_dir / f"{video_id}_mind_map.png"
            self.generator.save_image(image_data, blueprint_path)
            self.logger.info(f"图片已保存: {blueprint_path}")
        return doc_path, blueprint_path

    # -- helpers ---------------------------------------------------------------------

    @staticmethod
    def _resolve_self_check_mode(config: dict[str, Any]) -> str:
        mode = str(config.get("system", {}).get("self_check_mode", "lecture"))
        normalized = mode.strip().lower()
        return normalized if normalized in _MODES else "lecture"

    @staticmethod
    def _resolve_include_concept_index(config: dict[str, Any]) -> bool:
        system = config.get("system", {})
        render = system.get("render", {})
        if "include_concept_index" in render:
            return bool(render.get("include_concept_index"))
        return str(system.get("note_profile", "default")).lower() != "pdf"

    @staticmethod
    def _extract_video_id(url: str) -> str:
        """Bilibili BV id (+ _p{N} part suffix), YouTube 11-char id, local
        file stem, or a url-hash fallback (reference pipeline.py:537-572)."""
        bv_match = re.search(r"BV[a-zA-Z0-9]+", url)
        if bv_match:
            video_id = bv_match.group(0)
            p_match = re.search(r"[?&]p=(\d+)", url)
            if p_match:
                video_id = f"{video_id}_p{p_match.group(1)}"
            return video_id

        yt_match = re.search(r"(?:v=|/)([a-zA-Z0-9_-]{11})(?:[&?#]|$)", url)
        if yt_match:
            return yt_match.group(1)

        path = Path(url)
        if path.suffix and not url.startswith(("http://", "https://")):
            return path.stem

        return hashlib.md5(url.encode()).hexdigest()[:12]
