"""The port's VideoPipeline, WatchService and auditor on stub components (CPU).

The JAX tests of the pipeline (``tests/test_pipeline.py``), the service
(``tests/test_service.py``) and the vision audit (``tests/test_auditor.py``)
are rerun against the port: each case is called with its module's names
rebound to the port's classes and to copies of the stubs made here
(``rerun`` from ``test_torch_pipeline_pure``). The observability contract
(``tests/test_observability.py``) is restated for the port.

Device errors (ROADMAP §3, a deliberate difference): at each place where
the JAX pipeline catches every exception, a ``torch.OutOfMemoryError``
("CUDA out of memory") raised by a stub propagates out of the port, while
a ``ValueError`` there gives the JAX pipeline's result (the
``ProcessResult`` without its time, the saved note, the progress file).
"""

import json
import logging
import re
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.test_auditor as j_auditor_tests
import tests.test_pipeline as j_pipeline_tests
import tests.test_service as j_service_tests
from tests.test_torch_pipeline_pure import cases, rerun
from video_transformer_tpu.pipeline.pipeline import VideoPipeline as JPipeline
from video_transformer_tpu.pipeline.auditor import QualityAuditor as JAuditor
from video_transformer_tpu.pipeline.validator import ConsistencyValidator as JValidator
from video_transformer_tpu.utils.counter import APICounter as JCounter
from video_transformer_tpu.utils.progress import ProgressTracker as JTracker
from video_transformer_tpu_torch.contracts import (AnalysisResult, KnowledgeDocument, ProcessResult,
                                                   VisualSchemaItem)
from video_transformer_tpu_torch.pipeline.auditor import QualityAuditor
from video_transformer_tpu_torch.pipeline.pipeline import VideoPipeline
from video_transformer_tpu_torch.pipeline.service import WatchService
from video_transformer_tpu_torch.pipeline.validator import ConsistencyValidator, ValidationResult
from video_transformer_tpu_torch.pipeline.visualizer import ImageGenerator, parse_schema_graph
from video_transformer_tpu_torch.utils.counter import APICounter
from video_transformer_tpu_torch.utils.progress import ProgressTracker
from video_transformer_tpu_torch.video.containers import write_npzv

# -- stubs (copies of tests/test_pipeline.py's, on the port's contracts) -------------


def make_result(video_path="v.npzv"):
    doc = KnowledgeDocument(
        title="测试笔记", one_sentence_summary="核心总结。", key_takeaways=["结论一"],
        deep_dive=[{"chapter_title": "章一", "chapter_summary": "概述。",
                    "chapter_self_check": [{"q": "问?", "a": "答。"}],
                    "sections": [{"topic": "主题", "explanation": "解释内容。", "example": "示例。"}]}],
        glossary={"术语": "定义"},
        visual_schemas=[VisualSchemaItem("overview", "总览", "测试笔记\n章一 -> 主题")],
    )
    return AnalysisResult(video_path=video_path, knowledge_doc=doc, metadata={"duration": 60.0})


class StubAnalyzer:
    def __init__(self, result=None, fail=False):
        self.result = result or make_result()
        self.fail = fail
        self.raises = {}  # where -> exception (the device-error tests)
        self.rewrites = 0

    def _maybe_raise(self, where):
        if where in self.raises:
            raise self.raises[where]

    def analyze_video(self, path):
        self._maybe_raise("analyze")
        if self.fail:
            raise RuntimeError("分析失败")
        return self.result

    def generate_report(self, analysis, image_relative_path=None, self_check_mode="static"):
        self._maybe_raise("report")
        return analysis.knowledge_doc.to_markdown(
            image_paths=[image_relative_path] if image_relative_path else None, self_check_mode=self_check_mode)

    def rewrite_visual_schema(self, original_structure, feedback):
        self._maybe_raise("rewrite")
        self.rewrites += 1
        return original_structure + f"\n(改写 {self.rewrites})"


class StubValidator:
    def __init__(self, scores):
        self.scores = list(scores)
        self.calls = 0

    def validate(self, mind_map_structure, knowledge_doc_content):
        score = self.scores[min(self.calls, len(self.scores) - 1)]
        self.calls += 1
        return ValidationResult(total_score=score, passed=score >= 75, feedback="需要改进")


class StubGenerator:
    def __init__(self, data=b"x" * 2048, fail=False):
        self.data = data
        self.fail = fail

    def generate_blueprint(self, structure):
        if self.fail:
            raise RuntimeError("render timeout")
        return self.data

    def save_image(self, data, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_bytes(data)


@dataclass
class StubAuditResult:
    score: float
    passed: bool
    feedback: str = ""


class StubAuditor:
    threshold = 75.0

    def __init__(self, score=90.0):
        self.score = score

    def audit_image(self, image_path, knowledge_doc_content):
        return StubAuditResult(score=self.score, passed=self.score >= 75)


def build_pipeline(tmp_path, monkeypatch, analyzer=None, validator=None, generator=None, auditor=None,
                   pipeline_cls=VideoPipeline, module="video_transformer_tpu_torch", counter=APICounter,
                   **system_overrides):
    config = j_pipeline_tests.make_config(tmp_path, **system_overrides)
    logger = logging.getLogger("test_pipeline")
    pipeline = pipeline_cls(config, logger, counter(max_calls=100))
    analyzer = analyzer or StubAnalyzer()
    monkeypatch.setattr(f"{module}.pipeline.pipeline.ContentAnalyzer", lambda **kwargs: analyzer)
    if auditor is not None:
        monkeypatch.setattr(f"{module}.pipeline.pipeline.QualityAuditor", lambda **kwargs: auditor)
    if validator is not None:
        pipeline.validator = validator
    if generator is not None:
        pipeline.generator = generator
    return pipeline, analyzer


PORT_NAMES = {
    "VideoPipeline": VideoPipeline, "ValidationResult": ValidationResult, "ImageGenerator": ImageGenerator,
    "parse_schema_graph": parse_schema_graph, "APICounter": APICounter, "ProgressTracker": ProgressTracker,
    "AnalysisResult": AnalysisResult, "KnowledgeDocument": KnowledgeDocument, "VisualSchemaItem": VisualSchemaItem,
    "make_result": make_result, "StubAnalyzer": StubAnalyzer, "StubValidator": StubValidator,
    "StubGenerator": StubGenerator, "StubAuditor": StubAuditor, "StubAuditResult": StubAuditResult,
    "build_pipeline": build_pipeline,
}


@pytest.fixture
def clip(tmp_path):
    path = tmp_path / "vid.npzv"
    write_npzv(path, np.zeros((8, 16, 16, 3), dtype=np.uint8), fps=4.0)
    return path


# -- the JAX cases, rerun against the port ---------------------------------------------

PIPELINE_CASES = cases(j_pipeline_tests, ("TestSingleVideoFlow", "TestBatchFlow", "TestShardedBatch",
                                          "TestVideoIdExtraction", "TestLocalVisualizer"))


@pytest.mark.parametrize("cls, fn", PIPELINE_CASES)
def test_pipeline_cases_hold_the_port(cls, fn, tmp_path, monkeypatch, clip):
    import inspect

    available = {"tmp_path": tmp_path, "monkeypatch": monkeypatch, "clip": clip}
    names = list(inspect.signature(fn).parameters)[1:]
    rerun(j_pipeline_tests, PORT_NAMES, fn, cls(), *[available[n] for n in names])


@pytest.mark.parametrize("cls, fn", cases(j_service_tests, ("TestWatchService",)))
def test_service_cases_hold_the_port(cls, fn, tmp_path):
    rerun(j_service_tests, {"WatchService": WatchService, "ProcessResult": ProcessResult}, fn, cls(), tmp_path)


@pytest.mark.parametrize("name", ["test_matched_image_passes_mismatched_fails", "test_image_clip_geometry",
                                  "test_engine_failure_defaults_to_pass"])
def test_auditor_cases_hold_the_port(name, tmp_path):
    rerun(j_auditor_tests, {"QualityAuditor": QualityAuditor, "APICounter": APICounter},
          getattr(j_auditor_tests, name), tmp_path)


def test_pipeline_event_log_contract(tmp_path, monkeypatch, caplog, clip):
    pipeline, _ = build_pipeline(tmp_path, monkeypatch, validator=StubValidator([90]), auditor=StubAuditor(90))
    with caplog.at_level(logging.INFO, logger="test_pipeline"):
        pipeline.process_single_video(str(clip))
    text = "\n".join(r.getMessage() for r in caplog.records)
    start = re.search(r"event=video_start video_id=(\S+)", text)
    complete = re.search(r"event=video_complete video_id=(\S+) elapsed_s=([\d.]+)", text)
    assert start and start.group(1) == "vid"
    assert complete and complete.group(1) == "vid" and float(complete.group(2)) >= 0
    assert re.search(r"event=note_lint video_id=vid status=(pass|fail)", text)


def test_pipeline_failure_event(tmp_path, monkeypatch, caplog, clip):
    pipeline, _ = build_pipeline(tmp_path, monkeypatch, analyzer=StubAnalyzer(fail=True))
    with caplog.at_level(logging.INFO, logger="test_pipeline"):
        pipeline.process_single_video(str(clip))
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert re.search(r"event=video_failed video_id=vid elapsed_s=[\d.]+", text)


def test_engine_built_once_is_shared(tmp_path, monkeypatch, clip):
    """The port keeps the engine the first analyzer built and injects it
    into later analyzers (the JAX pipeline injects only an engine it was
    given)."""
    built = []

    class Analyzer(StubAnalyzer):
        def __init__(self, engine=None, **kwargs):
            super().__init__()
            self._engine = engine if engine is not None else object()
            built.append(engine)

    monkeypatch.setattr("video_transformer_tpu_torch.pipeline.pipeline.ContentAnalyzer", Analyzer)
    monkeypatch.setattr("video_transformer_tpu_torch.pipeline.pipeline.QualityAuditor",
                        lambda **kwargs: StubAuditor(90))
    config = j_pipeline_tests.make_config(tmp_path)
    pipeline = VideoPipeline(config, logging.getLogger("t"), APICounter(100), device="cpu")
    pipeline.validator = StubValidator([90])
    for _ in range(3):
        assert pipeline.process_single_video(str(clip)).success
    assert built[0] is None and built[1] is built[2] is pipeline._engine is not None


def test_device_defaults_to_cuda(tmp_path):
    config = j_pipeline_tests.make_config(tmp_path)
    assert VideoPipeline(config, logging.getLogger("t"), APICounter(5)).device == "cuda"
    service = WatchService({"system": dict(config["system"], max_api_calls=3), **{
        k: v for k, v in config.items() if k != "system"}}, logging.getLogger("t"), tmp_path / "in")
    assert service.pipeline.device == "cuda"


# -- device errors propagate; other errors keep JAX's result ------------------------------

OOM = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 429.00 MiB")
SITES = {
    # site: (stub role, where, entry)
    "result": ("analyzer", "analyze", "single"),
    "render": ("generator", None, "single"),
    "audit": ("auditor", None, "single"),
    "validation_loop": ("validator", None, "single"),
    "rewrite": ("analyzer", "rewrite", "single"),
    "sharded_fallback": ("analyzer", "analyze_videos", "sharded"),
    "sharded_entry": ("analyzer", "report", "sharded"),
}


def _stubs(site: str, exc: Exception, analyzer_cls, validator_cls, generator_cls, auditor_cls, result):
    role, where, _ = SITES[site]
    analyzer = analyzer_cls(result=result())
    if role == "analyzer" and where != "analyze_videos":
        analyzer.raises = {where: exc}
    if where == "analyze_videos":
        def boom(paths):
            raise exc
        analyzer.analyze_videos = boom
    elif site == "sharded_entry":
        analyzer.analyze_videos = lambda paths: [result(str(p)) for p in paths]
    validator = validator_cls([50 if site == "rewrite" else 90])
    if role == "validator":
        validator.validate = lambda **kwargs: (_ for _ in ()).throw(exc)
    generator = generator_cls()
    if role == "generator":
        generator.generate_blueprint = lambda structure: (_ for _ in ()).throw(exc)
    auditor = auditor_cls(90)
    if role == "auditor":
        auditor.audit_image = lambda **kwargs: (_ for _ in ()).throw(exc)
    return dict(analyzer=analyzer, validator=validator, generator=generator, auditor=auditor)


class JStubAnalyzer(j_pipeline_tests.StubAnalyzer):
    """The JAX tests' analyzer stub with the raise points of the port's."""

    def __init__(self, result=None):
        super().__init__(result)
        self.raises = {}

    def analyze_video(self, path):
        if "analyze" in self.raises:
            raise self.raises["analyze"]
        return super().analyze_video(path)

    def generate_report(self, *args, **kwargs):
        if "report" in self.raises:
            raise self.raises["report"]
        return super().generate_report(*args, **kwargs)

    def rewrite_visual_schema(self, *args, **kwargs):
        if "rewrite" in self.raises:
            raise self.raises["rewrite"]
        return super().rewrite_visual_schema(*args, **kwargs)


def _run(pipeline, entry, clip, tmp_path):
    if entry == "single":
        return [pipeline.process_single_video(str(clip))]
    return pipeline.process_batch_sharded([str(clip), str(tmp_path / "missing.npzv")]).results


def _outcome(results, root: Path) -> dict:
    out = []
    for result in results:
        data = asdict(result)
        data.pop("processing_time")
        for key in ("document_path", "blueprint_path"):
            if data[key]:
                path = Path(data[key])
                data[key] = (path.relative_to(root).as_posix(), path.read_bytes())
        out.append(data)
    progress = root / "temp" / "progress.json"
    return {"results": out, "progress": json.loads(progress.read_text()) if progress.exists() else None}


def _strip_times(value):
    if isinstance(value, dict):
        return {k: _strip_times(v) for k, v in value.items() if k not in ("last_updated", "timestamp")}
    return value


@pytest.mark.parametrize("site", sorted(SITES))
def test_device_error_propagates_other_errors_keep_jax_result(site, tmp_path, monkeypatch):
    _, _, entry = SITES[site]
    clip = tmp_path / "vid.npzv"
    write_npzv(clip, np.zeros((8, 16, 16, 3), dtype=np.uint8), fps=4.0)
    outcomes = []
    for side in ("j", "p"):
        root = tmp_path / side
        if side == "j":
            stubs = _stubs(site, ValueError("bad value"), JStubAnalyzer, j_pipeline_tests.StubValidator,
                           j_pipeline_tests.StubGenerator, j_pipeline_tests.StubAuditor, j_pipeline_tests.make_result)
            pipeline, _ = build_pipeline(root, monkeypatch, pipeline_cls=JPipeline, module="video_transformer_tpu",
                                         counter=JCounter, **stubs)
            pipeline.progress_tracker = JTracker(root / "temp" / "progress.json", logging.getLogger("t"))
        else:
            stubs = _stubs(site, ValueError("bad value"), StubAnalyzer, StubValidator, StubGenerator, StubAuditor,
                           make_result)
            pipeline, _ = build_pipeline(root, monkeypatch, **stubs)
            pipeline.progress_tracker = ProgressTracker(root / "temp" / "progress.json", logging.getLogger("t"))
        outcomes.append(_outcome(_run(pipeline, entry, clip, tmp_path), root))
    assert _strip_times(outcomes[1]) == _strip_times(outcomes[0])

    stubs = _stubs(site, OOM, StubAnalyzer, StubValidator, StubGenerator, StubAuditor, make_result)
    pipeline, _ = build_pipeline(tmp_path / "oom", monkeypatch, **stubs)
    pipeline.progress_tracker = ProgressTracker(tmp_path / "oom" / "temp" / "progress.json", logging.getLogger("t"))
    with pytest.raises(torch.OutOfMemoryError):
        _run(pipeline, entry, clip, tmp_path)
    assert not pipeline.progress_tracker.get_failed_videos() or entry == "sharded"


class RaisingEngine:
    """The engine surface the validator and the auditor call, raising."""

    def __init__(self, exc):
        self.exc = exc
        self.byte_vocab = 512
        self.config = type("Cfg", (), {"encoder": type("Enc", (), {"num_frames": 4})()})()

    def wrap_grammar(self, dfa):
        return dfa

    def generate_text(self, *args, **kwargs):
        raise self.exc

    def generate(self, *args, **kwargs):
        raise self.exc


def test_validator_fail_safe_never_swallows_a_device_error():
    config = {"validator": {"threshold": 75, "use_engine": True}}
    schema, note = "测试笔记\n章一 -> 主题", "# 测试笔记\n## 章一\n主题"
    got = ConsistencyValidator(config, APICounter(5), engine=RaisingEngine(ValueError("x"))).validate(schema, note)
    want = JValidator(config, JCounter(5), engine=RaisingEngine(ValueError("x"))).validate(schema, note)
    assert vars(got) == vars(want) and got.total_score == 0.0
    with pytest.raises(torch.OutOfMemoryError):
        ConsistencyValidator(config, APICounter(5), engine=RaisingEngine(OOM)).validate(schema, note)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ConsistencyValidator(config, APICounter(5), engine=RaisingEngine(
            RuntimeError("CUDA error: an illegal memory access"))).validate(schema, note)


def test_auditor_default_pass_never_swallows_a_device_error(tmp_path):
    path = tmp_path / "b.png"
    path.write_bytes(ImageGenerator({}).generate_blueprint("标题\nA -> B"))
    config = {"auditor": {"threshold": 75, "use_engine": True}}
    got = QualityAuditor(config, APICounter(5), engine=RaisingEngine(ValueError("x"))).audit_image(path, "n")
    want = JAuditor(config, JCounter(5), engine=RaisingEngine(ValueError("x"))).audit_image(path, "n")
    assert vars(got) == vars(want) and got.passed
    with pytest.raises(torch.OutOfMemoryError):
        QualityAuditor(config, APICounter(5), engine=RaisingEngine(OOM)).audit_image(path, "n")
