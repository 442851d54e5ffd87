"""The port's pure pipeline modules against the JAX package's (CPU, exact).

``utils/{refiner_contract,refiner,quality,progress,logger,proxy}.py``,
``tools/validate_note.py``, ``pipeline/downloader.py``, ``exceptions.py``,
the validator's structural scorer and ``VideoPipeline._extract_video_id``
are copies of the JAX package's modules. Each is held to its original with
exact equality: on the notes of the JAX tests (``test_refine_and_pacer``,
``test_legacy_rebuild``, ``test_tools_cli``), on notes rendered by the
port's contracts in every mode, and on notes that hypothesis assembles from
the headings and lines the gates and the linter look for. The JAX tests'
own cases are also rerun against the port: each test function is called
with its module's names rebound to the port's (``rerun``), so the same
assertions hold both copies.
"""

import copy
import inspect
import json
import logging
import sys
import types
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import tests.test_legacy_rebuild as j_legacy_tests
import tests.test_refine_and_pacer as j_refine_tests
import tests.test_tools_cli as j_tools_tests
from video_transformer_tpu import exceptions as j_exceptions
from video_transformer_tpu.pipeline import downloader as j_downloader
from video_transformer_tpu.pipeline.pipeline import VideoPipeline as JPipeline
from video_transformer_tpu.pipeline.validator import ConsistencyValidator as JValidator
from video_transformer_tpu.tools import validate_note as j_lint
from video_transformer_tpu.utils import logger as j_logger
from video_transformer_tpu.utils import progress as j_progress
from video_transformer_tpu.utils import quality as j_quality
from video_transformer_tpu.utils import refiner as j_refiner
from video_transformer_tpu.utils import refiner_contract as j_contract
from video_transformer_tpu.utils.counter import APICounter as JCounter
from video_transformer_tpu_torch import exceptions as p_exceptions
from video_transformer_tpu_torch.contracts import AnalysisResult, KnowledgeDocument, VisualSchemaItem
from video_transformer_tpu_torch.pipeline import downloader as p_downloader
from video_transformer_tpu_torch.pipeline.pipeline import VideoPipeline
from video_transformer_tpu_torch.pipeline.validator import ConsistencyValidator
from video_transformer_tpu_torch.tools import validate_note as p_lint
from video_transformer_tpu_torch.utils import logger as p_logger
from video_transformer_tpu_torch.utils import progress as p_progress
from video_transformer_tpu_torch.utils import proxy as p_proxy
from video_transformer_tpu_torch.utils import quality as p_quality
from video_transformer_tpu_torch.utils import refiner as p_refiner
from video_transformer_tpu_torch.utils import refiner_contract as p_contract
from video_transformer_tpu_torch.utils.counter import APICounter, APILimitExceeded
from video_transformer_tpu_torch.utils.pacer import InferencePacer, RateLimitError


def rerun(module: types.ModuleType, names: dict, test, *args):
    """Call ``test`` (a function or method of ``module``) with every
    function of the module rebound to globals where ``names`` replace the
    JAX package's objects by the port's."""
    env = dict(vars(module), **names)
    for key, value in list(env.items()):
        if isinstance(value, types.FunctionType) and value.__globals__ is vars(module):
            env[key] = types.FunctionType(value.__code__, env, value.__name__, value.__defaults__, value.__closure__)
    fn = types.FunctionType(test.__code__, env, test.__name__, test.__defaults__, test.__closure__)
    return fn(*args)


def cases(module: types.ModuleType, classes: tuple[str, ...]):
    out = []
    for cls_name in classes:
        cls = getattr(module, cls_name)
        for name, fn in vars(cls).items():
            if name.startswith("test_"):
                out.append(pytest.param(cls, fn, id=f"{cls_name}.{name}"))
    return out


REFINE_NAMES = {"refine_note": p_refiner.refine_note, "is_lecture_note": p_refiner.is_lecture_note,
                "rebuild_legacy_note": p_refiner.rebuild_legacy_note,
                "VideoDownloader": p_downloader.VideoDownloader, "InferencePacer": InferencePacer,
                "RateLimitError": RateLimitError,
                **{name: getattr(p_contract, name) for name in dir(j_contract) if name.isupper()}}
LINT_NAMES = {"validate_note": p_lint.validate_note, "validate_file": p_lint.validate_file,
              "detect_format": p_lint.detect_format}


def _call(cls, fn, module, names, tmp_path):
    args = [cls()] + ([tmp_path] if "tmp_path" in inspect.signature(fn).parameters else [])
    rerun(module, names, fn, *args)


@pytest.mark.parametrize("cls, fn", cases(j_refine_tests, ("TestRefineNote", "TestInferencePacer", "TestDownloader")))
def test_refine_pacer_and_downloader_cases_hold_the_port(cls, fn, tmp_path):
    _call(cls, fn, j_refine_tests, REFINE_NAMES, tmp_path)


@pytest.mark.parametrize("cls, fn", cases(j_legacy_tests, ("TestLegacyRebuild",)))
def test_legacy_rebuild_cases_hold_the_port(cls, fn, tmp_path):
    _call(cls, fn, j_legacy_tests, REFINE_NAMES, tmp_path)


@pytest.mark.parametrize("cls, fn", cases(j_tools_tests, ("TestValidateNote",)))
def test_validate_note_cases_hold_the_port(cls, fn, tmp_path):
    _call(cls, fn, j_tools_tests, LINT_NAMES, tmp_path)


def test_rerun_reaches_the_port():
    """The rebinding is real: a port function that raises fails the case."""
    def broken(*args, **kwargs):
        raise AssertionError("the port's refine_note ran")

    with pytest.raises(AssertionError, match="port's refine_note ran"):
        rerun(j_refine_tests, dict(REFINE_NAMES, refine_note=broken),
              j_refine_tests.TestRefineNote.test_under_budget_untouched, j_refine_tests.TestRefineNote())


# -- notes -----------------------------------------------------------------------


def rendered_notes() -> list[str]:
    """Notes the port's contracts render from a two-chapter document in each
    mode, with the concept index on and off."""
    doc = KnowledgeDocument(
        title="测试笔记", one_sentence_summary="核心总结。", key_takeaways=["结论一 梯度下降", "结论二"],
        deep_dive=[{"chapter_title": f"第{c}部分", "chapter_summary": "概述。",
                    "chapter_self_check": [{"q": "问?", "a": "答。"}],
                    "sections": [{"topic": f"主题{c}-{s}", "explanation": "解释内容。\n" * (3 + s),
                                  "example": "示例。", "code": "print(1)" if s else ""} for s in range(3)]}
                   for c in range(1, 3)],
        glossary={"术语": "定义", "梯度下降": "一种优化方法"},
        visual_schemas=[VisualSchemaItem("overview", "总览", "测试笔记\n章一 -> 主题")],
    )
    result = AnalysisResult(video_path="v.npzv", knowledge_doc=doc, metadata={"duration": 60.0})
    notes = []
    for mode in ("static", "interactive", "questions_only", "lecture"):
        for index in (True, False):
            notes.append(result.to_markdown(self_check_mode=mode, include_concept_index=index))
    notes.append(doc.to_markdown(self_check_mode="default"))
    return notes


def jax_test_notes() -> list[str]:
    notes = [j_refine_tests.lecture_note(), j_refine_tests.lecture_note(n_bullets=600, n_code_blocks=6),
             j_legacy_tests.legacy_note(), j_legacy_tests.legacy_note(explanation_lines=200),
             j_legacy_tests.legacy_note().replace("#### 3. 交叉验证", "#### 3. 梯度 下降"),
             j_tools_tests.lecture_note(), j_tools_tests.deep_note(), j_tools_tests.legacy_note(),
             j_tools_tests.deep_note(exercises=2), "# 短笔记\n\n正文。", ""]
    return notes + rendered_notes()


NOTE_LINES = [
    "# 标题", "## 核心概念图谱", "## 主题详解", "## 实战与代码", "## FAQ / 避坑指南", "## 📎 附录 (Appendix)",
    "## 📝 关键结论 (Key Takeaways)", "## 📖 关键术语表 (Glossary)", "## 🔍 深度解析 (Deep Dive)",
    "### 第1章：基础", "### 第2章：基础", "### 第3章：进阶：补充", "### 概念索引", "### 代码与伪代码",
    "### 示例 1：A", "### 示例 2：B", "#### 1. 梯度下降", "#### 2. 正则化 (0:30)", "**💡 原理解析**：",
    "**⚠️ 常见误区**：", "- **过拟合**: 记住噪声", "- 要点", "- 梯度下降 是基石", "  续行", "逐行说明：",
    "1: 完成关键计算或调用步骤。", "2：完成关键计算或调用步骤", "3: 真实说明", "练习与答解：",
    "答：因为 X 直接影响核心流程的效果与可解释性。", "答：5", "1. 练习", "```python", "print(1)", "```",
    "- 片段 :05-:30", "- 以下片段未覆盖或分析失败", "$x^2$", "$$y$$", "<details>", "在 12:34 讲了", "TODO",
    "{'a': 1}", "", "正文一句。",
]
notes_strategy = st.lists(st.sampled_from(NOTE_LINES), min_size=0, max_size=120).map("\n".join)


def _refine_configs():
    return [{}, {"min_lines": 20, "max_lines": 40}, {"min_lines": 5, "max_lines": 12, "lines_per_hour": 30},
            {"min_lines": 10, "max_lines": 30, "exclude_code_from_budget": True, "tolerance_ratio": 0.0}]


def assert_pure_equal(note: str) -> None:
    for config in _refine_configs():
        for duration in (0.0, 60.0, 1800.0, 7200.0):
            assert p_refiner.refine_note(note, duration, config) == j_refiner.refine_note(note, duration, config)
    for target in (1, 30, 200):
        assert p_refiner.rebuild_legacy_note(note, target) == j_refiner.rebuild_legacy_note(note, target)
    assert p_refiner.is_lecture_note(note) == j_refiner.is_lecture_note(note)
    for profile in ("default", "pdf"):
        for config in ({"enabled": True}, {"enabled": False}, None):
            assert p_quality.apply_quality_gates(note, profile, config) == \
                j_quality.apply_quality_gates(note, profile, config)
        got, want = p_lint.validate_note(note, profile), j_lint.validate_note(note, profile)
        assert (got.format, got.errors, got.warnings) == (want.format, want.errors, want.warnings)
    for exclude in (True, False):
        assert p_contract.count_budget_lines(note, exclude) == j_contract.count_budget_lines(note, exclude)
    for line in note.splitlines():
        assert p_contract.normalize_topic_title(line) == j_contract.normalize_topic_title(line)
        assert p_contract.normalize_takeaway(line) == j_contract.normalize_takeaway(line)


@pytest.mark.parametrize("index", range(len(jax_test_notes())))
def test_pure_modules_equal_on_the_jax_tests_and_rendered_notes(index):
    assert_pure_equal(jax_test_notes()[index])


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(note=notes_strategy)
def test_pure_modules_equal_on_assembled_notes(note):
    assert_pure_equal(note)


def test_refiner_contract_constants_and_budgets_equal():
    for name in dir(j_contract):
        if name.isupper():
            assert getattr(p_contract, name) == getattr(j_contract, name), name
    for seconds in (0, 1, 59.5, 600, 1800, 3600, 5400, 7200, 10_000, 86_400):
        assert p_contract.budget_for_duration(seconds) == j_contract.budget_for_duration(seconds)
        spec = p_contract.BudgetSpec(lines_per_hour=123, min_cap=7, max_cap=99, tolerance_ratio=0.25)
        j_spec = j_contract.BudgetSpec(lines_per_hour=123, min_cap=7, max_cap=99, tolerance_ratio=0.25)
        assert p_contract.budget_for_duration(seconds, spec) == j_contract.budget_for_duration(seconds, j_spec)
    assert p_contract.format_budget_warning(12, 7) == j_contract.format_budget_warning(12, 7)
    assert p_contract.build_coverage_index_lines(["a", "b"]) == j_contract.build_coverage_index_lines(["a", "b"])
    assert tuple(p_contract.KeyTakeawayMappingRules()) == tuple(j_contract.KeyTakeawayMappingRules())


# -- progress, logger, ids, downloader, exceptions, proxy ---------------------------


class Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[tuple[str, str]] = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _logger(name: str) -> tuple[logging.Logger, Capture]:
    logger = logging.getLogger(name)
    logger.handlers, logger.propagate = [Capture()], False
    logger.setLevel(logging.DEBUG)
    return logger, logger.handlers[0]


def _drive_progress(module, path: Path, logger) -> dict:
    tracker = module.ProgressTracker(path, logger)
    tracker.mark_processed("a")
    tracker.mark_failed("b", "boom")
    tracker.mark_failed("a", "late")
    tracker.mark_processed("b")
    tracker.mark_processed("b")
    out = {"stats": tracker.get_statistics(), "failed": copy.deepcopy(tracker.get_failed_videos()),
           "filter": tracker.filter_unprocessed(["a", "b", "c"]), "is": [tracker.is_processed("a"),
                                                                       tracker.is_failed("a")]}
    reloaded = module.ProgressTracker(path, logger)
    out["reloaded"] = reloaded.get_statistics()
    reloaded.reset()
    out["after_reset"] = json.loads(path.read_text(encoding="utf-8"))
    path.write_text("{corrupt", encoding="utf-8")
    out["corrupt"] = module.ProgressTracker(path, logger).data
    return out


def _no_times(value):
    if isinstance(value, dict):
        return {k: _no_times(v) for k, v in value.items() if k not in ("last_updated", "timestamp")}
    return value


def test_progress_tracker_equal(tmp_path):
    j_log, j_cap = _logger("vtx.pure.progress.j")
    p_log, p_cap = _logger("vtx.pure.progress.p")
    want = _drive_progress(j_progress, tmp_path / "j" / "progress.json", j_log)
    got = _drive_progress(p_progress, tmp_path / "p" / "progress.json", p_log)
    assert _no_times(got) == _no_times(want)
    strip = lambda lines: [(lvl, msg.replace(str(tmp_path / "p"), "X").replace(str(tmp_path / "j"), "X"))  # noqa: E731
                           for lvl, msg in lines]
    assert strip(p_cap.lines) == strip(j_cap.lines)


def test_logger_contract_equal(tmp_path):
    assert p_logger.LOGGER_NAME == j_logger.LOGGER_NAME
    assert p_logger._LINE_FORMAT == j_logger._LINE_FORMAT
    logger = logging.getLogger(p_logger.LOGGER_NAME)
    saved = logger.handlers[:]
    logger.handlers = []
    try:
        built = p_logger.setup_logging(tmp_path / "logs", "run.log")
        assert built is logger and len(logger.handlers) == 2 and not logger.propagate
        assert p_logger.setup_logging(tmp_path / "other") is logger and len(logger.handlers) == 2
        logger.info("event=video_start video_id=x")
        for handler in logger.handlers:
            handler.flush()
        line = (tmp_path / "logs" / "run.log").read_text(encoding="utf-8").strip()
        assert line.endswith("[INFO] event=video_start video_id=x")
    finally:
        for handler in logger.handlers:
            handler.close()
        logger.handlers = saved


URLS = [
    "https://www.bilibili.com/video/BV1xx411c7mD", "https://www.bilibili.com/video/BV1xx411c7mD?p=3",
    "https://www.bilibili.com/video/BV1xx411c7mD?t=5&p=12", "https://www.youtube.com/watch?v=dQw4w9WgXcQ",
    "https://youtu.be/dQw4w9WgXcQ", "/data/clips/lecture01.npzv", "clips/a.y4m", "https://example.com/weird",
    "file:///tmp/x.npzv", "lecture", "",
]


@pytest.mark.parametrize("url", URLS)
def test_extract_video_id_equal(url):
    assert VideoPipeline._extract_video_id(url) == JPipeline._extract_video_id(url)


def test_downloader_local_paths_equal(tmp_path):
    config = {"downloader": {"retry_times": 1}, "system": {"temp_dir": str(tmp_path / "t")}}
    (tmp_path / "a.npzv").write_bytes(b"x")
    (tmp_path / "b.mp4").write_bytes(b"x" * 1024)
    (tmp_path / "plain").write_bytes(b"x")
    urls = [str(tmp_path / "a.npzv"), f"file://{tmp_path / 'a.npzv'}", str(tmp_path / "missing.npzv"),
            str(tmp_path / "plain"), str(tmp_path / "b.mp4")]
    j, p = j_downloader.VideoDownloader(config), p_downloader.VideoDownloader(config)
    for url in urls:
        assert p.download_video(url) == j.download_video(url)
        assert p._resolve_local(url) == j._resolve_local(url)
    for path in (tmp_path / "a.npzv", tmp_path / "b.mp4", tmp_path / "missing.npzv"):
        assert p.validate_video(path) == j.validate_video(path)
    assert p._ydl_opts("T") == j._ydl_opts("T")


def test_downloader_without_yt_dlp_raises_the_jax_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yt_dlp", None)
    config = {"system": {"temp_dir": str(tmp_path)}}
    with pytest.raises(RuntimeError, match="yt-dlp is not installed") as got:
        p_downloader.VideoDownloader(config)._ytdlp_download("https://example.com/v")
    with pytest.raises(RuntimeError) as want:
        j_downloader.VideoDownloader(config)._ytdlp_download("https://example.com/v")
    assert str(got.value) == str(want.value)


def test_exceptions_equal():
    assert p_exceptions.__all__ == j_exceptions.__all__
    assert p_exceptions.APILimitExceeded is APILimitExceeded
    assert issubclass(p_exceptions.EngineError, RuntimeError)
    assert issubclass(p_exceptions.KeyExhaustedError, Exception)


def test_proxy_without_requests_returns_false(monkeypatch):
    monkeypatch.setitem(sys.modules, "requests", None)
    assert p_proxy.verify_proxy_connection("http://localhost:1") is False
    assert p_proxy.verify_sdk_endpoint("http://localhost:1") is False


SCHEMAS = ["知识蓝图\n输入 -> 编码器 -> 解码器\n- 损失函数", "A", "梯度下降 | 正则化: 交叉验证", "",
           "x\ny\nz -> w → v", "::::", "测试笔记\n章一 -> 主题"]


@settings(max_examples=40, deadline=None)
@given(schema=st.sampled_from(SCHEMAS) | st.text(max_size=80), note_index=st.integers(0, 5))
def test_structural_score_equal(schema, note_index):
    note = jax_test_notes()[note_index]
    for threshold in (0, 75, 101):
        config = {"validator": {"threshold": threshold}}
        got = ConsistencyValidator(config, APICounter(10))._structural_score(schema, note) \
            if schema.strip() else None
        want = JValidator(config, JCounter(10))._structural_score(schema, note) if schema.strip() else None
        assert (vars(got) if got else None) == (vars(want) if want else None)
        got = ConsistencyValidator(config, APICounter(10)).validate(schema, note)
        want = JValidator(config, JCounter(10)).validate(schema, note)
        assert vars(got) == vars(want)
