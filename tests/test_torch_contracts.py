"""The port's contracts against the JAX package's (CPU, no model).

``video_transformer_tpu_torch.contracts`` is a copy of the JAX package's
``contracts/``. The same note JSON goes through both: ``from_api_response``
must give equal dataclasses, and ``render_markdown``,
``KnowledgeDocument.to_markdown`` and ``AnalysisResult.to_markdown`` must
give byte-equal Markdown (or raise and warn alike) in every self-check mode,
with the concept index on and off, with and without image paths. The notes
are those of ``tests/test_contracts_models.py`` and
``tests/test_render_contracts.py``, seeded numpy notes with drifted field
types (as ``tests/test_property_fuzz.py`` makes them) and hypothesis-made
notes with malformed fields. ``normalize``, ``timefmt`` and ``validators``
are held on the same inputs.
"""

import copy
import warnings
from dataclasses import asdict

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from video_transformer_tpu.contracts import AnalysisResult as JResult
from video_transformer_tpu.contracts import normalize as j_normalize
from video_transformer_tpu.contracts import render as j_render
from video_transformer_tpu.contracts import results as j_results
from video_transformer_tpu.contracts import timefmt as j_timefmt
from video_transformer_tpu.contracts import validators as j_validators
from video_transformer_tpu_torch import contracts as port_contracts
from video_transformer_tpu_torch.contracts import AnalysisResult
from video_transformer_tpu_torch.contracts import normalize, render, results, timefmt, validators

MODES = ["lecture", "static", "interactive", "questions_only", "default"]


def base_note() -> dict:
    """The note of ``tests/test_contracts_models.py::make_doc``, as engine JSON."""
    return {
        "title": "测试视频笔记",
        "one_sentence_summary": "这是一句话核心总结。",
        "key_takeaways": ["结论一", "结论二"],
        "deep_dive": [
            {
                "chapter_title": "基础概念",
                "chapter_summary": "本章介绍基础。",
                "chapter_self_check": [{"q": "什么是基础？", "a": "基础是根基。"}],
                "sections": [
                    {
                        "topic": "梯度下降",
                        "explanation": "沿负梯度方向更新参数。在 12:34 讲解了核心。",
                        "example": {"input": "x=1", "steps": ["求梯度", "更新"], "output": "x=0.9"},
                        "code": "w -= lr * grad",
                        "connections": "反向传播，链式法则",
                        "self_check": [{"q": "为何用负梯度？", "a": "函数值下降最快。"}],
                        "common_mistakes": ["学习率过大发散"],
                        "challenge": ["先想想为什么需要学习率"],
                        "timestamp": {"start": 65, "end": 125},
                    },
                    {"topic": "动量", "explanation": ["累积历史梯度", "抑制震荡"], "timestamp": "02:05 - 03:10"},
                ],
            },
            {"topic": "扁平小节", "explanation": "没有章节外壳的旧式小节。", "start_time": 200000},
        ],
        "glossary": {"梯度": "多元函数的方向导数向量", "动量": ""},
        "visual_schemas": [{"type": "overview", "description": "总览图", "schema": "A -> B"}, "B -> C"],
    }


def section_note(section: dict) -> dict:
    """The note of ``tests/test_render_contracts.py::doc_with_section``."""
    return {
        "title": "标题",
        "one_sentence_summary": "总结。",
        "key_takeaways": ["结论"],
        "deep_dive": [
            {
                "chapter_title": "章",
                "chapter_summary": "概述。",
                "sections": [dict({"topic": "主题", "explanation": "解释。"}, **section)],
            }
        ],
        "glossary": {"术": "语"},
    }


TIMESTAMP_SECTIONS = [
    {"timestamp": {"start": 65, "end": 125}},
    {"timestamp": {"start": 65}},
    {"timestamp": {"start_time": 65, "end_time": 125}},
    {"timestamp": "01:05"},
    {"timestamp": "01:05 - 02:05"},
    {"timestamp": "1:02:03"},
    {"time_range": {"start": 30, "end": 60}},
    {"timecode": "00:45"},
    {"time": 90},
    {"start_time": 10, "end_time": 20},
    {"start": 10},
    {"end": 20},
    {"timestamp": {"start": 65000, "end": 125000}},
    {"timestamp": "65"},
    {},
    {"timestamp": "garbage"},
]


def random_value(rng, depth=0):
    """A JSON-ish value with the type drift of ``tests/test_property_fuzz.py``."""
    kind = rng.choice(["str", "int", "float", "list", "dict", "none"] if depth < 2 else ["str", "int", "none"])
    if kind == "str":
        return "".join(chr(int(c)) for c in rng.integers(0x4E00, 0x4E80, int(rng.integers(0, 30))))
    if kind == "int":
        return int(rng.integers(-1000, 100000))
    if kind == "float":
        return float(rng.normal() * 1000)
    if kind == "list":
        return [random_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    if kind == "dict":
        return {f"k{i}": random_value(rng, depth + 1) for i in range(int(rng.integers(0, 4)))}
    return None


def random_note(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def section():
        out = {"topic": random_value(rng), "explanation": random_value(rng)}
        for key in ("example", "code", "connections", "common_mistakes", "self_check", "challenge",
                    "timestamp", "start_time"):
            if rng.random() < 0.5:
                out[key] = random_value(rng)
        return out

    deep_dive = []
    for _ in range(int(rng.integers(0, 4))):
        if rng.random() < 0.5:
            deep_dive.append({
                "chapter_title": random_value(rng), "chapter_summary": random_value(rng),
                "chapter_self_check": random_value(rng),
                "sections": [section() for _ in range(int(rng.integers(0, 3)))],
            })
        else:
            deep_dive.append(section())
    return {
        "title": random_value(rng), "one_sentence_summary": random_value(rng),
        "key_takeaways": random_value(rng) or [], "deep_dive": deep_dive,
        "glossary": random_value(rng), "visual_schemas": random_value(rng),
    }


def both_results(note: dict):
    """The JAX package's and the port's AnalysisResult of one note (each
    from its own deep copy: the gate may normalize in place)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (
            JResult.from_api_response("v.npzv", copy.deepcopy(note), metadata={"duration": 5.0}),
            AnalysisResult.from_api_response("v.npzv", copy.deepcopy(note), metadata={"duration": 5.0}),
        )


def outcome(fn, *args, **kwargs):
    """(value, None) or (None, (exception type name, message)), with the
    warnings the call raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value, error = fn(*args, **kwargs), None
        except Exception as exc:  # compared, not swallowed
            value, error = None, (type(exc).__name__, str(exc))
    return value, error, [str(w.message) for w in caught]


def assert_same_render(note: dict, mode: str, include_concept_index, image_paths):
    want, got = both_results(note)
    assert asdict(got) == asdict(want)
    kwargs = dict(image_paths=image_paths, self_check_mode=mode, include_concept_index=include_concept_index)
    j_md = want.knowledge_doc.to_markdown(**kwargs)
    p_md = got.knowledge_doc.to_markdown(**kwargs)
    assert p_md.encode("utf-8") == j_md.encode("utf-8")
    assert render.render_markdown(got.knowledge_doc, **kwargs) == j_render.render_markdown(want.knowledge_doc, **kwargs)
    assert outcome(got.to_markdown, **kwargs) == outcome(want.to_markdown, **kwargs)


class TestRenderByteEqual:
    @pytest.mark.parametrize("images", [None, ["images/blueprint.png"]], ids=["no_image", "image"])
    @pytest.mark.parametrize("concept", [True, False], ids=["concept_on", "concept_off"])
    @pytest.mark.parametrize("mode", MODES)
    def test_models_note_every_mode(self, mode, concept, images):
        assert_same_render(base_note(), mode, concept, images)

    @pytest.mark.parametrize("mode", MODES + ["", "unknown_mode", " Lecture "])
    def test_concept_index_from_profile_default(self, mode):
        """``include_concept_index=None`` and modes the renderer normalizes."""
        assert_same_render(base_note(), mode, None, None)

    @pytest.mark.parametrize("section", TIMESTAMP_SECTIONS, ids=[str(i) for i in range(len(TIMESTAMP_SECTIONS))])
    def test_render_contract_timestamps(self, section):
        for mode in MODES:
            assert_same_render(section_note(section), mode, True, None)

    def test_empty_glossary_and_legacy_schema(self):
        note = section_note({})
        note["glossary"] = {}
        note.pop("visual_schemas", None)
        note["visual_schema"] = "A -> B -> C"
        for mode in MODES:
            assert_same_render(note, mode, False, ["a.png", "b.png"])

    @pytest.mark.parametrize("seed", range(24))
    def test_drifted_notes(self, seed):
        note = random_note(seed)
        for mode in MODES:
            assert_same_render(note, mode, bool(seed % 2), ["x.png"] if seed % 3 == 0 else None)


_scalar = st.one_of(
    st.none(), st.booleans(), st.integers(-10**6, 10**7), st.floats(allow_nan=False, allow_infinity=False),
    st.text(alphabet=st.sampled_from(list("梯度下降学习率ab1:- 。，`#*\n{}[]")), max_size=24),
)
_value = st.recursive(
    _scalar,
    lambda inner: st.one_of(st.lists(inner, max_size=3), st.dictionaries(
        st.sampled_from(["q", "a", "start", "end", "input", "steps", "output", "topic", "k"]), inner, max_size=3)),
    max_leaves=8,
)
_section = st.dictionaries(
    st.sampled_from(["topic", "explanation", "example", "code", "connections", "self_check", "common_mistakes",
                     "challenge", "timestamp", "time_range", "start_time", "end_time", "time"]),
    _value, max_size=6,
)
_chapter = st.fixed_dictionaries(
    {"chapter_title": _value, "sections": st.lists(_section, max_size=2)},
    optional={"chapter_summary": _value, "chapter_self_check": _value},
)
_note = st.fixed_dictionaries(
    {
        "title": _value, "one_sentence_summary": _value, "key_takeaways": _value,
        "deep_dive": st.one_of(st.lists(st.one_of(_chapter, _section), max_size=3), _value),
    },
    optional={"glossary": _value, "visual_schemas": _value, "visual_schema": _value},
)


class TestHypothesisNotes:
    @settings(max_examples=40, derandomize=True, deadline=None, database=None)
    @given(note=_note, mode=st.sampled_from(MODES), concept=st.sampled_from([True, False, None]),
           images=st.sampled_from([None, ["p.png"]]))
    def test_malformed_notes_render_alike(self, note, mode, concept, images):
        j_out = outcome(JResult.from_api_response, "v", copy.deepcopy(note))
        p_out = outcome(AnalysisResult.from_api_response, "v", copy.deepcopy(note))
        assert (p_out[1], p_out[2]) == (j_out[1], j_out[2])
        if j_out[1] is None:
            assert_same_render(note, mode, concept, images)


class TestFromApiResponse:
    def test_missing_critical_field_raises_alike(self):
        note = base_note()
        del note["deep_dive"]
        assert outcome(AnalysisResult.from_api_response, "v", note)[1:] == outcome(
            JResult.from_api_response, "v", note)[1:]

    def test_metadata_and_properties(self):
        want, got = both_results(base_note())
        assert (got.title, got.glossary, got.metadata) == (want.title, want.glossary, want.metadata)


class TestHelpersAgree:
    VALUES = [
        None, "", "  文本  ", 7, 1500, 3.5, "01:05", "1:02:03", "65", "01:05 - 02:05", "garbage", [], ["一", "二"],
        "一，二;三\n四", {"start": 65, "end": 125}, {"start_time": 1, "end_time": 2}, {"input": "a", "steps": ["s"],
        "output": "b"}, {"k": [1, {"x": 2}]}, [{"q": "问", "a": "答"}], True,
    ]

    @pytest.mark.parametrize("name", ["coerce_str_list", "normalize_field_value", "normalize_list_field"])
    def test_normalize_functions(self, name):
        for value in self.VALUES:
            assert outcome(getattr(normalize, name), copy.deepcopy(value)) == outcome(
                getattr(j_normalize, name), copy.deepcopy(value)), value

    @pytest.mark.parametrize("seed", range(6))
    def test_deep_dive_normalization(self, seed):
        deep_dive = random_note(seed)["deep_dive"] + base_note()["deep_dive"]
        got = normalize.normalize_deep_dive(copy.deepcopy(deep_dive))
        assert got == j_normalize.normalize_deep_dive(copy.deepcopy(deep_dive))
        assert normalize.as_chapters(got) == j_normalize.as_chapters(got)
        for section in deep_dive:
            if isinstance(section, dict) and "sections" not in section:
                assert normalize.normalize_section_fields(dict(section)) == j_normalize.normalize_section_fields(
                    dict(section))

    @pytest.mark.parametrize("name", ["parse_time_value", "parse_time_range"])
    def test_timefmt_parsers(self, name):
        for value in self.VALUES:
            assert outcome(getattr(timefmt, name), value) == outcome(getattr(j_timefmt, name), value), value

    def test_timefmt_display(self):
        for seconds in (0, 59.9, 61, 3599, 3600, 86399.5, 123456):
            assert timefmt.format_seconds(seconds) == j_timefmt.format_seconds(seconds)
        for section in TIMESTAMP_SECTIONS + [{"timestamp": value} for value in self.VALUES]:
            assert timefmt.section_timestamp(section) == j_timefmt.section_timestamp(section), section

    def test_validators(self):
        want, got = both_results(base_note())
        texts = ["", "# 标题\n", "# 标题\n## 章\n### 节\n", "TODO", "# t\n\n内容很多很多。\n"]
        for mode in MODES:
            texts.append(want.knowledge_doc.to_markdown(self_check_mode=mode))
        for text in texts:
            assert validators.detect_stub_output(text) == j_validators.detect_stub_output(text)
            for mode in MODES:
                assert validators.validate_markdown_structure(text, mode) == (
                    j_validators.validate_markdown_structure(text, mode))
        for mode in MODES:
            assert validators.validate_knowledge_document(got.knowledge_doc, mode) == (
                j_validators.validate_knowledge_document(want.knowledge_doc, mode))

    def test_render_helpers(self):
        for mode in MODES + ["", "weird", None]:
            assert outcome(render.normalize_mode, mode) == outcome(j_render.normalize_mode, mode)
        for text in ["在 12:34 讲解", "（00:01:05–00:02:05）正文", 5, None, ["列表"], "[缺口] 00:10:00 起"]:
            assert render.sanitize_lecture_text(text) == j_render.sanitize_lecture_text(text)
        assert render.MODES == j_render.MODES

    def test_public_names(self):
        assert port_contracts.__all__ == __import__("video_transformer_tpu.contracts", fromlist=["x"]).__all__
        for port_mod, jax_mod in ((normalize, j_normalize), (timefmt, j_timefmt), (validators, j_validators),
                                  (render, j_render), (results, j_results)):
            assert port_mod.__all__ == jax_mod.__all__


class TestResults:
    def test_process_and_batch_results(self):
        def build(mod):
            batch = mod.BatchResult(total=3, successful=2, failed=1)
            batch.add_result(mod.ProcessResult("v1", "u1", True, document_path="n.md", api_calls_used=2,
                                               processing_time=1.25, validation_score=80.0))
            batch.add_result(mod.ProcessResult("v2", "u2", False, error_message="坏", processing_time=0.5))
            batch.add_result(mod.ProcessResult("v3", "u3", True, api_calls_used=1))
            return batch

        want, got = build(j_results), build(results)
        assert got.to_dict() == want.to_dict()
        assert list(got.to_dict()) == list(want.to_dict())
        assert str(got) == str(want) and got.success_rate == want.success_rate
        assert [str(r) for r in got.results] == [str(r) for r in want.results]
