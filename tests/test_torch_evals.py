"""The content and real-footage evals and the tracer against the JAX package's (CPU).

- ``train/eval_content.py`` and ``train/eval_real.py``: the JAX tests'
  cases rerun against the port (``rerun``; the imports inside test bodies
  are rebound to the port's modules), then both engines score the trained
  tiny checkpoint greedily (the JAX engine on the orbax original, the port
  on the committed ``.npz``): the per-topic and per-clip results are equal,
  and in float32 every generated and judged text is equal exactly. In
  bfloat16 a note may leave JAX's only after a near tie (``TIE_TOL``, the
  rule of ``tests/test_torch_grounding.py``).
- A device error raised inside the validator's model judge leaves
  ``run_content_eval`` (the JAX eval scores it 0), while a render failure
  still scores the rubric 0 as in JAX.
- ``utils/tracing.py``: the JAX ``TestTracer`` cases rerun against the
  port; the port's engine logs the JAX engine's spans (names, fields and
  values) on the same calls; ``device_trace`` writes a trace that names the
  spans.
"""

import json
import logging
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_eval_content as j_content_tests
import tests.test_eval_real as j_real_tests
import tests.test_observability as j_obs_tests
from tests.test_torch_engine_api import frames, j_config, port_config
from tests.test_torch_grounding import (
    TIE_TOL,
    TINY_NPZ,
    TINY_ORBAX,
    jax_engine,
    jax_tie_margin,
    port_engine,
    recorder,
)
from tests.test_torch_pipeline_pure import port_modules, rerun
from video_transformer_tpu.analyzer import schema as j_schema
from video_transformer_tpu.models.lm import init_kv_cache as j_init_kv_cache
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.train import eval_content as j_eval_content
from video_transformer_tpu.train import eval_real as j_eval_real
from video_transformer_tpu_torch.analyzer import schema
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.train import eval_content, eval_real
from video_transformer_tpu_torch.train import grounded as pg
from video_transformer_tpu_torch.utils import tracing
from video_transformer_tpu_torch.utils.tracing import Tracer, device_trace
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)


def cases(module, owner=None):
    owner = owner or module
    return [pytest.param(owner, name, id=name) for name in vars(owner) if name.startswith("test_")]


# -- the JAX tests' cases ----------------------------------------------------------------

CONTENT_NAMES = {"content_checks": eval_content.content_checks, "_contamination": eval_content._contamination,
                 "TOPIC_BANK": pg.TOPIC_BANK, "grounded_note": pg.grounded_note}
PORT_CONTENT = dict(train__eval_content=eval_content, train__grounded=pg)


@pytest.mark.parametrize("owner, name",
                         cases(j_content_tests) + cases(j_content_tests, j_content_tests.TestAttrGrounding))
def test_eval_content_cases_hold_the_port(owner, name):
    fn = getattr(owner, name)
    if not isinstance(fn, types.FunctionType):
        return
    args = () if owner is j_content_tests else (owner(),)
    with port_modules(**PORT_CONTENT):
        rerun(j_content_tests, CONTENT_NAMES, fn, *args)


REAL_NAMES = {"score_note": eval_real.score_note, "stage_out_of_bank": eval_real.stage_out_of_bank,
              "run_real_eval": eval_real.run_real_eval}


@pytest.mark.parametrize("owner, name", cases(j_real_tests, j_real_tests.TestScoring)
                         + cases(j_real_tests, j_real_tests.TestStaging))
def test_eval_real_cases_hold_the_port(owner, name, tmp_path):
    fn = getattr(owner, name)
    args = (owner(), tmp_path) if "tmp_path" in fn.__code__.co_varnames[: fn.__code__.co_argcount] else (owner(),)
    rerun(j_real_tests, REAL_NAMES, fn, *args)


def test_rerun_reaches_the_port_evals():
    """The rebinding is real: a port function that raises fails the case."""
    def broken(*args, **kwargs):
        raise AssertionError("the port's stated_attrs ran")

    fake = types.ModuleType("eval_content")
    fake.stated_attrs = broken
    with port_modules(train__eval_content=fake), pytest.raises(AssertionError, match="port's stated_attrs"):
        rerun(j_content_tests, CONTENT_NAMES, j_content_tests.TestAttrGrounding.test_unstated_and_ambiguous_parse_none,
              j_content_tests.TestAttrGrounding())


@pytest.mark.parametrize("seed", [0, 3])
def test_stated_attrs_and_content_checks_are_equal(seed):
    rng = np.random.default_rng(seed)
    for idx in range(len(pg.TOPIC_BANK)):
        attrs = (idx % 3, 1 + idx % 5) if idx % 2 else None
        note = pg.grounded_note(pg.TOPIC_BANK[idx], rng, attrs)
        other = pg.TOPIC_BANK[(idx + 3) % len(pg.TOPIC_BANK)]
        for topic in (pg.TOPIC_BANK[idx], other):
            assert eval_content.content_checks(note, topic) == j_eval_content.content_checks(note, topic)
        assert eval_content.stated_attrs(note) == j_eval_content.stated_attrs(note)
        text = json.dumps(note, ensure_ascii=False)
        assert eval_real.score_note(text, {"topic": other.name, "must_mention": list(other.terms)}) == \
            j_eval_real.score_note(text, {"topic": other.name, "must_mention": list(other.terms)})


# -- both engines on the trained tiny checkpoint ------------------------------------------


def text_recorder(engine) -> list:
    """Keep each ``generate_text`` call's prompts, grammar, texts and ids
    (the validator's judge calls it)."""
    calls = []
    generate_text = engine.generate_text

    def wrapped(prompts, dfa=None, **kwargs):
        texts, ids = generate_text(prompts, dfa=dfa, return_tokens=True, **kwargs)
        calls.append((prompts, dfa, texts, ids))
        return texts

    engine.generate_text = wrapped
    return calls


def jax_text_tie_margin(j_engine, prompt: str, prefix: list[int], dfa) -> tuple[float, float]:
    """``jax_tie_margin`` for a text-only call: (top-2 gap of the grammar-
    allowed logits, max|logit|) of the JAX model after ``prefix``."""
    prompt_len = j_engine._prompt_bucket([prompt], with_video=False)
    _, total, tokens, lengths, states = j_engine._assemble_inputs(
        [prompt], [prefix], 1, prompt_len, dfa, with_video=False
    )
    cfg = j_engine.config
    cache = j_init_kv_cache(cfg.decoder, 1, total + 128, jnp.dtype(cfg.dtype))
    prefill = jax.jit(lambda *a: j_engine.model.apply(*a, method=JVideoLM.prefill_text)[0])
    logits = prefill(j_engine.params, jnp.asarray(tokens), cache, jnp.asarray(lengths))
    masked = np.asarray(dfa.constrain(logits, jnp.asarray(states), j_engine._table_for(dfa)))[0]
    top2 = np.sort(masked)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(np.asarray(logits)[0]).max())


def first_departure(a: list[int], b: list[int]) -> int:
    return next(i for i, (x, y) in enumerate(zip(a + [-1], b + [-1])) if x != y)


def check_notes(j_engine, j_calls, calls, exact: bool) -> list[bool]:
    """Each note's ids against JAX's: equal (``exact``), or leaving JAX's
    only after a near tie. Returns, row by row, whether the ids are equal."""
    same = []
    for (clips, prompts, j_texts, j_ids), (_, _, texts, ids) in zip(j_calls, calls, strict=True):
        if exact:
            assert texts == j_texts
        for row, (a, b) in enumerate(zip(ids, j_ids)):
            same.append(a == b)
            if a != b:
                first = first_departure(a, b)
                gap, scale = jax_tie_margin(j_engine, clips[row], prompts[row], b[:first])
                assert gap < TIE_TOL * scale, f"row {row} leaves JAX's text at token {first} with a gap of {gap}"
    return same


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_content_eval_scores_as_jax_on_the_trained_checkpoint(f32):
    """Two topics (0 and 24 of the bank), batch 2, greedy, with the model
    judge on. In float32 every note, judgment and row equals JAX's. In
    bfloat16 a row equals JAX's wherever its note and its judgment do, and
    each text that leaves JAX's does so at a near tie."""
    j_engine, engine = jax_engine(TINY_ORBAX, "tiny", f32), port_engine(TINY_NPZ, "tiny", f32)
    j_calls, calls = recorder(j_engine), recorder(engine)
    j_judged, judged = text_recorder(j_engine), text_recorder(engine)
    topic_ids = [0, 24]
    want = j_eval_content.run_content_eval(j_engine, topic_ids, 2)
    got = eval_content.run_content_eval(engine, topic_ids, 2)
    assert list(got["per_topic"]) == list(want["per_topic"])
    assert len(judged) == sum(r["parse"] for r in got["per_topic"].values()) > 0
    for row in got["per_topic"].values():
        assert all(isinstance(v, bool) for v in row["checks"].values())
        assert "error" not in row["rubric"]
    same_note = check_notes(j_engine, j_calls, calls, exact=f32)
    if f32:
        assert got == {**want, "wall_seconds": got["wall_seconds"]}
        assert [c[2:] for c in judged] == [c[2:] for c in j_judged]
        return
    port_judge, jax_judge = iter(judged), iter(j_judged)  # one judgment per parsed note, in topic order
    for (name, row), equal in zip(got["per_topic"].items(), same_note, strict=True):
        want_row = want["per_topic"][name]
        judgment = next(port_judge) if row["parse"] else None
        j_judgment = next(jax_judge) if want_row["parse"] else None
        if not equal:
            continue  # a note that left JAX's at a near tie (checked above)
        assert {k: v for k, v in row.items() if k != "rubric"} == {k: v for k, v in want_row.items() if k != "rubric"}
        (prompt,), dfa, _, (ids,) = judgment
        (j_prompt,), j_dfa, _, (j_ids,) = j_judgment
        assert prompt == j_prompt
        if ids == j_ids:
            assert row["rubric"] == want_row["rubric"]
        else:
            first = first_departure(ids, j_ids)
            gap, scale = jax_text_tie_margin(j_engine, prompt, j_ids[:first], j_dfa)
            assert gap < TIE_TOL * scale, f"{name}: the judgment leaves JAX's at token {first} with a gap of {gap}"


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_real_eval_scores_as_jax_on_the_trained_checkpoint(f32, tmp_path):
    """Three out-of-bank clips (seed 36: topics of the frozen range), batch
    2, greedy."""
    j_engine, engine = jax_engine(TINY_ORBAX, "tiny", f32), port_engine(TINY_NPZ, "tiny", f32)
    j_calls, calls = recorder(j_engine), recorder(engine)
    cfg = engine.config.encoder
    eval_real.stage_out_of_bank(tmp_path, 3, cfg.num_frames, cfg.image_size, seed=36)
    want = j_eval_real.run_real_eval(j_engine, tmp_path, batch=2)
    got = eval_real.run_real_eval(engine, tmp_path, batch=2)
    assert got["per_clip"] == want["per_clip"]
    assert {k: v for k, v in got.items() if k != "wall_seconds"} == \
        {k: v for k, v in want.items() if k != "wall_seconds"}
    assert got["parse_rate"] == 1.0
    check_notes(j_engine, j_calls, calls, exact=f32)


def test_eval_mains_print_one_json_line(tmp_path, capsys):
    common = ["--preset", "tiny", "--checkpoint", str(TINY_NPZ), "--tokenizer",
              "data/tokenizers/bpe-zh-2048.json", "--batch", "1", "--temperature", "0", "--device", "cpu",
              "--max-new-tokens", "8"]
    rc = eval_content.main(common + ["--topics", "1", "--no-model-judge", "--attrs", "1"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and report["parse_rate"] == 0.0  # 8 tokens end no note
    assert set(report) >= {"content_coverage", "rubric_mean", "per_topic", "attr_grounding", "checkpoint",
                           "prompt_profile"}
    rc = eval_real.main(common + ["--eval-dir", str(tmp_path), "--stage-out-of-bank", "2"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["clips"] == 2 and sorted(report["per_clip"]) == ["oob_000", "oob_001"]


# -- errors inside the rubric ---------------------------------------------------------------


class NoteEngine:
    """A stand-in engine: ``generate`` returns teacher notes, and the
    validator's judge (``generate_text``) calls ``judge``."""

    def __init__(self, judge):
        from video_transformer_tpu_torch.models.config import get_preset

        self.config = get_preset("tiny")
        self.byte_vocab = 512
        self.judge = judge

    def wrap_grammar(self, dfa):
        return dfa

    def generate(self, frames, prompts):
        rng = np.random.default_rng(0)
        return [json.dumps(pg.grounded_note(pg.TOPIC_BANK[0], rng), ensure_ascii=False) for _ in prompts]

    def generate_text(self, prompts, dfa=None):
        return self.judge(prompts)


def test_device_error_in_the_judge_leaves_the_eval():
    """A CUDA error inside ``validator.validate`` propagates; the JAX eval
    catches every exception there and scores 0 (ROADMAP F7's rule)."""
    def lost_device(prompts):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        eval_content.run_content_eval(NoteEngine(lost_device), [0], 1)
    def cuda_error(prompts):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="CUDA error"):
        eval_content.run_content_eval(NoteEngine(cuda_error), [0], 1)
    report = j_eval_content.run_content_eval(NoteEngine(lost_device), [0], 1)
    assert report["per_topic"][pg.TOPIC_BANK[0].name]["rubric"]["total"] == 0.0


@pytest.mark.parametrize("fault", ["render", "judge"])
def test_render_and_judge_errors_still_score_zero_as_jax(monkeypatch, fault):
    """A contract or render failure, or a judge that writes no JSON, scores
    the rubric 0 in both evals with the same error text."""
    from video_transformer_tpu.contracts.knowledge import AnalysisResult as JResult
    from video_transformer_tpu_torch.contracts.knowledge import AnalysisResult

    judge = (lambda prompts: ["not json"]) if fault == "judge" else (lambda prompts: ['{"accuracy": 30}'])
    if fault == "render":
        def broken(*args, **kwargs):
            raise ValueError("contract gate: empty chapter")

        monkeypatch.setattr(AnalysisResult, "from_api_response", broken)
        monkeypatch.setattr(JResult, "from_api_response", broken)
    got = eval_content.run_content_eval(NoteEngine(judge), [0, 5], 2)
    want = j_eval_content.run_content_eval(NoteEngine(judge), [0, 5], 2)
    assert got["per_topic"] == want["per_topic"]
    rubric = got["per_topic"][pg.TOPIC_BANK[0].name]["rubric"]
    assert rubric["total"] == 0.0 and not rubric["passed"]
    assert ("error" in rubric) == (fault == "render")


# -- the tracer ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in vars(j_obs_tests.TestTracer) if n.startswith("test_")])
def test_tracer_cases_hold_the_port(name, caplog):
    fn = getattr(j_obs_tests.TestTracer, name)
    args = (j_obs_tests.TestTracer(), caplog) if "caplog" in fn.__code__.co_varnames else (j_obs_tests.TestTracer(),)
    rerun(j_obs_tests, {"Tracer": Tracer}, fn, *args)


SPAN_RE = re.compile(r"^event=span name=(\S+) elapsed_ms=[\d.]+(.*)$")


def spans(records) -> list[tuple[str, dict]]:
    out = []
    for record in records:
        match = SPAN_RE.match(record.getMessage())
        if match:
            fields = dict(kv.split("=", 1) for kv in match.group(2).split())
            out.append((match.group(1), fields))
    return out


def test_engine_spans_are_the_jax_engines(caplog):
    """``generate`` (with its ``engine.preprocess``), ``generate_text`` and
    ``continue_session`` on the same calls: the same span lines with the
    same fields, in the same order; on the CPU no NVTX call."""
    jc = j_config()
    kwargs = {"max_new_tokens": 24, "temperature": 0.0, "structure_bias": 5.0}
    j_engine = JEngine(jc, dfa=j_schema.note_dfa(512, scale=0.2), seed=3, compilation_cache_dir=None,
                       mesh=build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1]), **kwargs)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), port_config(jc), device="cpu")
    pair = (j_engine, InferenceEngine(port_config(jc), dfa=schema.note_dfa(512, scale=0.2), params=params,
                                      device="cpu", **kwargs))
    clip = frames(2, seed=1)
    logged = []
    for engine in pair:
        tracer = tracing.tracer if engine is pair[1] else None
        if tracer:
            tracer.reset()
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger="video_transformer"):
            engine.generate(clip, ["分析视频"] * 2, prompt_len=16)
            engine.generate_text(["分析视频"], prompt_len=16, batch_bucket=2)
            _, _, session = engine.generate_text(["分析视频"], prompt_len=16, return_status=True,
                                                 return_session=True, session_rounds=2)
            engine.continue_session(session)
        logged.append(spans(caplog.records))
    assert logged[1] == logged[0]
    assert [name for name, _ in logged[1]] == ["engine.preprocess", "engine.generate", "engine.generate_text",
                                               "engine.generate_text", "engine.continue_session"]
    assert logged[1][0][1] == {"frames": "8"} and logged[1][2][1] == {"batch": "2"}
    summary = tracing.tracer.summary()
    assert {k: v["count"] for k, v in summary.items()} == {
        "engine.preprocess": 1, "engine.generate": 1, "engine.generate_text": 2, "engine.continue_session": 1}


def test_spans_push_nvtx_ranges_only_when_asked(monkeypatch):
    pushed = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: pushed.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: pushed.append(("pop",)))
    tracer = Tracer()
    with tracer.span("host"):
        pass
    assert pushed == []
    with pytest.raises(ValueError), tracer.span("device", nvtx=True):
        raise ValueError("x")
    assert pushed == [("push", "device"), ("pop",)]
    engine = port_engine(TINY_NPZ, "tiny", f32=True, max_new_tokens=2)
    assert engine._nvtx is False
    engine.generate(frames(1), ["分析视频"])
    assert pushed == [("push", "device"), ("pop",)]  # a CPU engine makes no NVTX call


def test_device_trace_writes_a_trace_naming_the_spans(tmp_path):
    engine = port_engine(TINY_NPZ, "tiny", f32=True, max_new_tokens=4)
    with device_trace(tmp_path / "trace") as prof:
        engine.generate(frames(1), ["分析视频"])
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text(encoding="utf-8"))
    names = {event.get("name") for event in trace["traceEvents"]}
    assert {"engine.preprocess", "engine.generate"} <= names
