"""The port's ContentAnalyzer against the JAX package's, end to end (CPU).

A JAX ``InferenceEngine`` (CPU, one device: mesh data 1 / model 1) and a
port engine (``device="cpu"``) serve the same weights (the port's come from
``weights.from_jax_params`` of the JAX tree) at the micro geometry of
``tests/test_analyzer.py``, greedily, with ``note_dfa(512, scale=0.25)`` and
``structure_bias`` 2.5. Each case runs the JAX analyzer and the port's on
the same ``.npzv`` clip (each with its own ``temp_dir``): the
``AnalysisResult``s must be equal, metadata included once the timings are
taken out, the reports of ``generate_report`` byte-equal, and the logs
alike. The routes here: single pass; segmented through the engine, its
ragged last chunk padded by ``batch_bucket`` (at ``kv_quant: null``: with an
int8 KV cache the port leaves the pad row out of the scales, F6, shown by
``tests/test_torch_analyzer_f6.py``); resume from a manifest; budget
exhaustion with gap notes; ``analyze_videos`` over mixed lengths; the model
repair rung with a stub engine. The batcher routes are in
``tests/test_torch_analyzer_batcher.py``.
"""

import copy
import logging
import re
from dataclasses import asdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_transformer_tpu.analyzer import ContentAnalyzer as JAnalyzer
from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.models.config import DecoderConfig as JDecoder
from video_transformer_tpu.models.config import EncoderConfig as JEncoder
from video_transformer_tpu.models.config import VLMConfig as JVLM
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.utils.counter import APICounter as JCounter
from video_transformer_tpu.video.segmenter import create_manifest as j_create_manifest
from video_transformer_tpu_torch.analyzer import ContentAnalyzer
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.utils.counter import APICounter
from video_transformer_tpu_torch.video.containers import write_npzv
from video_transformer_tpu_torch.video.segmenter import create_manifest
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
TIMINGS = ("generate_seconds", "tokens_per_second", "preprocess_seconds")


def micro_config() -> JVLM:
    return JVLM(
        name="micro",
        encoder=JEncoder(hidden_dim=64, num_layers=1, num_heads=2, head_dim=32, mlp_dim=128, image_size=32,
                         patch_size=16, tubelet_t=2, num_frames=4),
        decoder=JDecoder(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2, num_kv_heads=2, head_dim=32,
                         mlp_dim=128, max_seq_len=4096),
        dtype="float32",
    )


def port_config(jc) -> VLMConfig:
    return VLMConfig(name=jc.name, encoder=EncoderConfig(**vars(jc.encoder)),
                     decoder=DecoderConfig(**vars(jc.decoder)), dtype=jc.dtype)


def make_pair(**kwargs):
    """A JAX engine and a port engine on its weights, greedy."""
    jc = micro_config()
    kwargs = {"max_new_tokens": 1400, "temperature": 0.0, "structure_bias": 2.5, **kwargs}
    mesh = build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    j_engine = JEngine(jc, mesh=mesh, dfa=j_note_dfa(512, scale=0.25), seed=0, compilation_cache_dir=None, **kwargs)
    pc = port_config(jc)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), pc, device="cpu")
    engine = InferenceEngine(pc, dfa=note_dfa(512, scale=0.25), params=params, device="cpu", **kwargs)
    return j_engine, engine


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def make_config(root: Path, **long_video):
    return {
        "system": {"temp_dir": str(root / "temp"), "log_dir": str(root / "logs"),
                   "quality_gates": {"enabled": False, "max_extra_llm_calls": 1},
                   "render": {"include_concept_index": True}},
        "analyzer": {"model": "vtx-local", "max_continuations": 0, "retry_times": 0, "long_video": {
            "enabled": True, "default_segment_seconds": 10, "overlap_seconds": 2, "min_segment_seconds": 4,
            "hard_max_api_calls": 50, "consolidate": False, **long_video}},
        "engine": {"model_preset": "tiny"},
    }


def write_clip(path: Path, seconds: float, seed: int = 0) -> Path:
    frames = np.random.default_rng(seed).integers(0, 255, (int(seconds * 4), 32, 32, 3), dtype=np.uint8)
    write_npzv(path, frames, fps=4.0)
    return path


class Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def analyzers(pair, tmp_path, config, budget=50, name="e2e"):
    """The JAX analyzer and the port's, each with its own temp_dir, counter
    and captured log; both engines' stats start from zero."""
    out = []
    for side, engine, analyzer_cls, counter_cls in (("j", pair[0], JAnalyzer, JCounter),
                                                     ("p", pair[1], ContentAnalyzer, APICounter)):
        engine.stats = type(engine.stats)()
        engine.__dict__.pop("_batcher_cache", None)
        cfg = copy.deepcopy(config)
        cfg["system"]["temp_dir"] = str(tmp_path / side / "temp")
        cfg["system"]["log_dir"] = str(tmp_path / side / "logs")
        logger = logging.getLogger(f"vtx.e2e.{name}.{side}")
        logger.setLevel(logging.INFO)
        handler = Capture()
        logger.handlers = [handler]
        logger.propagate = False
        out.append((analyzer_cls(cfg, counter_cls(max_calls=budget), logger, engine=engine), handler))
    return out


def comparable(result):
    data = asdict(result)
    data["metadata"].pop("analyze_seconds", None)
    for key in TIMINGS:
        data["metadata"].get("engine", {}).pop(key, None)
    return data


def assert_same(j_result, p_result, j_analyzer, p_analyzer, modes=("static", "lecture")):
    assert comparable(p_result) == comparable(j_result)
    for mode in modes:
        for image in (None, "images/blueprint.png"):
            want = j_analyzer.generate_report(j_result, image, self_check_mode=mode)
            got = p_analyzer.generate_report(p_result, image, self_check_mode=mode)
            assert got.encode("utf-8") == want.encode("utf-8")


def events(handler, prefix):
    return [m for m in handler.messages if m.startswith(prefix)]


def log_lines(handler):
    """The analyzer's log with its wall-clock fields taken out."""
    return [re.sub(r" elapsed_s=\S+", "", m) for m in handler.messages]


class TestAnalyzeVideo:
    def test_single_pass(self, pair, tmp_path):
        clip = write_clip(tmp_path / "short.npzv", seconds=5)
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, make_config(tmp_path), name="single")
        want, got = ja.analyze_video(clip), pa.analyze_video(clip)
        assert got.metadata["segments"] == 1 and got.knowledge_doc.deep_dive
        assert got.metadata["engine"]["frames_preprocessed"] == 4
        assert_same(want, got, ja, pa)
        assert (pa.api_counter.current_count, log_lines(ph)) == (ja.api_counter.current_count, log_lines(jh))

    def test_segmented_engine_route_padded_last_chunk(self, pair, tmp_path):
        """Three segments in chunks of two: the last chunk pads to two rows
        (``batch_bucket``). At ``kv_quant: null`` the pad row changes
        nothing, so the notes equal JAX's."""
        clip = write_clip(tmp_path / "long.npzv", seconds=30)
        config = make_config(tmp_path, continuous_batching=False, segment_batch_per_chip=2)
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, config, name="engine_route")
        want, got = ja.analyze_video(clip), pa.analyze_video(clip)
        assert got.metadata["segments"] == 3
        assert got.metadata["engine"]["generate_calls"] == 2
        assert got.metadata["engine"]["frames_preprocessed"] == 4 * 4  # the pad row's frames too
        assert not events(ph, "event=segment_serving")
        assert_same(want, got, ja, pa)
        assert log_lines(ph) == log_lines(jh)

    def test_resume_from_manifest(self, pair, tmp_path):
        """A second analyzer on the same temp_dir reloads the completed
        segments' outputs and makes no engine call."""
        clip = write_clip(tmp_path / "resume.npzv", seconds=30, seed=3)
        config = make_config(tmp_path, continuous_batching=False)
        first = analyzers(pair, tmp_path, config, name="resume1")
        for (analyzer, _) in first:
            analyzer.analyze_video(clip)
        calls = [a.api_counter.current_count for a, _ in first]
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, config, name="resume2")
        want, got = ja.analyze_video(clip), pa.analyze_video(clip)
        assert pa.api_counter.current_count == ja.api_counter.current_count == 0
        assert calls[0] == calls[1]
        assert got.metadata["engine"]["generate_calls"] == 0 and got.metadata["segments_analyzed"] == 3
        assert_same(want, got, ja, pa)

    def test_budget_exhaustion_gap_notes(self, pair, tmp_path):
        """A 3-segment manifest and a budget of 2: the third segment is
        skipped and becomes a gap note, as in the JAX analyzer."""
        clip = write_clip(tmp_path / "gaps.npzv", seconds=30, seed=4)
        config = make_config(tmp_path, hard_max_api_calls=2, duration_threshold_seconds=1)
        for root, make in ((tmp_path / "j" / "temp", j_create_manifest), (tmp_path / "p" / "temp", create_manifest)):
            make(video_id="gaps", duration=30, segment_seconds=10, overlap_seconds=2, temp_dir=root)
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, config, budget=2, name="gaps")
        want, got = ja.analyze_video(clip), pa.analyze_video(clip)
        assert got.metadata["segments_analyzed"] == 2 and len(got.metadata["segment_gaps"]) == 1
        assert any("未覆盖" in t for t in got.knowledge_doc.key_takeaways)
        assert_same(want, got, ja, pa)
        assert log_lines(ph) == log_lines(jh)


class TestAnalyzeVideos:
    def test_mixed_lengths(self, pair, tmp_path):
        clips = [write_clip(tmp_path / "s0.npzv", 4, seed=5), write_clip(tmp_path / "l.npzv", 25, seed=6),
                 write_clip(tmp_path / "s1.npzv", 6, seed=7)]
        config = make_config(tmp_path, continuous_batching=False)
        (ja, jh), (pa, ph) = analyzers(pair, tmp_path, config, name="videos")
        want, got = ja.analyze_videos(clips), pa.analyze_videos(clips)
        assert [r.metadata["segments"] for r in got] == [1, 3, 1]
        for w, g in zip(want, got):
            assert_same(w, g, ja, pa, modes=("static",))
        assert pa.api_counter.current_count == ja.api_counter.current_count


class StubRepairEngine:
    """Text-only stub for the model-assisted repair rung
    (``tests/test_analyzer.py``)."""

    def __init__(self, reply):
        self.reply = reply
        self.prompts = []

    def generate_text(self, prompts, **kwargs):
        self.prompts.append(prompts[0])
        return [self.reply]


class TestModelRepair:
    @pytest.mark.parametrize("reply,payloads", [
        ('{"title": "修复后的笔记"}', ["乱码 not json at all <<<>>>"]),
        ('{"ok": true}', ["broken one <<<", "broken two <<<"]),
        ("still not json <<<", ["hopeless payload <<<"]),
    ], ids=["rescued", "one_per_video", "dumped"])
    @pytest.mark.parametrize("budget", [10, 0])
    def test_one_model_repair_per_video(self, tmp_path, reply, payloads, budget):
        results = []
        for side, cls, counter_cls in (("j", JAnalyzer, JCounter), ("p", ContentAnalyzer, APICounter)):
            engine = StubRepairEngine(reply)
            config = {"system": {"temp_dir": str(tmp_path / side / "temp"), "log_dir": str(tmp_path / side / "logs")},
                      "analyzer": {}}
            analyzer = cls(config, counter_cls(budget), engine=engine)
            outcomes = []
            for payload in payloads:
                try:
                    outcomes.append(("ok", analyzer._parse_json(payload)))
                except ValueError as exc:  # RepairError, compared below
                    outcomes.append((type(exc).__name__, str(exc).split(" (")[0]))
            dumps = sorted(p.read_text(encoding="utf-8") for p in (tmp_path / side / "logs").glob("failed_json_*.txt"))
            results.append((outcomes, engine.prompts, dumps, analyzer.api_counter.current_count))
        assert results[1] == results[0]
