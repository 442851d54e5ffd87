"""The analyzer's host layers in the port, against the JAX package's (CPU).

Each part is a copy of its JAX counterpart and is held to it on the same
seeded inputs: ``repair_json`` (the cases of ``tests/test_analyzer.py`` and
seeded truncations of a note), the segment merge, offset and consolidation
gate, ``plan_segments_with_budget`` over a grid of durations and configs,
the segmenter's manifest files, ``read_frames``/``probe_clip`` on ``.npzv``
and ``.y4m`` with time windows, ``prefetch_map``, ``InferencePacer``,
``APICounter``, and the ``config.json`` copy of ``config/config.yaml``.
Then the engine API the analyzer reads (``EngineStats.as_dict``, the
preprocess counters, ``data_parallel``, the batcher's ``dfa``/``spec``) and
the analyzer's own engine construction: the ``device`` argument, a failed
restore, the constant synthetic weights, and the settings the port does not
serve yet, which raise ``NotImplementedError``.
"""

import copy
import json
import logging
import threading
import time
from dataclasses import asdict, replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__
from video_transformer_tpu.analyzer import json_repair as j_repair
from video_transformer_tpu.analyzer import segmentation as j_seg
from video_transformer_tpu.parallel.engine import EngineStats as JStats
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.utils import budget_planner as j_planner
from video_transformer_tpu.utils import config as j_config
from video_transformer_tpu.utils import counter as j_counter
from video_transformer_tpu.utils import pacer as j_pacer
from video_transformer_tpu.video import containers as j_containers
from video_transformer_tpu.video import prefetch as j_prefetch
from video_transformer_tpu.video import probe as j_probe
from video_transformer_tpu.video import segmenter as j_segmenter
from video_transformer_tpu_torch.analyzer import ContentAnalyzer, json_repair, segmentation
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig
from video_transformer_tpu_torch.parallel.engine import EngineStats, InferenceEngine
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher
from video_transformer_tpu_torch.utils import budget_planner, config, counter, pacer
from video_transformer_tpu_torch.video import containers, prefetch, probe, segmenter
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def outcome(fn, *args, **kwargs):
    """(value, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kwargs), None
    except Exception as exc:  # compared, not swallowed
        return None, (type(exc).__name__, str(exc))


# -- analyzer/json_repair.py --------------------------------------------------

REPAIR_CASES = [
    '{"a": 1}',
    '```json\n{"a": 1}\n```',
    'Sure! Here is the JSON:\n{"a": 1}',
    '{"f": "\\alpha + \\gamma"}',
    '{"code": `x = 1`}',
    '{title: "T", items: [1]}',
    '{"a": [1, 2,], }',
    '{"a": "done", "b": {"c": [1, 2',
    '{"a": "done", "b": "cut off her',
    "no json here at all",
    '{"a": "\x01ctl"}',
    "",
    "[1, 2, {",
]


def _note_text() -> str:
    return json.dumps({
        "title": "梯度下降", "one_sentence_summary": "沿负梯度更新。",
        "key_takeaways": ["学习率", "动量"],
        "deep_dive": [{"chapter_title": "章", "sections": [{"topic": "一", "explanation": "解释\\n"}]}],
        "glossary": {"梯度": "向量"}, "visual_schemas": [{"type": "overview", "schema": "A->B"}],
    }, ensure_ascii=False)


class TestJsonRepair:
    @pytest.mark.parametrize("text", REPAIR_CASES, ids=[str(i) for i in range(len(REPAIR_CASES))])
    def test_cases_of_the_jax_tests(self, text):
        assert outcome(json_repair.repair_json, text) == outcome(j_repair.repair_json, text)

    def test_seeded_truncations(self):
        text = _note_text()
        rng = np.random.default_rng(0)
        for cut in sorted(set(rng.integers(1, len(text), 60).tolist())):
            assert outcome(json_repair.repair_json, text[:cut]) == outcome(j_repair.repair_json, text[:cut]), cut

    def test_strategies_and_dump(self, tmp_path):
        for name in ("strip_wrappers", "sanitize_escapes", "fix_backtick_quotes", "fix_unquoted_keys",
                     "drop_trailing_commas", "strip_control_chars", "close_truncated", "truncate_to_last_item"):
            for text in REPAIR_CASES + [_note_text()[:77]]:
                assert getattr(json_repair, name)(text) == getattr(j_repair, name)(text), name
        path = json_repair.dump_failed_json("坏的 <<<", tmp_path / "logs")
        assert path.parent == tmp_path / "logs" and path.name.startswith("failed_json_")
        assert path.read_text(encoding="utf-8") == "坏的 <<<"
        assert issubclass(json_repair.RepairError, ValueError)
        assert json_repair.__all__ == j_repair.__all__


# -- analyzer/segmentation.py -------------------------------------------------


def seg_out(start, end, topics=None, takeaways=None, glossary=None, title="T"):
    sections = [
        {"topic": t, "explanation": f"{t} 的解释", "timestamp": {"start": start + i * 10, "end": start + i * 10 + 5}}
        for i, t in enumerate(topics or ["A"])
    ]
    return {"start": start, "end": end, "data": {
        "title": title, "one_sentence_summary": "S", "key_takeaways": takeaways or ["k"],
        "deep_dive": [{"chapter_title": "C", "chapter_summary": "", "sections": sections}],
        "glossary": glossary or {},
    }}


def random_outputs(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    words = ["梯度", "动量", "学习率", "损失", "正则", "梯 度", "Adam"]
    outs, start = [], 0.0
    for _ in range(int(rng.integers(1, 6))):
        length = float(rng.integers(5, 60))
        outs.append(seg_out(
            start, start + length,
            topics=[str(rng.choice(words)) for _ in range(int(rng.integers(1, 4)))],
            takeaways=[str(rng.choice(words)) + "!" * int(rng.integers(0, 2)) for _ in range(2)],
            glossary={str(rng.choice(words)): str(rng.choice(["定义", ""])) for _ in range(2)},
        ))
        start += length - float(rng.integers(0, 5))
    order = rng.permutation(len(outs))
    return [outs[i] for i in order]


class TestSegmentation:
    @pytest.mark.parametrize("seed", range(8))
    def test_merge_and_offset(self, seed):
        outputs = random_outputs(seed)
        assert segmentation.format_gap_note(10.0 * seed, 10.0 * seed + 30.5) == (
            j_seg.format_gap_note(10.0 * seed, 10.0 * seed + 30.5))
        gaps = [j_seg.format_gap_note(10.0 * seed, 10.0 * seed + 30)] if seed % 2 else []
        assert segmentation.merge_segment_outputs(copy.deepcopy(outputs), gaps) == j_seg.merge_segment_outputs(
            copy.deepcopy(outputs), gaps)
        for out in outputs:
            assert segmentation.offset_timestamps(copy.deepcopy(out["data"]), 37.5 * seed) == (
                j_seg.offset_timestamps(copy.deepcopy(out["data"]), 37.5 * seed))

    def test_merge_cases_of_the_jax_tests(self):
        cases = [
            ([seg_out(0, 10, takeaways=["结论一", "结论二"]), seg_out(10, 20, topics=["B"], takeaways=["结论一!", "结论三"])], []),
            ([seg_out(0, 10, glossary={"梯度": "定义1"}), seg_out(10, 20, topics=["B"], glossary={"梯 度": "定义2"})], []),
            ([seg_out(0, 20, topics=["A", "B"]), seg_out(10, 30, topics=["C"])], []),
            ([seg_out(0, 10)], ["00:00:10-00:00:20"]),
        ]
        for outputs, gaps in cases:
            assert segmentation.merge_segment_outputs(copy.deepcopy(outputs), gaps) == (
                j_seg.merge_segment_outputs(copy.deepcopy(outputs), gaps))
        assert outcome(segmentation.merge_segment_outputs, [], []) == outcome(j_seg.merge_segment_outputs, [], [])

    def test_accept_consolidation(self):
        base = {"visual_schemas": [{"type": "overview"}], "key_takeaways": ["一 的结论", "二 的结论", "相同 相 同"]}
        good = {"title": "t", "one_sentence_summary": "s", "key_takeaways": ["k"], "glossary": {},
                "deep_dive": [{"chapter_title": "一", "sections": []}, {"chapter_title": "二", "sections": []}]}
        candidates = [
            good,
            dict(good, deep_dive=[{"chapter_title": "一", "sections": []}]),
            dict(good, deep_dive=[{"chapter_title": "相同", "sections": []}, {"chapter_title": "相 同", "sections": []}]),
            "not a dict",
            dict(good, deep_dive=[{"chapter_title": "量子纠缠", "sections": []}, {"chapter_title": "罗马帝国", "sections": []}]),
            {k: v for k, v in good.items() if k != "glossary"},
            dict(good, deep_dive=[{"chapter_title": str(i), "sections": []} for i in range(8)]),
        ]
        for candidate in candidates:
            assert segmentation.accept_consolidation(copy.deepcopy(candidate), base) == (
                j_seg.accept_consolidation(copy.deepcopy(candidate), base))
        assert segmentation.__all__ == j_seg.__all__


# -- utils/budget_planner.py, utils/counter.py --------------------------------


def planner_configs():
    yield {}
    for segment, overlap, minimum, hard, conts, retry, consolidate, threshold in [
        (480, 20, 90, 50, 3, 0, True, None), (10, 2, 4, 50, 0, 0, False, None), (60, 59, 30, 8, 1, 2, "no", "600"),
        (300, 0, 90, 12, "2", None, "yes", 100), (90, 30, 60, 3, 0, 5, 0, "bad"), ("x", -5, 0, 0, -1, "z", None, None),
    ]:
        yield {"analyzer": {"max_continuations": conts, "retry_times": retry, "long_video": {
            "default_segment_seconds": segment, "overlap_seconds": overlap, "min_segment_seconds": minimum,
            "hard_max_api_calls": hard, "consolidate": consolidate, "duration_threshold_seconds": threshold}}}


class TestPlannerAndCounter:
    @pytest.mark.parametrize("index", range(7))
    def test_plan_grid(self, index):
        cfg = list(planner_configs())[index]
        for duration in (0.0, -3.0, 1.0, 5.0, 29.9, 30.0, 95.5, 480.0, 481.0, 3600.0, 7200.0, 36000.0):
            for used in (0, 3, 19, 49, 60):
                want = outcome(j_planner.plan_segments_with_budget, duration, cfg, used)
                got = outcome(budget_planner.plan_segments_with_budget, duration, cfg, used)
                want = (asdict(want[0]) if want[0] else None, want[1])
                got = (asdict(got[0]) if got[0] else None, got[1])
                assert got == want, (duration, used)

    def test_counter_semantics(self):
        def drive(mod):
            c = mod.APICounter(max_calls=3)
            log = [repr(c), c.limit]
            for service in ("local", "kimi", "TPU", "gemini", "local"):
                log.append(outcome(c.increment, service))
            log += [c.current_count, c.remaining(), c.can_call(), c.set_max_calls(10, 6), c.limit,
                    c.increase_max_calls(5), c._effective_max_calls(), repr(c)]
            c.reset()
            log.append(c.current_count)
            return log

        assert drive(counter) == drive(j_counter)
        assert issubclass(counter.APILimitExceeded, RuntimeError)
        assert sorted(counter.BUDGETED_SERVICES) == sorted(j_counter.BUDGETED_SERVICES)


# -- video/ -------------------------------------------------------------------


def clip_frames(seed: int, t: int = 24, h: int = 16, w: int = 20) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


class TestContainers:
    @pytest.mark.parametrize("suffix", [".npzv", ".y4m"])
    def test_read_and_probe_windows(self, tmp_path, suffix, monkeypatch):
        """``.y4m`` frames equal the JAX package's numpy decode, the route it
        takes when its C++ shim (``video/native_reader.py``, not ported) is
        absent; its shim's fixed-point colour conversion is within 1 of it."""
        from video_transformer_tpu.video import native_reader

        frames = clip_frames(1)
        for mod, name in ((containers, "p"), (j_containers, "j")):
            writer = mod.write_npzv if suffix == ".npzv" else mod.write_y4m
            writer(tmp_path / f"{name}{suffix}", frames, fps=4.0)
        assert (tmp_path / f"p{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
        path = tmp_path / f"p{suffix}"
        assert asdict(containers.probe_clip(path)) == asdict(j_containers.probe_clip(path))
        assert probe.probe_duration(path) == j_probe.probe_duration(path) == 6.0
        windows = [(4, 0.0, None), (8, 1.0, 3.5), (3, 5.5, 6.0), (16, 0.0, 2.0), (4, 9.0, 12.0),
                   (1, 2.25, 2.5), (4, 0.0, -1.0)]
        shim = [j_containers.read_frames(path, num, start=start, end=end) for num, start, end in windows]
        monkeypatch.setattr(native_reader, "y4m_decode_frames", lambda data, indices, pooled=False: None)
        for (num, start, end), with_shim in zip(windows, shim):
            got = containers.read_frames(path, num, start=start, end=end)
            want = j_containers.read_frames(path, num, start=start, end=end)
            assert got.dtype == np.uint8 and got.shape == (num, 16, 20, 3)
            np.testing.assert_array_equal(got, want)
            assert np.abs(got.astype(int) - with_shim.astype(int)).max() <= 1

    def test_missing_and_malformed(self, tmp_path):
        bad = tmp_path / "bad.y4m"
        bad.write_bytes(b"NOT A Y4M\n")
        for path in (tmp_path / "missing.npzv", bad):
            assert containers.probe_clip(path) == j_containers.probe_clip(path) is None
            assert probe.probe_duration(path) == j_probe.probe_duration(path) == 0.0
            assert outcome(containers.read_frames, path, 4) == outcome(j_containers.read_frames, path, 4)
        assert outcome(containers.write_npzv, tmp_path / "x.npzv", np.zeros((2, 4, 4)), 1.0) == outcome(
            j_containers.write_npzv, tmp_path / "x.npzv", np.zeros((2, 4, 4)), 1.0)
        assert containers.ffmpeg_available() == j_containers.ffmpeg_available()
        assert containers.__all__ == j_containers.__all__


class TestSegmenter:
    @pytest.mark.parametrize("duration,seconds,overlap", [(30.0, 10, 2), (6.0, 10, 2), (3600.5, 480, 20), (95.0, 90, 0)])
    def test_manifest_files(self, tmp_path, duration, seconds, overlap):
        kwargs = dict(video_id="clip", duration=duration, segment_seconds=seconds, overlap_seconds=overlap)
        want = j_segmenter.load_or_create_manifest(temp_dir=tmp_path / "j", **kwargs)
        got = segmenter.load_or_create_manifest(temp_dir=tmp_path / "p", **kwargs)

        def comparable(manifest, root):
            manifest = copy.deepcopy(manifest)
            manifest.pop("created_at")
            for s in manifest["segments"]:
                s["file_path"] = str(Path(s["file_path"]).relative_to(root))
            return manifest

        assert comparable(got, tmp_path / "p") == comparable(want, tmp_path / "j")
        for mod, root, manifest in ((segmenter, tmp_path / "p", got), (j_segmenter, tmp_path / "j", want)):
            mod.update_segment_status(manifest, 0, "processing", increment_attempts=True)
            mod.update_segment_status(manifest, 0, "completed")
            mod.update_segment_status(manifest, 99, "failed", error="x")
            mod.save_manifest(mod.get_manifest_path("clip", root), manifest)
        p_path = segmenter.get_manifest_path("clip", tmp_path / "p")
        j_path = j_segmenter.get_manifest_path("clip", tmp_path / "j")
        assert p_path.relative_to(tmp_path / "p") == j_path.relative_to(tmp_path / "j")
        reloaded = segmenter.load_or_create_manifest(temp_dir=tmp_path / "p", **kwargs)
        assert comparable(reloaded, tmp_path / "p") == comparable(j_segmenter.load_manifest(j_path), tmp_path / "j")
        assert [s["id"] for s in segmenter.pending_segments(reloaded)] == [
            s["id"] for s in j_segmenter.pending_segments(j_segmenter.load_manifest(j_path))]
        p_text = p_path.read_text(encoding="utf-8")
        j_text = j_path.read_text(encoding="utf-8")
        assert json.loads(p_text).keys() == json.loads(j_text).keys()
        assert p_text.count("\n") == j_text.count("\n")  # the same indent layout

    def test_plan_and_native_extract(self, tmp_path):
        for args in [(30.0, 10, 2), (6.0, 10, 2), (100.0, 30, 29), (0.0, 10, 2)]:
            assert [asdict(s) for s in segmenter.plan_segments(*args)] == [
                asdict(s) for s in j_segmenter.plan_segments(*args)]
        source = tmp_path / "src.npzv"
        containers.write_npzv(source, clip_frames(2), fps=4.0)
        for mod, name in ((segmenter, "p"), (j_segmenter, "j")):
            mod.extract_segment(source, 1.0, 3.5, tmp_path / f"{name}.npzv")
        np.testing.assert_array_equal(containers.read_frames(tmp_path / "p.npzv", 6),
                                      j_containers.read_frames(tmp_path / "j.npzv", 6))
        assert segmenter.snap_to_keyframe(source, 2.5) == j_segmenter.snap_to_keyframe(source, 2.5)
        assert segmenter.__all__ == j_segmenter.__all__


class TestPrefetch:
    @pytest.mark.parametrize("lookahead", [0, 1, 3])
    def test_order_and_overlap(self, lookahead):
        items = list(range(7))
        assert list(prefetch.prefetch_map(lambda x: x * x, items, lookahead)) == list(
            j_prefetch.prefetch_map(lambda x: x * x, items, lookahead))
        assert list(prefetch.prefetch_map(str, [], lookahead)) == []

    def test_producer_runs_ahead_on_another_thread(self):
        started = []

        def slow(x):
            started.append((x, threading.current_thread() is threading.main_thread()))
            time.sleep(0.01)
            return x

        it = prefetch.prefetch_map(slow, range(4))
        assert next(it) == 0
        time.sleep(0.05)
        assert {x for x, _ in started} >= {0, 1}
        assert not any(main for _, main in started)
        assert list(it) == [1, 2, 3]

    def test_errors_surface_in_order(self):
        def fn(x):
            if x == 2:
                raise KeyError(x)
            return x

        got, want = [], []
        for mod, out in ((prefetch, got), (j_prefetch, want)):
            try:
                for value in mod.prefetch_map(fn, range(5)):
                    out.append(value)
            except KeyError as exc:
                out.append(("raised", exc.args))
        assert got == want == [0, 1, ("raised", (2,))]


class TestPacer:
    def _drive(self, mod, errors, max_retries=3, max_total_wait=600.0):
        sleeps, calls = [], []

        def fn():
            calls.append(1)
            if len(calls) <= len(errors):
                raise errors[len(calls) - 1]
            return "ok"

        p = mod.InferencePacer(max_retries=max_retries, max_total_wait=max_total_wait,
                               sleep=sleeps.append, clock=lambda: 0.0)
        result = outcome(p.call_with_retry, fn, log_context={"video": "v"})
        return result, len(calls), len(sleeps)

    @pytest.mark.parametrize("case", ["rate_limit", "message_429", "exhausted", "retry_after", "other", "too_many",
                                      "budget"])
    def test_retry_semantics(self, case):
        def errs(mod):
            return {
                "rate_limit": [mod.RateLimitError("slow down", retry_after=1.0)],
                "message_429": [RuntimeError("HTTP 429 Too Many Requests")],
                "exhausted": [RuntimeError("RESOURCE_EXHAUSTED retryDelay: 2")],
                "retry_after": [RuntimeError("429 retry-after: 3.5"), RuntimeError("429")],
                "other": [ValueError("bad input")],
                "too_many": [mod.RateLimitError("x", 1.0)] * 5,
                "budget": [mod.RateLimitError("x", 500.0)] * 3,
            }[case]

        assert self._drive(pacer, errs(pacer)) == self._drive(j_pacer, errs(j_pacer))
        for got, want in zip(errs(pacer), errs(j_pacer)):
            assert pacer.InferencePacer.is_rate_limit_error(got) == j_pacer.InferencePacer.is_rate_limit_error(want)
            assert pacer.InferencePacer.extract_retry_delay(got) == j_pacer.InferencePacer.extract_retry_delay(want)

    def test_min_interval_pacing(self):
        for mod in (pacer, j_pacer):
            now, sleeps = [10.0], []
            p = mod.InferencePacer(min_interval=2.0, files_op_interval=1.0, sleep=lambda s: sleeps.append(s),
                                   clock=lambda: now[0])
            p.wait_before_call()
            p.wait_before_call()
            now[0] = 20.0
            p.wait_for_files_op()
            assert sleeps == [2.0]

    def test_device_errors_are_never_retried(self):
        """A CUDA out-of-memory message can hold "429"; the JAX copy would
        wait and retry it, the port raises at once."""
        oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 429.00 MiB")
        fault = RuntimeError("CUDA error: an illegal memory access was encountered (429)")
        for exc in (oom, fault):
            result, calls, sleeps = self._drive(pacer, [exc])
            assert result[1][0] == type(exc).__name__ and (calls, sleeps) == (1, 0)
            assert j_pacer.InferencePacer.is_rate_limit_error(exc)  # the JAX copy's reading
            assert not pacer.InferencePacer.is_rate_limit_error(exc)


# -- utils/config.py ----------------------------------------------------------


class TestConfigPin:
    def test_json_equals_the_yaml(self):
        yaml_data = yaml.safe_load((REPO / "config" / "config.yaml").read_text(encoding="utf-8"))
        json_data = json.loads(config.DEFAULT_CONFIG_PATH.read_text(encoding="utf-8"))
        assert json_data == yaml_data
        assert config.DEFAULT_CONFIG_PATH == REPO / "video_transformer_tpu_torch" / "utils" / "config.json"

    def test_load_config_equals_jax(self, monkeypatch):
        for name in ("VT_GEMINI_API_KEY", "VT_KIMI_API_KEY", "VT_NANO_BANANA_API_KEY"):
            monkeypatch.delenv(name, raising=False)
        assert config.load_config() == j_config.load_config()
        monkeypatch.setenv("VT_KIMI_API_KEY", "k-123")
        got = config.load_config()
        assert got == j_config.load_config() and got["api_keys"]["kimi"] == "k-123"

    def test_defaults_and_errors_equal_jax(self, tmp_path):
        sparse = {"system": {"note_profile": "PDF"}, "proxy": {}, "downloader": {}, "validator": {},
                  "image_generator": {}, "engine": {"mesh": {"model": 2}}}
        (tmp_path / "c.json").write_text(json.dumps(sparse), encoding="utf-8")
        (tmp_path / "c.yaml").write_text(yaml.safe_dump(sparse), encoding="utf-8")
        assert config.load_config(tmp_path / "c.json") == j_config.load_config(tmp_path / "c.yaml")
        for bad in ([1, 2], {"system": {}}, {**sparse, "system": "x"}):
            (tmp_path / "b.json").write_text(json.dumps(bad), encoding="utf-8")
            (tmp_path / "b.yaml").write_text(yaml.safe_dump(bad), encoding="utf-8")
            assert outcome(config.load_config, tmp_path / "b.json") == outcome(j_config.load_config, tmp_path / "b.yaml")
        assert outcome(config.load_config, tmp_path / "none.json")[1][0] == "FileNotFoundError"
        assert config.REQUIRED_SECTIONS == j_config.REQUIRED_SECTIONS


# -- the engine API the analyzer reads (parallel/engine.py, serving.py) -------


def j_micro():
    jc = __graft_entry__._tiny_config()
    return replace(jc, decoder=replace(jc.decoder, max_seq_len=2048))


def port_config(jc) -> VLMConfig:
    return VLMConfig(name=jc.name, encoder=EncoderConfig(**vars(jc.encoder)),
                     decoder=DecoderConfig(**vars(jc.decoder)), dtype=jc.dtype)


@pytest.fixture(scope="module")
def pair():
    jc = j_micro()
    kwargs = dict(max_new_tokens=6, temperature=0.0, structure_bias=0.0)
    mesh = build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    j_engine = JEngine(jc, mesh=mesh, seed=1, compilation_cache_dir=None, **kwargs)
    pc = port_config(jc)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), pc, device="cpu")
    return j_engine, InferenceEngine(pc, params=params, device="cpu", **kwargs)


class TestEngineRepairs:
    TIMINGS = ("generate_seconds", "tokens_per_second", "preprocess_seconds")

    def test_as_dict_has_the_jax_keys_and_roundings(self):
        values = dict(generate_calls=3, tokens_generated=1234, generate_seconds=2.71828, prefill_tokens=640,
                      frames_preprocessed=16, preprocess_seconds=0.123456, session_resumes=1, decode_steps=99)
        got = EngineStats(prefill_seconds=9.0, **values).as_dict()
        want = JStats(**values).as_dict()
        assert list(got) == list(want) and got == want
        assert "prefill_seconds" not in got
        assert EngineStats().as_dict() == JStats().as_dict()

    def test_generate_counts_frames_as_jax(self, pair):
        j_engine, engine = pair
        frames = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
        for e in pair:
            e.stats = type(e.stats)()
        assert engine.generate(frames, ["分析", "视频"]) == j_engine.generate(frames, ["分析", "视频"])
        engine.preprocess(frames[:1])
        j_engine.preprocess(frames[:1])
        got, want = engine.stats.as_dict(), j_engine.stats.as_dict()
        assert got["frames_preprocessed"] == 12
        for key in self.TIMINGS:
            got.pop(key), want.pop(key)
        assert got == want
        assert engine.stats.preprocess_seconds > 0

    def test_data_parallel_is_one(self, pair):
        assert pair[1].data_parallel == 1 == pair[0].data_parallel

    def test_batcher_holds_the_grammar_and_no_draft(self, pair):
        from video_transformer_tpu_torch.analyzer.schema import note_dfa

        engine = pair[1]
        engine.dfa = note_dfa(512, scale=0.2)
        try:
            batcher = ContinuousBatcher(engine, slots=2, prompt_len=128)
            assert batcher.dfa is engine.dfa and batcher.spec is False
            analyzer = ContentAnalyzer({}, counter.APICounter(5), engine=engine, device="cpu")
            assert analyzer._get_batcher(2, 128) is analyzer._get_batcher(2, 128)
            first = engine._batcher_cache
            engine.dfa = note_dfa(512, scale=0.25)  # a new grammar rebuilds it, as in JAX
            assert analyzer._get_batcher(2, 128) is not first
            assert analyzer._get_batcher(3, 128).slots == 3
        finally:
            engine.dfa = None
            engine.__dict__.pop("_batcher_cache", None)

    def test_batcher_chunks_count_as_generate_calls(self, pair):
        from video_transformer_tpu_torch.parallel.serving import Request

        engine = pair[1]
        engine.stats = EngineStats()
        batcher = ContinuousBatcher(engine, slots=1, prompt_len=128)
        clip = np.zeros((4, 32, 32, 3), np.uint8)
        for i in range(2):
            batcher.submit(Request(i, clip, "提示"))
        assert len(batcher.run()) == 2
        assert engine.stats.generate_calls >= 1
        assert engine.stats.frames_preprocessed == 8


# -- analyzer/content_analyzer.py: the engine property ------------------------


def analyzer_config(tmp_path, **engine):
    return {"system": {"temp_dir": str(tmp_path / "temp"), "log_dir": str(tmp_path / "logs")}, "analyzer": {},
            "engine": {"model_preset": "tiny", "max_new_tokens": 8, "temperature": 0.0, **engine}}


class Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def capture_logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    handler = Capture()
    logger.addHandler(handler)
    return logger, handler


class TestAnalyzerEngine:
    @pytest.mark.parametrize("engine_cfg,item", [
        ({"mesh": {"data": 1, "model": 2}}, "item 9"),
        ({"mesh": {"data": 4, "model": 1}}, "item 9"),
        ({"draft": {"model_preset": "tiny", "checkpoint_dir": None}}, "item 7"),
    ], ids=["mesh_model", "mesh_data", "draft"])
    def test_unported_settings_raise(self, tmp_path, engine_cfg, item):
        analyzer = ContentAnalyzer(analyzer_config(tmp_path, **engine_cfg), counter.APICounter(5), device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            analyzer.engine
        assert analyzer._engine is None

    def test_device_defaults_to_cuda(self, tmp_path):
        analyzer = ContentAnalyzer(analyzer_config(tmp_path), counter.APICounter(5))
        assert analyzer.device == "cuda"

    def test_shipped_mesh_and_null_draft_build_on_the_cpu(self, tmp_path):
        shipped = config.load_config()["engine"]
        cfg = analyzer_config(tmp_path, mesh=shipped["mesh"], draft=shipped["draft"])
        engine = ContentAnalyzer(cfg, counter.APICounter(5), device="cpu").engine
        assert engine.device.type == "cpu" and engine.data_parallel == 1
        assert engine.dfa is not None and engine.config.encoder.num_frames == 4

    def test_orbax_checkpoint_keeps_random_weights_and_logs(self, tmp_path):
        logger, handler = capture_logger("vtx.test.restore_failed")
        cfg = analyzer_config(tmp_path, checkpoint_dir=str(REPO / "data" / "checkpoints" / "tiny-zh-grounded-r5mix"))
        engine = ContentAnalyzer(cfg, counter.APICounter(5), logger, device="cpu").engine
        assert isinstance(engine, InferenceEngine)
        assert any(m.startswith("event=engine_restore_failed") for m in handler.messages), handler.messages
        assert not any(m.startswith("event=engine_restored") for m in handler.messages)

    def test_converted_npz_restores_with_bpe_and_int8(self, tmp_path):
        logger, handler = capture_logger("vtx.test.restored")
        npz = REPO / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz"
        cfg = analyzer_config(
            tmp_path, checkpoint_dir=str(npz), param_dtype="bfloat16", quantize="int8", kv_quant="int8",
            tokenizer={"type": "bpe", "path": str(REPO / "data" / "tokenizers" / "bpe-zh-2048.json")},
            max_forced_run=2, grammar_scale=0.5,
        )
        engine = ContentAnalyzer(cfg, counter.APICounter(5), logger, device="cpu").engine
        assert f"event=engine_restored checkpoint={npz}" in handler.messages
        assert engine.config.decoder.vocab_size == engine.tokenizer.vocab_size == 2048
        assert engine.kv_quant == "int8" and engine.quantize == "int8" and engine.max_forced_run == 2
        assert engine.byte_vocab == 512

    def test_synthetic_weights_are_constant_bf16(self, tmp_path):
        logger, handler = capture_logger("vtx.test.synthetic")
        cfg = analyzer_config(tmp_path, synthetic_weights=True)
        engine = ContentAnalyzer(cfg, counter.APICounter(5), logger, device="cpu").engine
        assert "event=engine_synthetic_weights preset=tiny" in handler.messages
        params = dict(engine.model.named_parameters())
        assert all(p.dtype == torch.bfloat16 for p in params.values())
        assert all(bool((p == torch.tensor(0.01, dtype=torch.bfloat16)).all()) for p in params.values())
        buffers = dict(engine.model.named_buffers())
        assert buffers["decoder.rope_cos"].dtype == torch.float32 and float(buffers["decoder.rope_cos"][0, 0]) == 1.0
