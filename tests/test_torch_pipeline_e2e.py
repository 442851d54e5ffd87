"""The port's VideoPipeline against the JAX package's, end to end (CPU).

A JAX ``InferenceEngine`` and a port engine on its weights (``make_pair``
of ``tests/test_torch_analyzer_e2e.py``: the micro geometry, greedy,
``note_dfa(512, scale=0.25)``, ``structure_bias`` 2.5) drive each
package's own ``VideoPipeline`` over the same ``.npzv`` clips, each with
its own output and temp directories, a progress tracker, note refinement
and the quality gates on (``note_profile`` default). With the validator's
and the auditor's model scoring off and on (``use_engine``; the validator
then asks ``generate_text`` under ``validator_dfa``, the auditor
``generate`` on the still clip of the blueprint under ``audit_dfa``), these
are equal: the ``ProcessResult`` without its time, the saved note byte for
byte, the quality report, the log (the ``event=note_lint`` line, the
validation rounds and scores, the rewrites) with times taken out, and
``progress.json`` without its timestamps. The blueprints themselves are
held within ``test_torch_visualizer``'s pixel share; with the auditor's
model on, the JAX pipeline's image is also what the port's auditor sees
(``same_image``), so that a pixel the renderers draw differently cannot
move a greedy token. ``process_batch`` and ``process_batch_sharded`` (one
clip missing) are covered the same way.
"""

import copy
import json
import logging
import re
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_analyzer_e2e import Capture, make_pair, write_clip
from video_transformer_tpu.pipeline.pipeline import VideoPipeline as JPipeline
from video_transformer_tpu.utils.counter import APICounter as JCounter
from video_transformer_tpu.utils.progress import ProgressTracker as JTracker
from video_transformer_tpu_torch.pipeline.pipeline import VideoPipeline
from video_transformer_tpu_torch.pipeline.png import decode_png
from video_transformer_tpu_torch.utils.counter import APICounter
from video_transformer_tpu_torch.utils.progress import ProgressTracker

PIXEL_SHARE = 0.005  # as tests/test_torch_visualizer.py


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def pipeline_config(root: Path, validator_engine: bool, auditor_engine: bool) -> dict:
    return {
        "system": {"output_dir": str(root / "output"), "temp_dir": str(root / "temp"),
                   "log_dir": str(root / "logs"), "max_api_calls": 50, "self_check_mode": "lecture",
                   "note_profile": "default",
                   "note_refine": {"enabled": True, "lines_per_hour": 400, "min_lines": 20, "max_lines": 40},
                   "quality_gates": {"enabled": True, "max_extra_llm_calls": 1},
                   "render": {"include_concept_index": True}},
        "proxy": {}, "downloader": {}, "api_keys": {},
        "validator": {"threshold": 75, "max_rounds": 2, "use_engine": validator_engine},
        "image_generator": {"backend": "local", "image_size": "1K"},
        "auditor": {"threshold": 60, "use_engine": auditor_engine},
        "analyzer": {"model": "vtx-local", "max_continuations": 0, "retry_times": 0,
                     "long_video": {"enabled": False}},
        "engine": {"model_preset": "tiny"},
    }


def pipelines(pair, tmp_path, validator_engine=False, auditor_engine=False, name="e2e"):
    """The JAX pipeline and the port's, each on its engine, with its own
    directories, progress tracker and captured log."""
    out = []
    for side, engine, cls, counter, tracker in (("j", pair[0], JPipeline, JCounter, JTracker),
                                               ("p", pair[1], VideoPipeline, APICounter, ProgressTracker)):
        engine.stats = type(engine.stats)()
        root = tmp_path / side
        config = pipeline_config(root, validator_engine, auditor_engine)
        logger = logging.getLogger(f"vtx.pipe_e2e.{name}.{side}")
        logger.setLevel(logging.INFO)
        handler = Capture()
        logger.handlers, logger.propagate = [handler], False
        progress = tracker(root / "temp" / "progress.json", logger)
        kwargs = {"device": "cpu"} if side == "p" else {}
        out.append((cls(copy.deepcopy(config), logger, counter(50), progress, engine=engine, **kwargs), handler, root))
    return out


def same_image(j_pipeline, p_pipeline, monkeypatch):
    """The port's generator returns the JAX pipeline's PNG, after checking
    that its own render is within the pixel share of it."""
    from PIL import Image
    import io

    render = p_pipeline.generator.generate_blueprint

    def generate(structure):
        want = j_pipeline.generator.generate_blueprint(structure)
        got = render(structure)
        if want is not None:
            with Image.open(io.BytesIO(want)) as img:
                want_pixels = np.asarray(img.convert("RGB"))
            far = (np.abs(decode_png(got).astype(int) - want_pixels.astype(int)).max(-1) > 16).mean()
            assert far <= PIXEL_SHARE
        return want

    monkeypatch.setattr(p_pipeline.generator, "generate_blueprint", generate)


def log_lines(handler, root: Path):
    """The log with wall-clock fields and the side's directory taken out."""
    lines = []
    for message in handler.messages:
        message = re.sub(r" elapsed_s=\S+| 总耗时: \S+", "", message).replace(str(root), "ROOT")
        lines.append(message)
    return lines


def outcome(results, root: Path) -> dict:
    data = []
    for result in results:
        entry = asdict(result)
        entry.pop("processing_time")
        for key in ("document_path", "blueprint_path"):
            if entry[key]:
                entry[key] = Path(entry[key]).relative_to(root).as_posix()
        data.append(entry)
    documents = root / "output" / "documents"
    notes = {p.name: p.read_bytes() for p in sorted(documents.glob("*_knowledge_note.md"))}
    reports = {p.name: json.loads(p.read_text()) for p in sorted(documents.glob("*_quality_report.json"))}
    progress = json.loads((root / "temp" / "progress.json").read_text(encoding="utf-8"))
    progress.pop("last_updated")
    for failure in progress["failed"].values():
        failure.pop("timestamp")
    return {"results": data, "notes": notes, "reports": reports, "progress": progress}


def blueprints_close(j_root: Path, p_root: Path) -> list[str]:
    from PIL import Image

    names = []
    for want_path in sorted((j_root / "output" / "blueprints").glob("*.png")):
        got = decode_png((p_root / "output" / "blueprints" / want_path.name).read_bytes())
        with Image.open(want_path) as img:
            want = np.asarray(img.convert("RGB"))
        assert got.shape == want.shape
        assert (np.abs(got.astype(int) - want.astype(int)).max(-1) > 16).mean() <= PIXEL_SHARE
        names.append(want_path.name)
    assert names == sorted(p.name for p in (p_root / "output" / "blueprints").glob("*.png"))
    return names


@pytest.mark.parametrize("validator_engine, auditor_engine", [(False, False), (True, True), (True, False)],
                         ids=["structural", "model_scored", "validator_model"])
def test_single_video_equal(pair, tmp_path, monkeypatch, validator_engine, auditor_engine):
    clip = write_clip(tmp_path / "lecture.npzv", seconds=5)
    (jp, jh, jr), (pp, ph, pr) = pipelines(pair, tmp_path, validator_engine, auditor_engine,
                                           name=f"single{validator_engine}{auditor_engine}")
    if auditor_engine:
        same_image(jp, pp, monkeypatch)
    want = jp.process_single_video(str(clip))
    got = pp.process_single_video(str(clip))
    assert got.success and got.document_path
    assert outcome([got], pr) == outcome([want], jr)
    assert log_lines(ph, pr) == log_lines(jh, jr)
    assert any(m.startswith("event=note_lint video_id=lecture") for m in ph.messages)
    # The note, then one call a validation round and a rewrite, then the audit.
    rounds = sum(m.strip().startswith("校验得分") for m in ph.messages)
    calls = 1 + (rounds + (rounds > 1) if validator_engine else rounds > 1) + bool(auditor_engine and got.audit_score)
    assert pair[1].stats.generate_calls == pair[0].stats.generate_calls == calls
    if auditor_engine:
        assert got.blueprint_path is None or Path(got.blueprint_path).exists()
    else:
        assert blueprints_close(jr, pr) == ["lecture_mind_map.png"]
    # The second call skips through the progress tracker, as in JAX.
    again = pp.process_single_video(str(clip))
    assert again.error_message == "已处理(跳过)" == jp.process_single_video(str(clip)).error_message


def test_process_batch_equal(pair, tmp_path):
    clips = [str(write_clip(tmp_path / f"c{i}.npzv", seconds=4 + i, seed=10 + i)) for i in range(2)]
    (jp, jh, jr), (pp, ph, pr) = pipelines(pair, tmp_path, name="batch")
    want, got = jp.process_batch(clips), pp.process_batch(clips)
    assert (got.total, got.successful, got.failed) == (want.total, want.successful, want.failed) == (2, 2, 0)
    assert outcome(got.results, pr) == outcome(want.results, jr)
    assert log_lines(ph, pr) == log_lines(jh, jr)
    blueprints_close(jr, pr)


def test_process_batch_sharded_with_a_missing_clip_equal(pair, tmp_path):
    clips = [str(write_clip(tmp_path / "s0.npzv", seconds=4, seed=20)), str(tmp_path / "gone.npzv"),
             str(write_clip(tmp_path / "s1.npzv", seconds=6, seed=21))]
    (jp, jh, jr), (pp, ph, pr) = pipelines(pair, tmp_path, name="sharded")
    want, got = jp.process_batch_sharded(clips), pp.process_batch_sharded(clips)
    assert (got.total, got.successful, got.failed) == (want.total, want.successful, want.failed) == (3, 2, 1)
    assert outcome(got.results, pr) == outcome(want.results, jr)
    assert log_lines(ph, pr) == log_lines(jh, jr)
    assert outcome(got.results, pr)["progress"]["failed"] == {"gone": {"error": "视频下载失败"}}
