"""The analyzer and the module entry point serve a mesh of CPU ranks (gloo).

``ContentAnalyzer`` builds its engine on ``build_mesh(engine.mesh)`` (two
CPU ranks for ``{"data": 2}`` on ``device="cpu"``) and its report equals
the 1 x 1 analyzer's; ``python -m video_transformer_tpu_torch --url CLIP``
with a ``data: 2`` config saves the 1 x 1 run's note both with no launcher
(the analyzer starts the other rank) and under ``torchrun`` (``main`` joins
the world, rank 1 serves rank 0's calls). The tiny preset's random weights
close a short note greedily under the closer bias. The engine and the
batcher on a mesh are held against JAX in ``tests/test_torch_tp.py``.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu_torch import cli
from video_transformer_tpu_torch.analyzer import ContentAnalyzer
from video_transformer_tpu_torch.utils.counter import APICounter
from video_transformer_tpu_torch.video.containers import write_npzv

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """Ranks in lockstep wait on the slowest: no rank oversubscribes the
    cores that the test run shares."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _analyzer_config(root: Path, mesh: dict | None) -> dict:
    # Random tiny weights close a short note under the closer bias.
    engine = {"model_preset": "tiny", "max_new_tokens": 1400, "temperature": 0.0, "structure_bias": 2.5,
              "grammar_scale": 0.25}
    if mesh:
        engine["mesh"] = mesh
    return {"system": {"temp_dir": str(root / "temp"), "log_dir": str(root / "logs"),
                       "quality_gates": {"enabled": False, "max_extra_llm_calls": 1}},
            "analyzer": {"model": "vtx-local", "max_continuations": 0, "retry_times": 0,
                         "long_video": {"enabled": False}},
            "engine": engine}


def _clip(path: Path) -> Path:
    write_npzv(path, np.random.default_rng(0).integers(0, 255, (20, 64, 64, 3), dtype=np.uint8), fps=4.0)
    return path


def test_analyzer_builds_its_mesh_from_engine_mesh(tmp_path):
    clip = _clip(tmp_path / "talk.npzv")
    results = {}
    for name, mesh in (("one", None), ("data2", {"data": 2, "model": 1})):
        analyzer = ContentAnalyzer(_analyzer_config(tmp_path / name, mesh), APICounter(5), device="cpu")
        try:
            assert analyzer.engine.data_parallel == (2 if mesh else 1)
            result = analyzer.analyze_video(clip)
        finally:
            if analyzer.engine.mesh is not None:
                analyzer.engine.mesh.close()
        results[name] = (analyzer.generate_report(result, None, self_check_mode="lecture"),
                         result.metadata["segments"])
    assert results["data2"] == results["one"]
    assert not dist.is_initialized()


def _cli_config(root: Path, mesh: dict | None) -> Path:
    config = _analyzer_config(root, mesh)
    config["system"].update({"output_dir": str(root / "output"), "max_api_calls": 20,
                             "self_check_mode": "lecture", "note_profile": "default",
                             "note_refine": {"enabled": False}})
    config.update({"proxy": {}, "downloader": {}, "api_keys": {}, "validator": {"threshold": 0, "max_rounds": 1},
                   "image_generator": {"backend": "local", "image_size": "1K"}, "auditor": {"threshold": 0}})
    root.mkdir(parents=True, exist_ok=True)
    path = root / "config.json"
    path.write_text(json.dumps(config), encoding="utf-8")
    return path


def _notes(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted((root / "output" / "documents").glob("*.md"))}


def _argv(root: Path, clip: Path, mesh: dict | None) -> list[str]:
    return ["--url", str(clip), "--config", str(_cli_config(root, mesh)), "--device", "cpu", "--no-checkpoint"]


def _run_module(root: Path, clip: Path, launcher: list[str]) -> tuple[int, dict, str]:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    cmd = launcher + ["-m", "video_transformer_tpu_torch"] + _argv(root, clip, {"data": 2})
    done = subprocess.run(cmd, cwd=root.parent, env=env, capture_output=True, text=True, timeout=300)
    return done.returncode, _notes(root), done.stderr[-3000:]


def test_module_entry_point_serves_a_mesh_with_and_without_torchrun(tmp_path):
    clip = _clip(tmp_path / "talk.npzv")
    logger = logging.getLogger("video_transformer")  # main's setup_logging configures it
    saved = logger.handlers[:], logger.propagate, logger.level
    try:
        code = cli.main(_argv(tmp_path / "one", clip, None))  # 1 x 1, in this process
    finally:
        for handler in logger.handlers:
            if handler not in saved[0]:
                handler.close()
        logger.handlers, logger.propagate = saved[0], saved[1]
        logger.setLevel(saved[2])
    want = _notes(tmp_path / "one")
    assert want
    python = [sys.executable]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]
    for name, launcher in (("spawned", python), ("torchrun", torchrun)):
        got_code, notes, stderr = _run_module(tmp_path / name, clip, launcher)
        assert got_code == code, stderr
        assert notes == want, stderr
