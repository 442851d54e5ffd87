"""The port's CLI against the JAX package's (CPU).

Both ``main([...])`` run in-process on one config: written as YAML for the
JAX CLI and as JSON for the port's (``--config``). Each CLI's
``VideoPipeline`` gets its package's micro engine (``make_pair`` of
``tests/test_torch_analyzer_e2e.py``, greedy; the port's on ``--device
cpu``), injected by wrapping the class the CLI builds. With ``--url``,
``--batch``, ``--batch --sharded`` and ``--no-checkpoint`` the exit codes,
the standard output (times and the side's directory taken out), the saved
notes and ``progress.json`` (without timestamps) are equal. A device error
raised inside the pipeline leaves ``main`` with its traceback, and
``python -m video_transformer_tpu_torch`` then exits 1.
"""

import copy
import functools
import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from tests.test_torch_analyzer_e2e import make_pair, write_clip
from tests.test_torch_pipeline_e2e import pipeline_config
from video_transformer_tpu import cli as j_cli
from video_transformer_tpu_torch import cli as p_cli
from video_transformer_tpu_torch.utils.config import DEFAULT_CONFIG_PATH

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def run_cli(side: str, pair, root: Path, argv: list[str], monkeypatch, capsys) -> tuple[int, str]:
    """One CLI's ``main(argv + --config ...)`` with its engine injected;
    returns (exit code, stdout)."""
    config = pipeline_config(root, False, False)
    config["system"]["log_dir"] = str(root / "logs")
    root.mkdir(parents=True, exist_ok=True)
    if side == "j":
        path = root / "config.yaml"
        path.write_text(yaml.safe_dump(config, allow_unicode=True), encoding="utf-8")
        module, engine, extra = j_cli, pair[0], []
    else:
        path = root / "config.json"
        path.write_text(json.dumps(config, ensure_ascii=False), encoding="utf-8")
        module, engine, extra = p_cli, pair[1], ["--device", "cpu"]
    engine.stats = type(engine.stats)()
    monkeypatch.setattr(module, "VideoPipeline", functools.partial(module.VideoPipeline, engine=engine))
    logger = logging.getLogger("video_transformer")
    saved = logger.handlers[:]
    logger.handlers = []
    try:
        capsys.readouterr()
        code = module.main(argv + ["--config", str(path)] + extra)
        out = capsys.readouterr().out
    finally:
        for handler in logger.handlers:
            handler.close()
        logger.handlers = saved
        monkeypatch.undo()
    return code, re.sub(r"(总)?耗时: [\d.]+s", "TIME", out).replace(str(root), "ROOT")


def saved(root: Path) -> dict:
    notes = {p.name: p.read_bytes() for p in sorted((root / "output" / "documents").glob("*.md"))}
    progress_path = root / "temp" / "progress.json"
    progress = None
    if progress_path.exists():
        progress = json.loads(progress_path.read_text(encoding="utf-8"))
        progress.pop("last_updated")
        for failure in progress["failed"].values():
            failure.pop("timestamp")
    return {"notes": notes, "progress": progress}


def both(pair, tmp_path, argv_for, monkeypatch, capsys, name: str):
    out = {}
    for side in ("j", "p"):
        root = tmp_path / name / side
        code, stdout = run_cli(side, pair, root, argv_for(root), monkeypatch, capsys)
        out[side] = (code, stdout, saved(root))
    return out


def test_url_equal(pair, tmp_path, monkeypatch, capsys):
    clip = write_clip(tmp_path / "talk.npzv", seconds=5)
    got = both(pair, tmp_path, lambda root: ["--url", str(clip)], monkeypatch, capsys, "url")
    assert got["p"] == got["j"]
    assert got["p"][0] == 0 and "talk_knowledge_note.md" in got["p"][2]["notes"]
    assert got["p"][2]["progress"]["processed"] == ["talk"]


def test_batch_and_sharded_equal_then_skip(pair, tmp_path, monkeypatch, capsys):
    clips = [write_clip(tmp_path / f"b{i}.npzv", seconds=4 + i, seed=30 + i) for i in range(2)]
    listing = tmp_path / "urls.txt"
    listing.write_text("# clips\n" + "\n".join(map(str, clips + [tmp_path / "gone.npzv"])) + "\n", encoding="utf-8")
    for flags in (["--batch", str(listing)], ["--batch", str(listing), "--sharded"]):
        name = "sharded" if "--sharded" in flags else "batch"
        got = both(pair, tmp_path, lambda root: flags, monkeypatch, capsys, name)
        assert got["p"] == got["j"]
        assert got["p"][0] == 1  # the missing clip fails the batch
        assert sorted(got["p"][2]["notes"]) == ["b0_knowledge_note.md", "b1_knowledge_note.md"]
        # A second run skips what the progress file holds, as in JAX.
        again = both(pair, tmp_path, lambda root: flags, monkeypatch, capsys, name)
        assert again["p"][:2] == again["j"][:2]


def test_no_checkpoint_equal(pair, tmp_path, monkeypatch, capsys):
    clip = write_clip(tmp_path / "nock.npzv", seconds=4, seed=40)
    got = both(pair, tmp_path, lambda root: ["--url", str(clip), "--no-checkpoint"], monkeypatch, capsys, "nock")
    assert got["p"] == got["j"]
    assert got["p"][2]["progress"] is None


def test_missing_clip_exit_code_equal(pair, tmp_path, monkeypatch, capsys):
    got = both(pair, tmp_path, lambda root: ["--url", str(tmp_path / "absent.npzv")], monkeypatch, capsys, "miss")
    assert got["p"][:2] == got["j"][:2] and got["p"][0] == 1


def test_parser_defaults_and_yaml_refusal(tmp_path):
    args = p_cli.build_parser().parse_args(["--url", "x"])
    assert args.device == "cuda" and args.config is None
    assert {a.dest for a in j_cli.build_parser()._actions} | {"device"} == \
        {a.dest for a in p_cli.build_parser()._actions}
    with pytest.raises(SystemExit, match=re.escape(str(DEFAULT_CONFIG_PATH))):
        p_cli.main(["--url", "x", "--config", str(tmp_path / "config.yaml")])


def test_device_error_leaves_main_and_the_module_exits_nonzero(tmp_path, monkeypatch):
    import torch

    class Failing:
        def __init__(self, **kwargs):
            pass

        def process_single_video(self, url):
            raise torch.OutOfMemoryError("CUDA out of memory")

    config = tmp_path / "config.json"
    config.write_text(json.dumps(pipeline_config(tmp_path, False, False)), encoding="utf-8")
    monkeypatch.setattr(p_cli, "VideoPipeline", Failing)
    with pytest.raises(torch.OutOfMemoryError):
        p_cli.main(["--url", "x.npzv", "--config", str(config), "--device", "cpu"])
    script = (
        "import runpy, sys, torch\n"
        "import video_transformer_tpu_torch.pipeline.pipeline as p\n"
        "def fail(self, url):\n"
        "    raise torch.OutOfMemoryError('CUDA out of memory')\n"
        "p.VideoPipeline.process_single_video = fail\n"
        f"sys.argv = ['x', '--url', 'x.npzv', '--config', {str(config)!r}, '--device', 'cpu']\n"
        "runpy.run_module('video_transformer_tpu_torch', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 1, done.stderr[-2000:]
    assert "torch.OutOfMemoryError: CUDA out of memory" in done.stderr and "Traceback" in done.stderr


def test_config_json_is_the_yaml_mapping():
    """The CLI's default config is the port's JSON, the mapping of the
    JAX package's YAML (as pinned by tests/test_torch_analyzer.py)."""
    want = yaml.safe_load((REPO / "config" / "config.yaml").read_text(encoding="utf-8"))
    assert json.loads(DEFAULT_CONFIG_PATH.read_text(encoding="utf-8")) == copy.deepcopy(want)
