"""The port's last note tools against the JAX package's (CPU, exact).

``utils/compressor.py``, ``tools/add_p_params.py``, ``tools/export_pdf.py``
and ``models/bpe.py``'s ``train_bpe`` and ``BpeTokenizer.save`` are copies
of the JAX package's. The JAX tests' cases are rerun against the port
(``rerun``, with the JAX module names the test bodies import rebound to the
port's), and each tool is held to its original exactly: the digest byte for
byte on the JAX tests' notes and on notes the port's renderer writes, the
rewritten URL lists, ``export_pdf``'s pandoc command line and its errors
(with a stand-in ``pandoc`` on ``PATH``, and with none), and the learned
merges and the saved vocabulary file.
"""

import json
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import tests.test_observability as j_obs_tests
import tests.test_tools_cli as j_tools_tests
from tests.test_torch_pipeline_pure import jax_test_notes, port_modules, rerun
from video_transformer_tpu.models import bpe as j_bpe
from video_transformer_tpu.tools import add_p_params as j_add_p
from video_transformer_tpu.tools import export_pdf as j_export
from video_transformer_tpu.train import grounded as jg
from video_transformer_tpu.utils import compressor as j_compressor
from video_transformer_tpu.utils.config import load_config as j_load_config
from video_transformer_tpu_torch.models import bpe
from video_transformer_tpu_torch.tools import add_p_params
from video_transformer_tpu_torch.tools import export_pdf
from video_transformer_tpu_torch.utils import compressor
from video_transformer_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]


# -- compressor ---------------------------------------------------------------------

COMPRESSOR_NAMES = {"compress_note": compressor.compress_note, "parse_topics": compressor.parse_topics}


@pytest.mark.parametrize("name", [n for n in vars(j_tools_tests.TestCompressor) if n.startswith("test_")])
def test_compressor_cases_hold_the_port(name):
    rerun(j_tools_tests, COMPRESSOR_NAMES, getattr(j_tools_tests.TestCompressor, name), j_tools_tests.TestCompressor())


@pytest.mark.parametrize("limits", [(6, 300), (2, 300), (6, 12), (1, 3)], ids=lambda x: f"{x[0]}-{x[1]}")
def test_compress_note_is_byte_equal(limits):
    """The JAX tests' notes (lecture, legacy, deep, empty) and the notes the
    port's contracts render in every mode."""
    notes = jax_test_notes()
    assert len(notes) > 15
    for note in notes:
        assert compressor.compress_note(note, *limits) == j_compressor.compress_note(note, *limits)
        got, want = compressor.parse_topics(note), j_compressor.parse_topics(note)
        assert [vars(t) for t in got] == [vars(t) for t in want]


def test_compressor_main_writes_the_jax_digest(tmp_path, capsys):
    note = tmp_path / "note.md"
    note.write_text(j_tools_tests.lecture_note(), encoding="utf-8")
    assert compressor.main([str(note), "-o", str(tmp_path / "port.md"), "--max-lines", "20"]) == 0
    port_out = capsys.readouterr().out
    assert j_compressor.main([str(note), "-o", str(tmp_path / "jax.md"), "--max-lines", "20"]) == 0
    jax_out = capsys.readouterr().out
    assert (tmp_path / "port.md").read_bytes() == (tmp_path / "jax.md").read_bytes()
    assert port_out.replace("port.md", "jax.md") == jax_out


# -- add_p_params ---------------------------------------------------------------------

URL_LINES = [
    "https://www.bilibili.com/video/BV1",
    "# comment",
    "",
    "https://www.bilibili.com/video/BV1?t=5",
    "https://www.bilibili.com/video/BV1?p=9",
    "  https://www.bilibili.com/video/BV2  ",
    "https://example.com/a?x=1&p=3",
    "https://example.com/p=2?y=1",
]


def test_add_p_params_case_holds_the_port():
    with port_modules(tools__add_p_params=add_p_params):
        rerun(j_obs_tests, {}, j_obs_tests.test_add_p_params)


@pytest.mark.parametrize("start", [1, 4])
def test_add_part_numbers_is_equal(start):
    assert add_p_params.add_part_numbers(URL_LINES, start) == j_add_p.add_part_numbers(URL_LINES, start)


def test_add_p_params_main_rewrites_as_jax(tmp_path, capsys):
    for name, module in (("port", add_p_params), ("jax", j_add_p)):
        path = tmp_path / f"{name}.txt"
        path.write_text("\n".join(URL_LINES), encoding="utf-8")
        assert module.main([str(path), "--start", "2"]) == 0
        assert module.main([str(path), "-o", str(tmp_path / f"{name}_out.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "port_out.txt").read_bytes() == (tmp_path / "jax_out.txt").read_bytes()
    out = capsys.readouterr().out
    assert out.count("wrote") == 4


# -- export_pdf ---------------------------------------------------------------------------

FAKE_PANDOC = """#!{python}
import os, sys
args = sys.argv[1:]
with open(os.environ["PANDOC_ARGS"], "w", encoding="utf-8") as fh:
    fh.write("\\n".join(args))
if os.environ.get("PANDOC_FAIL"):
    sys.stderr.write("xelatex not found\\n")
    sys.exit(43)
if not os.environ.get("PANDOC_NO_OUTPUT"):
    open(args[args.index("-o") + 1], "wb").write(b"%PDF")
"""


@pytest.fixture
def fake_pandoc(tmp_path, monkeypatch):
    """A ``pandoc`` on PATH that records its arguments (and may fail)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    script = bin_dir / "pandoc"
    script.write_text(FAKE_PANDOC.format(python=sys.executable), encoding="utf-8")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv("PANDOC_ARGS", str(tmp_path / "args.txt"))
    return tmp_path / "args.txt"


def both_exports(tmp_path: Path, args_file: Path, typesetting) -> tuple[list, list]:
    """(port's, JAX's) recorded pandoc argument lists for the same note."""
    note = tmp_path / "note.md"
    note.write_text("# 笔记\n\n正文。\n", encoding="utf-8")
    recorded = []
    for module in (export_pdf, j_export):
        out = module.export_pdf(note, tmp_path / "note.pdf", typesetting)
        assert out == tmp_path / "note.pdf" and out.read_bytes() == b"%PDF"
        out.unlink()
        recorded.append(args_file.read_text(encoding="utf-8").split("\n"))
    return recorded[0], recorded[1]


@pytest.mark.parametrize("with_header", [False, True])
def test_export_pdf_gives_the_jax_command(tmp_path, fake_pandoc, with_header):
    header = tmp_path / "header.tex"
    header.write_text("% header", encoding="utf-8")
    settings = [None, {"engine": "lualatex", "mainfont": "Noto Serif CJK SC"},
                {"header_tex_path": str(header) if with_header else str(tmp_path / "missing.tex")}]
    for typesetting in settings:
        got, want = both_exports(tmp_path, fake_pandoc, typesetting)
        assert got == want
        assert ("-H" in got) == (with_header and typesetting is settings[2])


def test_export_pdf_main_reads_the_ports_json_config(tmp_path, fake_pandoc, capsys):
    """The port's ``--config`` is its JSON config; the JAX main reads the
    same mapping from YAML. Same typesetting, same command."""
    header = tmp_path / "header.tex"
    header.write_text("% header", encoding="utf-8")
    config = j_load_config(REPO / "config" / "config.yaml")
    config["system"]["pdf_typesetting"] = {"engine": "lualatex", "monofont": "Noto Sans Mono",
                                           "header_tex_path": str(header)}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config, allow_unicode=True), encoding="utf-8")
    (tmp_path / "config.json").write_text(json.dumps(config, ensure_ascii=False), encoding="utf-8")
    assert load_config(tmp_path / "config.json")["system"]["pdf_typesetting"] == \
        j_load_config(tmp_path / "config.yaml")["system"]["pdf_typesetting"]
    note = tmp_path / "note.md"
    note.write_text("# 笔记\n", encoding="utf-8")
    recorded = []
    for module, cfg in ((export_pdf, "config.json"), (j_export, "config.yaml")):
        assert module.main([str(note), "-o", str(tmp_path / "n.pdf"), "--config", str(tmp_path / cfg)]) == 0
        recorded.append(fake_pandoc.read_text(encoding="utf-8"))
    assert recorded[0] == recorded[1] and "--pdf-engine=lualatex" in recorded[0]
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote {tmp_path / 'n.pdf'}"] * 2


@pytest.mark.parametrize("fault", ["PANDOC_FAIL", "PANDOC_NO_OUTPUT"])
def test_export_pdf_failures_give_the_jax_error(tmp_path, fake_pandoc, monkeypatch, fault):
    monkeypatch.setenv(fault, "1")
    note = tmp_path / "note.md"
    note.write_text("# 笔记\n", encoding="utf-8")
    errors = []
    for module in (export_pdf, j_export):
        with pytest.raises(RuntimeError) as err:
            module.export_pdf(note, tmp_path / "note.pdf")
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_missing_pandoc_gives_the_jax_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))  # no pandoc anywhere on PATH
    note = tmp_path / "note.md"
    note.write_text("# 笔记\n", encoding="utf-8")
    errors = []
    for module in (export_pdf, j_export):
        with pytest.raises(RuntimeError, match="pandoc is not installed") as err:
            module.export_pdf(note, tmp_path / "note.pdf")
        errors.append(str(err.value))
        assert module.main([str(note), "-o", str(tmp_path / "note.pdf")]) == 1
    assert errors[0] == errors[1]
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1] == f"error: {errors[0]}"
    assert not (tmp_path / "note.pdf").exists()


# -- train_bpe and save ------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus() -> list[str]:
    """240 grounded teacher notes (single-topic, with and without
    attributes, and composite), as JSON text."""
    rng = np.random.default_rng(5)
    bank = jg.TOPIC_BANK
    notes = []
    for i in range(240):
        topic = bank[i % len(bank)]
        if i % 4 == 3:
            notes.append(jg.composite_note(topic, bank[(i * 7 + 1) % len(bank)], rng))
        else:
            notes.append(jg.grounded_note(topic, rng, attrs=(i % 3, 1 + i % 5) if i % 4 == 1 else None))
    return [json.dumps(n, ensure_ascii=False) for n in notes]


@pytest.mark.parametrize("vocab", [512, 1024])
def test_train_bpe_learns_the_jax_merges_and_saves_its_file(corpus, tmp_path, vocab):
    got = bpe.train_bpe(corpus, vocab)
    want = j_bpe.train_bpe(corpus, vocab)
    assert got.merges == want.merges and got.vocab_size == want.vocab_size == vocab
    assert len(got.merges) == vocab - 260  # the corpus fills the vocab
    got.save(tmp_path / "port.json")
    want.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    loaded = j_bpe.BpeTokenizer.load(tmp_path / "port.json")
    assert loaded.merges == want.merges
    assert bpe.BpeTokenizer.load(tmp_path / "port.json").encode(corpus[0]) == want.encode(corpus[0])


@pytest.mark.parametrize("kwargs", [dict(min_pair_count=50), dict(max_token_bytes=4)], ids=["min_count", "max_bytes"])
def test_train_bpe_stopping_rules_match(corpus, kwargs):
    got = bpe.train_bpe(corpus[:60], 640, **kwargs)
    want = j_bpe.train_bpe(corpus[:60], 640, **kwargs)
    assert got.merges == want.merges
    assert all(len(got.token_bytes(t)) <= kwargs.get("max_token_bytes", 16) for t in range(260, 260 + len(got.merges)))


@pytest.mark.parametrize("vocab", [500, 384])
def test_train_bpe_refuses_bad_vocab_sizes_as_jax(corpus, vocab):
    with pytest.raises(ValueError) as want:
        j_bpe.train_bpe(corpus[:2], vocab)
    with pytest.raises(ValueError) as got:
        bpe.train_bpe(corpus[:2], vocab)
    assert str(got.value) == str(want.value)
