"""The port's training data paths against the JAX package's (CPU).

``--data`` (staged (clip, note) pairs) and ``--grounded`` (topic-signature
pairs rendered on the host), with grammar-aligned note tokenization:

- ``TokenGrammar.encode_aligned`` gives the JAX ids exactly on teacher
  notes (grounded, composite, templated; attributes on and off) and raises
  the JAX ``ValueError`` off the grammar; the on-disk bitset cache holds
  the JAX bitset exactly and a second construction loads it from the file;
- ``_staged_batches`` and ``_grounded_batches`` yield the JAX training CLI's
  batches for the same arguments and seed: tokens and prompt blocks
  exactly, patches (float32) within 1e-5, the tolerance of the
  preprocess parity in ``tests/test_torch_ops.py``;
- ``distillation_records``, ``stage_grounded_corpus`` and
  ``stage_out_of_bank`` find and write the same files with equal frames and
  JSON;
- ``python -m video_transformer_tpu_torch.train.run --grounded`` and
  ``--data DIR`` train two steps on the CPU with finite losses and save a
  checkpoint that restores.
"""

import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.models.bpe import BpeTokenizer as JBpe
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.ops.token_grammar import TokenGrammar as JTokenGrammar
from video_transformer_tpu.train import data as j_data
from video_transformer_tpu.train import eval_real as j_eval_real
from video_transformer_tpu.train import grounded as jg
from video_transformer_tpu.train import run as j_run
from video_transformer_tpu.video.containers import read_frames as j_read_frames
from video_transformer_tpu.video.containers import write_npzv as j_write_npzv
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops import token_grammar
from video_transformer_tpu_torch.ops.token_grammar import TokenGrammar
from video_transformer_tpu_torch.train import data
from video_transformer_tpu_torch.train import eval_real
from video_transformer_tpu_torch.train import grounded as pg
from video_transformer_tpu_torch.train import run
from video_transformer_tpu_torch.train.trainer import Trainer
from video_transformer_tpu_torch.video.containers import read_frames

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOKENIZER = REPO / "data" / "tokenizers" / "bpe-zh-2048.json"
PATCH_TOL = 1e-5
SEEDS = range(24)
LOGGER = logging.getLogger("test_torch_train_data")


@pytest.fixture(scope="module")
def grammars():
    tok, j_tok = BpeTokenizer.load(TOKENIZER), JBpe.load(TOKENIZER)
    return TokenGrammar(note_dfa(512), tok), JTokenGrammar(j_note_dfa(512), j_tok, cache_dir=None)


# -- encode_aligned and the bitset cache ------------------------------------------


def teacher_notes(seed: int) -> list[str]:
    """The teacher notes of one seed: grounded with and without attributes,
    composite and templated, as JSON text."""
    rng = np.random.default_rng(seed)
    n = len(pg.TOPIC_BANK)
    idx, other = seed % n, (seed * 7 + 3) % n
    other += other == idx
    notes = [
        pg.grounded_note(pg.TOPIC_BANK[idx], rng),
        pg.grounded_note(pg.TOPIC_BANK[idx], rng, attrs=(seed % 3, 1 + seed % 5)),
        pg.composite_note(pg.TOPIC_BANK[idx], pg.TOPIC_BANK[other % n], rng),
        data.templated_teacher_note(rng),
    ]
    return [json.dumps(note, ensure_ascii=False) for note in notes]


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_aligned_gives_the_jax_ids(grammars, seed):
    grammar, j_grammar = grammars
    for text in teacher_notes(seed):
        got = grammar.encode_aligned(text)
        assert got == j_grammar.encode_aligned(text)
        assert grammar.tokenizer.decode(got) == text
        # Aligned ids split where forcedness flips, so they differ from the
        # plain pre-split encoding while decoding to the same text.
        assert got != grammar.tokenizer.encode(text)


@pytest.mark.parametrize("text", ['{"title": 5}', "not json", '{"title": "a"}}'])
def test_encode_aligned_raises_off_the_grammar_as_jax_does(grammars, text):
    grammar, j_grammar = grammars
    with pytest.raises(ValueError) as want:
        j_grammar.encode_aligned(text)
    with pytest.raises(ValueError) as got:
        grammar.encode_aligned(text)
    assert str(got.value) == str(want.value)


def test_bitset_cache_holds_the_jax_bits_and_is_loaded(grammars, tmp_path, monkeypatch):
    _, j_grammar = grammars
    tok = BpeTokenizer.load(TOKENIZER)
    dfa = note_dfa(512)
    built = TokenGrammar(dfa, tok, cache_dir=tmp_path)
    assert built._cache_key() == j_grammar._cache_key()
    np.testing.assert_array_equal(built.allowed_bits, j_grammar.allowed_bits)
    assert built.allowed_bits.dtype == j_grammar.allowed_bits.dtype
    (path,) = tmp_path.iterdir()
    assert path.name == f"bits_{j_grammar._cache_key()}.npz"
    mtime = path.stat().st_mtime_ns

    loads = []
    real_load = np.load
    monkeypatch.setattr(token_grammar.np, "load", lambda *a, **k: loads.append(a[0]) or real_load(*a, **k))
    loaded = TokenGrammar(dfa, tok, cache_dir=tmp_path)
    assert loads == [path] and path.stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(loaded.allowed_bits, j_grammar.allowed_bits)

    # The JAX loader reads the port's file: one format.
    again = JTokenGrammar(j_note_dfa(512), JBpe.load(TOKENIZER), cache_dir=tmp_path)
    np.testing.assert_array_equal(again.allowed_bits, j_grammar.allowed_bits)

    path.write_bytes(b"torn")  # a torn file is rebuilt and published again
    rebuilt = TokenGrammar(dfa, tok, cache_dir=tmp_path)
    np.testing.assert_array_equal(rebuilt.allowed_bits, j_grammar.allowed_bits)
    np.testing.assert_array_equal(real_load(path)["bits"], j_grammar.allowed_bits)


def test_default_cache_lies_under_build_at_the_repo_root(tmp_path, monkeypatch):
    """Relative cache dirs anchor at the repo root, not the cwd; the default
    is ``build/grammar_cache`` (never the JAX package's ``data/cache``)."""
    monkeypatch.chdir(tmp_path)
    tok = BpeTokenizer.load(TOKENIZER)
    grammar = TokenGrammar(note_dfa(512, scale=0.25), tok)
    assert (REPO / "build" / "grammar_cache" / f"bits_{grammar._cache_key()}.npz").exists()
    assert not any(tmp_path.iterdir())
    uncached = TokenGrammar(note_dfa(512, scale=0.25), tok, cache_dir=None)
    np.testing.assert_array_equal(uncached.allowed_bits, grammar.allowed_bits)


# -- batches -------------------------------------------------------------------------


def assert_same_batches(got_iter, want_iter, count: int = 3) -> None:
    for _ in range(count):
        (patches, tokens, blocks), (j_patches, j_tokens, j_blocks) = next(got_iter), next(want_iter)
        assert isinstance(patches, torch.Tensor) and patches.dtype == torch.float32
        assert patches.shape == j_patches.shape
        np.testing.assert_allclose(patches.numpy(), np.asarray(j_patches, np.float32), atol=PATCH_TOL, rtol=PATCH_TOL)
        assert tokens.dtype == j_tokens.dtype and blocks.dtype == j_blocks.dtype
        np.testing.assert_array_equal(tokens, j_tokens)
        np.testing.assert_array_equal(blocks, j_blocks)


def batch_args(grammars, tokenizer: bool) -> tuple[dict, dict]:
    """Port and JAX keyword arguments of a batch iterator: prompts sampled
    by each CLI's own sampler, and with ``tokenizer`` the BPE codec and
    each package's ``encode_aligned``."""
    grammar, j_grammar = grammars
    kwargs = {"prompt": run.make_prompt_sampler("compact"), "prompt_len": 128}
    j_kwargs = {"prompt": j_run.make_prompt_sampler("compact"), "prompt_len": 128}
    if tokenizer:
        kwargs.update(tok=grammar.tokenizer, encode_note=grammar.encode_aligned)
        j_kwargs.update(tok=j_grammar.tokenizer, encode_note=j_grammar.encode_aligned)
    return kwargs, j_kwargs


def configs(tokenizer: bool):
    from dataclasses import replace

    cfg, j_cfg = get_preset("tiny"), j_get_preset("tiny")
    if tokenizer:
        cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=2048))
        j_cfg = replace(j_cfg, decoder=replace(j_cfg.decoder, vocab_size=2048))
    return cfg, j_cfg


GROUNDED_CASES = {
    "plain": dict(cache_size=0),
    "every_branch": dict(cache_size=8, composite_p=0.4, band_p=0.2, attrs_p=0.5, hard_pairs_p=0.5, seed=3),
    "every_branch_uncached": dict(cache_size=0, composite_p=0.3, band_p=0.3, attrs_p=0.6, hard_pairs_p=0.6, seed=5),
}


@pytest.mark.parametrize("tokenizer", [False, True], ids=["bytes", "bpe"])
@pytest.mark.parametrize("case", sorted(GROUNDED_CASES))
def test_grounded_batches_are_the_jax_clis(grammars, tokenizer, case):
    kwargs, j_kwargs = batch_args(grammars, tokenizer)
    cfg, j_cfg = configs(tokenizer)
    opts = GROUNDED_CASES[case]
    got = run._grounded_batches(cfg, 3, 480, LOGGER, device="cpu", **kwargs, **opts)
    want = j_run._grounded_batches(j_cfg, 3, 480, LOGGER, **j_kwargs, **opts)
    assert_same_batches(got, want)


def test_every_sample_branch_runs():
    """The branch-covering case draws composite (near-hue and uniform
    partners), band-only and attribute samples: each branch's renderer is
    called at least once within the 8-sample pool."""
    calls = {name: 0 for name in ("render_composite_clip", "render_band_clip", "render_topic_clip")}
    hard = []
    originals = {name: getattr(pg, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            if name == "render_topic_clip" and kwargs.get("orient") is not None:
                hard.append("attrs")
            return originals[name](*args, **kwargs)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(pg, name, counted(name))
        batches = run._grounded_batches(get_preset("tiny"), 3, 480, LOGGER, device="cpu",
                                        **GROUNDED_CASES["every_branch"])
        next(batches)
    assert all(calls.values()), calls
    assert "attrs" in hard


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Four grounded pairs staged by the JAX package, one of them rewritten
    as a 6-frame 48x80 clip (staged clips need not share a size)."""
    out = tmp_path_factory.mktemp("staged")
    paths = jg.stage_grounded_corpus(out, 4, j_get_preset("tiny").encoder, seed=2)
    frames = np.random.default_rng(0).integers(0, 256, (6, 48, 80, 3), dtype=np.uint8)
    j_write_npzv(paths[1], frames, fps=2.0)
    return out


@pytest.mark.parametrize("tokenizer", [False, True], ids=["bytes", "bpe"])
def test_staged_batches_are_the_jax_clis(grammars, staged, tokenizer):
    kwargs, j_kwargs = batch_args(grammars, tokenizer)
    cfg, j_cfg = configs(tokenizer)
    got = run._staged_batches(staged, cfg, 3, 480, LOGGER, device="cpu", **kwargs)
    want = j_run._staged_batches(staged, j_cfg, 3, 480, LOGGER, **j_kwargs)
    assert_same_batches(got, want)


def test_staged_batches_without_pairs_exit(tmp_path):
    with pytest.raises(SystemExit, match="no \\(video, note\\) pairs"):
        next(run._staged_batches(tmp_path, get_preset("tiny"), 2, 480, LOGGER))


# -- staging ---------------------------------------------------------------------------


def test_distillation_records_find_the_jax_pairs(tmp_path):
    """Every container extension in the JAX order, a note without a clip,
    a clip without a note, and two containers for one stem."""
    for stem, exts in {"a": [".mp4"], "b": [".npz", ".y4m"], "c": [], "d": [".npzv", ".mp4"], "e": [".y4m"]}.items():
        (tmp_path / f"{stem}.note.json").write_text(json.dumps({"title": stem}), encoding="utf-8")
        for ext in exts:
            (tmp_path / f"{stem}{ext}").write_bytes(b"clip")
    (tmp_path / "orphan.npzv").write_bytes(b"clip")
    got = list(data.distillation_records(tmp_path))
    want = list(j_data.distillation_records(tmp_path))
    assert got == want
    assert [(p.name, note["title"]) for p, note in got] == [
        ("a.mp4", "a"), ("b.npz", "b"), ("d.npzv", "d"), ("e.y4m", "e")]


def assert_same_tree(got_dir: Path, want_dir: Path, reader, j_reader, num_frames: int) -> None:
    names = sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(p.name for p in want_dir.iterdir())
    for name in names:
        got, want = got_dir / name, want_dir / name
        if name.endswith(".json"):
            assert got.read_text(encoding="utf-8") == want.read_text(encoding="utf-8")
        else:
            with np.load(got) as a, np.load(want) as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(reader(got, num_frames), j_reader(want, num_frames))


@pytest.mark.parametrize("seed", [0, 9])
def test_stage_grounded_corpus_writes_the_jax_files(tmp_path, seed):
    got = pg.stage_grounded_corpus(tmp_path / "port", 5, get_preset("tiny").encoder, seed=seed)
    want = jg.stage_grounded_corpus(tmp_path / "jax", 5, j_get_preset("tiny").encoder, seed=seed)
    assert [p.name for p in got] == [p.name for p in want]
    assert_same_tree(tmp_path / "port", tmp_path / "jax", read_frames, j_read_frames, 4)
    records = list(data.distillation_records(tmp_path / "port"))
    assert [p.name for p, _ in records] == [p.name for p in got]


@pytest.mark.parametrize("seed", [123, 36])
def test_stage_out_of_bank_writes_the_jax_files(tmp_path, seed):
    got = eval_real.stage_out_of_bank(tmp_path / "port", 4, 4, 64, seed=seed)
    want = j_eval_real.stage_out_of_bank(tmp_path / "jax", 4, 4, 64, seed=seed)
    assert [p.name for p in got] == [p.name for p in want]
    assert_same_tree(tmp_path / "port", tmp_path / "jax", read_frames, j_read_frames, 4)


# -- the CLI end to end -----------------------------------------------------------------

STEP_RE = re.compile(r"event=train_step step=(\d+) loss=(\S+) acc=\S+ grad_norm=(\S+)")


def train_cli(tmp_path: Path, *args: str) -> tuple[str, Path]:
    out = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    result = subprocess.run(
        [sys.executable, "-m", "video_transformer_tpu_torch.train.run", "--preset", "tiny", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--text-len", "224", "--tokenizer", str(TOKENIZER),
         "--out", str(out), "--log-dir", str(tmp_path / "logs"), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    return result.stderr, out


def check_trained(log: str, out: Path) -> None:
    steps = STEP_RE.findall(log)
    assert [s[0] for s in steps] == ["1"]
    assert all(np.isfinite(float(s[1])) and np.isfinite(float(s[2])) for s in steps)
    final = re.search(r"event=train_complete steps=2 final_loss=(\S+)", log)
    assert final and np.isfinite(float(final.group(1)))
    from dataclasses import replace

    cfg = get_preset("tiny")
    trainer = Trainer(replace(cfg, decoder=replace(cfg.decoder, vocab_size=2048)), device="cpu", seed=1)
    trainer.restore_checkpoint(out / "params_2")
    saved = torch.load(out / "params_2" / "params.pt", weights_only=True)
    assert trainer.step_count == 2
    assert all(torch.equal(v, saved[k]) for k, v in trainer.model.state_dict().items())


def test_cli_trains_on_grounded_pairs(tmp_path):
    log, out = train_cli(tmp_path, "--grounded", "--grounded-cache", "8", "--grounded-composite", "0.5",
                         "--grounded-attrs", "0.5")
    assert "grounded corpus: 48 topics, caching 8 samples" in log
    check_trained(log, out)


def test_cli_trains_on_staged_pairs(tmp_path):
    pg.stage_grounded_corpus(tmp_path / "staged", 3, get_preset("tiny").encoder)
    log, out = train_cli(tmp_path, "--data", str(tmp_path / "staged"))
    assert "staged records: 3" in log
    check_trained(log, out)


def test_cli_refuses_tp_and_pp_only(tmp_path):
    """``--tp`` and ``--pp`` together exit, as JAX's CLI does; each alone is
    ported (``tests/test_torch_train_mesh.py``)."""
    args = run.build_parser().parse_args(["--tp", "2", "--pp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        run.prepare(args, LOGGER)
