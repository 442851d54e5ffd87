"""The grounding scorecard: the port's clips, notes and eval against JAX's (CPU).

The port keeps its own copies of the topic bank, the clip renderers, the
teacher notes and the style shifts; they must be byte-equal to the JAX
package's for the same rng. Then the port's ``run_eval`` scores the trained
tiny checkpoint (``tiny-zh-grounded-r5mix/params_4500``, loaded from the
committed ``.npz``) against the JAX eval on the orbax original, greedy:

- float32 weights and compute: the generated texts are equal exactly;
- bfloat16 weights and cache (the eval's own settings): the per-topic
  results are equal, and a text may differ only after a near tie. At the
  first token where a port text leaves the JAX text, the JAX model's two best
  grammar-allowed logits there must lie within ``TIE_TOL`` x max|logit| of
  each other (the two frameworks round bf16 products in different orders).

The full 16 topics + 8 composites and the base checkpoint are ``slow``.
"""

import json
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.models.bpe import BpeTokenizer as JBpe
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.lm import init_kv_cache as j_init_kv_cache
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.train import eval_grounding as j_eval
from video_transformer_tpu.train import grounded as jg
from video_transformer_tpu.train import shifts as j_shifts
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.train import eval_grounding
from video_transformer_tpu_torch.train import grounded as pg
from video_transformer_tpu_torch.train import shifts

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOKENIZER = REPO / "data" / "tokenizers" / "bpe-zh-2048.json"
TINY_ORBAX = REPO / "data" / "checkpoints" / "tiny-zh-grounded-r5mix" / "params_4500"
TINY_NPZ = REPO / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz"
BASE_ORBAX = REPO / "data" / "checkpoints" / "base-zh-grounded-r5-bf16" / "params_4100"
BASE_NPZ = REPO / "build" / "torch_weights" / "base-zh-grounded-r5-bf16-params_4100.npz"
TIE_TOL = 1e-2
SEEDS = (0, 7)
N = len(jg.TOPIC_BANK)


def test_topic_bank_and_vocabularies_match():
    assert pg.TOPIC_BANK == tuple(pg.Topic(*vars(t).values()) for t in jg.TOPIC_BANK)
    assert [t.name for t in pg.TOPIC_BANK] == [t.name for t in jg.TOPIC_BANK]
    assert (pg.ORIENT_NAMES, pg.COUNT_NAMES) == (jg.ORIENT_NAMES, jg.COUNT_NAMES)
    for idx in range(N):
        for a, b in zip(pg._topic_palette(idx), jg._topic_palette(idx)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_topic_and_band_clips_are_byte_equal(seed):
    for idx in range(N):
        for render in ("render_topic_clip", "render_band_clip"):
            got = getattr(pg, render)(idx, 3, 24, np.random.default_rng(seed))
            want = getattr(jg, render)(idx, 3, 24, np.random.default_rng(seed))
            assert got.dtype == np.uint8 and got.tobytes() == want.tobytes(), (render, idx)
    overrides = dict(orient=2, n_shapes=4)
    got = pg.render_topic_clip(5, 3, 24, np.random.default_rng(seed), **overrides)
    assert got.tobytes() == jg.render_topic_clip(5, 3, 24, np.random.default_rng(seed), **overrides).tobytes()
    assert pg.render_topic_clip(3, 2, 16).tobytes() == jg.render_topic_clip(3, 2, 16).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_every_composite_pair_is_byte_equal(seed):
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for a in range(N):
        for b in range(N):
            if a != b:
                got = pg.render_composite_clip(a, b, 2, 16, got_rng)
                want = jg.render_composite_clip(a, b, 2, 16, want_rng)
                assert got.tobytes() == want.tobytes(), (a, b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shift", sorted(j_shifts.SHIFT_BANK))
def test_every_shift_is_byte_equal(shift, seed):
    assert sorted(shifts.SHIFT_BANK) == sorted(j_shifts.SHIFT_BANK)
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for idx in range(N):
        clip = jg.render_topic_clip(idx, 3, 24, np.random.default_rng(idx))
        got = shifts.apply_shift(shift, clip, got_rng)
        assert got.tobytes() == j_shifts.apply_shift(shift, clip, want_rng).tobytes(), idx


@pytest.mark.parametrize("seed", SEEDS)
def test_teacher_notes_are_equal(seed):
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for idx in range(N):
        attrs = (idx % 3, 1 + idx % 5) if idx % 2 else None
        got = pg.grounded_note(pg.TOPIC_BANK[idx], got_rng, attrs)
        want = jg.grounded_note(jg.TOPIC_BANK[idx], want_rng, attrs)
        assert json.dumps(got, ensure_ascii=False) == json.dumps(want, ensure_ascii=False)
        other = (idx + 5) % N
        got = pg.composite_note(pg.TOPIC_BANK[idx], pg.TOPIC_BANK[other], got_rng)
        want = jg.composite_note(jg.TOPIC_BANK[idx], jg.TOPIC_BANK[other], want_rng)
        assert json.dumps(got, ensure_ascii=False) == json.dumps(want, ensure_ascii=False)


# -- the scorecard ---------------------------------------------------------------


def recorder(engine) -> list:
    """Wrap ``engine.generate`` so that each call's clips, prompts, texts
    and ids are kept (``run_eval`` only returns the scores)."""
    calls = []
    generate = engine.generate

    def wrapped(frames, prompts, **kwargs):
        texts, ids = generate(frames, prompts, return_tokens=True, **kwargs)
        calls.append((frames, prompts, texts, ids))
        return texts

    engine.generate = wrapped
    return calls


def jax_engine(orbax_dir: Path, preset: str, f32: bool, **kwargs) -> JEngine:
    tok = JBpe.load(TOKENIZER)
    cfg = j_get_preset(preset)
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    if f32:
        cfg = replace(cfg, dtype="float32")
    kwargs = {"max_new_tokens": 1536, "param_dtype": None if f32 else "bfloat16", **kwargs}
    engine = JEngine(
        cfg, mesh=build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1]), temperature=0.0,
        tokenizer=tok, seed=1, compilation_cache_dir=None, **kwargs,
    )  # one device, as the eval's CLI runs: no batch padding to the test mesh's 8 devices
    engine.dfa = engine.wrap_grammar(j_note_dfa(engine.byte_vocab))
    engine.restore(str(orbax_dir))
    return engine


def port_engine(npz: Path, preset: str, f32: bool, **kwargs) -> InferenceEngine:
    tok = BpeTokenizer.load(TOKENIZER)
    cfg = get_preset(preset)
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    if f32:
        cfg = replace(cfg, dtype="float32")
    kwargs = {"max_new_tokens": 1536, "param_dtype": None if f32 else "bfloat16", **kwargs}
    engine = InferenceEngine(cfg, temperature=0.0, tokenizer=tok, seed=1, device="cpu", **kwargs)
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    engine.restore(npz)
    return engine


def jax_tie_margin(j_engine: JEngine, frames, prompt: str, prefix: list[int]) -> tuple[float, float]:
    """(top-2 gap of the grammar-allowed logits, max|logit|) of the JAX model
    after ``prefix``: the prompt and prefix are prefilled as a continuation
    (the engine's own input layout) and the last logits masked by the
    grammar state the prefix reaches."""
    prompt_len = j_engine._prompt_bucket([prompt], with_video=True)
    dfa = j_engine.dfa
    _, total, tokens, lengths, states = j_engine._assemble_inputs(
        [prompt], [prefix], 1, prompt_len, dfa, with_video=True
    )
    clips = np.asarray(frames)[None]
    cfg = j_engine.config
    cache = j_init_kv_cache(cfg.decoder, 1, total + cfg.video_tokens + 128, jnp.dtype(cfg.dtype))
    prefill = jax.jit(lambda *a: j_engine.model.apply(*a, method=JVideoLM.prefill)[0])
    logits = prefill(j_engine.params, j_engine.preprocess(clips), jnp.asarray(tokens), cache, jnp.asarray(lengths))
    masked = np.asarray(dfa.constrain(logits, jnp.asarray(states), j_engine._table_for(dfa)))[0]
    top2 = np.sort(masked)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(np.asarray(logits)[0]).max())


def score_both(orbax_dir, npz, preset, f32, topics, composites, batch):
    topic_ids, pairs = eval_grounding.eval_inputs(topics, composites)
    j_engine, engine = jax_engine(orbax_dir, preset, f32), port_engine(npz, preset, f32)
    j_calls, calls = recorder(j_engine), recorder(engine)
    want = j_eval.run_eval(j_engine, topic_ids, batch, composite_pairs=pairs)
    got = eval_grounding.run_eval(engine, topic_ids, batch, composite_pairs=pairs)
    return j_engine, want, got, j_calls, calls


def check_scorecard(j_engine, want, got, j_calls, calls, exact: bool) -> None:
    assert got["per_topic"] == want["per_topic"]
    assert got.get("per_composite") == want.get("per_composite")
    assert (got["hits"], got.get("composite_hits")) == (want["hits"], want.get("composite_hits"))
    for (frames, prompts, j_texts, j_ids), (_, _, texts, ids) in zip(j_calls, calls, strict=True):
        if exact:
            assert texts == j_texts
            continue
        for row, (a, b) in enumerate(zip(ids, j_ids)):
            if a == b:
                continue
            first = next(i for i, (x, y) in enumerate(zip(a + [-1], b + [-1])) if x != y)
            gap, scale = jax_tie_margin(j_engine, frames[row], prompts[row], b[:first])
            print(f"row {row}: leaves JAX's text at token {first} of {len(b)}; JAX top-2 gap {gap} of {scale}")
            assert gap < TIE_TOL * scale, f"row {row} leaves JAX's text at token {first} with a gap of {gap}"


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_tiny_scorecard_matches_jax(f32):
    """4 topics and 2 composites, batch 4, greedy, at 1,536 new tokens."""
    check_scorecard(*score_both(TINY_ORBAX, TINY_NPZ, "tiny", f32, 4, 2, 4), exact=f32)


@pytest.mark.slow
def test_tiny_full_scorecard_matches_jax():
    """16 topics and 8 composites at the eval's settings: JAX's 10/16 and 0/8."""
    j_engine, want, got, j_calls, calls = score_both(TINY_ORBAX, TINY_NPZ, "tiny", False, 16, 8, 4)
    assert (want["hits"], want["composite_hits"]) == (10, 0)
    check_scorecard(j_engine, want, got, j_calls, calls, exact=False)


@pytest.mark.slow
def test_base_scorecard_matches_jax():
    """The base checkpoint through its ``.npz`` conversion (written under
    ``build/`` by ``tools/orbax_to_npz.py``), at the eval's settings."""
    if not BASE_NPZ.exists():
        from tools.orbax_to_npz import convert

        convert(BASE_ORBAX, BASE_NPZ)
    check_scorecard(*score_both(BASE_ORBAX, BASE_NPZ, "base", False, 4, 2, 4), exact=False)


def test_eval_main_prints_one_json_line(capsys):
    """``main`` keeps the JAX eval's flags and its JSON line."""
    rc = eval_grounding.main([
        "--preset", "tiny", "--checkpoint", str(TINY_NPZ), "--tokenizer", str(TOKENIZER), "--topics", "1",
        "--batch", "1", "--temperature", "0", "--max-new-tokens", "8", "--device", "cpu", "--shifts", "blur3",
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and report["total"] == 1 and report["hits"] == 0
    assert set(report) >= {"per_topic", "decode_tokens_per_s", "wall_seconds", "per_shift", "checkpoint", "seed"}


def test_eval_main_scores_every_checkpoint_newest_first(tmp_path, capsys):
    """``--all-checkpoints`` scores each ``params_N`` under the parent once,
    highest step first, and skips what is not a checkpoint directory."""
    engine = port_engine(TINY_NPZ, "tiny", f32=True)
    state = engine.model.state_dict()
    for step in (3, 10):
        (tmp_path / f"params_{step}").mkdir()
        torch.save(state, tmp_path / f"params_{step}" / "params.pt")
    (tmp_path / "params_x").mkdir()
    (tmp_path / "params_20").write_text("not a checkpoint directory")
    eval_grounding.main([
        "--preset", "tiny", "--checkpoint", str(tmp_path), "--all-checkpoints", "--tokenizer", str(TOKENIZER),
        "--topics", "1", "--batch", "1", "--temperature", "0", "--max-new-tokens", "4", "--device", "cpu",
    ])
    reports = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [Path(r["checkpoint"]).name for r in reports] == ["params_10", "params_3"]
    assert reports[0]["per_topic"] == reports[1]["per_topic"]


def test_eval_inputs_are_the_jax_evals():
    """The topic stride and the rng-17 composite pairs of the JAX eval's
    ``main``, which builds them inline."""
    topic_ids, pairs = eval_grounding.eval_inputs(16, 8)
    stride = max(N // 16, 1)
    assert topic_ids == [(i * stride) % N for i in range(16)]
    pair_rng = np.random.default_rng(17)
    assert pairs == [tuple(int(x) for x in pair_rng.choice(N, size=2, replace=False)) for _ in range(8)]
    assert eval_grounding.eval_inputs(N + 5, 0) == (list(range(N)), [])


def test_int8_pad_row_scales_depart_from_jax_on_purpose(monkeypatch):
    """The port departs from the JAX engine here on purpose (ROADMAP F6).
    With the trained weights, an int8 KV cache and a batch bucket of 4 for
    3 clips whose pad row's patches are scaled by 8, the JAX engine's real
    rows leave its unbucketed tokens (its prefill calibrates the KV scales
    over every row), while the port's equal its unbucketed call's (pad rows
    take no part in the scales). Greedy, float32, 256 new tokens."""
    j_engine = jax_engine(TINY_ORBAX, "tiny", f32=True, kv_quant="int8", max_new_tokens=256)
    engine = port_engine(TINY_NPZ, "tiny", f32=True, kv_quant="int8", max_new_tokens=256)
    cfg = engine.config.encoder
    rng = np.random.default_rng(99)
    clips = np.stack([pg.render_topic_clip(t, cfg.num_frames, cfg.image_size, rng) for t in (0, 5, 9)])
    prompts = ["分析这段视频"] * 3

    def pad_row_scaled(preprocess, scale):
        def wrapped(frames):
            patches = preprocess(frames)
            return scale(patches) if len(frames) == 4 else patches
        return wrapped

    j_plain = j_engine.generate(clips, prompts, return_tokens=True)
    plain = engine.generate(clips, prompts, return_tokens=True)
    assert plain == j_plain
    monkeypatch.setattr(j_engine, "preprocess", pad_row_scaled(j_engine.preprocess, lambda p: p.at[3].multiply(8)))
    monkeypatch.setattr(engine, "preprocess",
                        pad_row_scaled(engine.preprocess, lambda p: torch.cat([p[:3], p[3:] * 8])))
    j_bucketed = j_engine.generate(clips, prompts, return_tokens=True, batch_bucket=4)
    bucketed = engine.generate(clips, prompts, return_tokens=True, batch_bucket=4)
    assert j_bucketed[1] != j_plain[1]
    assert bucketed == plain
