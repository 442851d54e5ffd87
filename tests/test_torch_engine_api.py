"""The engine API the analyzer calls, against the JAX engine (CPU).

``generate_text``, continuation by token-id or text ``prefixes``, sessions
(``session_rounds``/``return_session`` and ``continue_session``) and
``batch_bucket``: the cases of the JAX package's ``tests/test_continuation.py``
and its session-equals-long-budget case, each run through both engines from
the same weights. Decoding is greedy in float32, so every case's token ids
must equal the JAX engine's exactly.
"""

import json
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from video_transformer_tpu.analyzer import schema as j_schema
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu_torch.analyzer import schema
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

PROMPT = ["分析视频"]
MAX_NEW = 160


def j_config(max_seq_len: int = 4096):
    config = __graft_entry__._tiny_config()
    return replace(config, decoder=replace(config.decoder, max_seq_len=max_seq_len))


def port_config(jc) -> VLMConfig:
    return VLMConfig(
        name=jc.name, encoder=EncoderConfig(**vars(jc.encoder)), decoder=DecoderConfig(**vars(jc.decoder)),
        dtype=jc.dtype,
    )


def engines(max_seq_len=4096, grammar=True, **kwargs):
    """A JAX engine and a port engine serving the JAX engine's weights; the
    capped setting of the JAX tests (a 0.2-scale note grammar far longer
    than the 160-token cap, closer bias 5), decoded greedily."""
    jc = j_config(max_seq_len)
    kwargs = {"max_new_tokens": MAX_NEW, "temperature": 0.0, "structure_bias": 5.0, **kwargs}
    j_engine = JEngine(
        jc, dfa=j_schema.note_dfa(512, scale=0.2) if grammar else None, seed=3,
        compilation_cache_dir=None, **kwargs,
    )
    pc = port_config(jc)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), pc, device="cpu")
    engine = InferenceEngine(
        pc, dfa=schema.note_dfa(512, scale=0.2) if grammar else None, params=params, device="cpu", **kwargs,
    )
    return j_engine, engine


@pytest.fixture(scope="module")
def pair():
    return engines()


def both(pair, method, *args, **kwargs):
    j_engine, engine = pair
    return getattr(j_engine, method)(*args, **kwargs), getattr(engine, method)(*args, **kwargs)


def frames(batch: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (batch, 4, 32, 32, 3), dtype=np.uint8)


class TestContinuation:
    def test_capped_generation_reports_incomplete(self, pair):
        want, got = both(pair, "generate_text", PROMPT, prompt_len=16, return_status=True, return_tokens=True)
        assert got == want
        texts, complete, _ = got
        assert complete == [False]
        with pytest.raises(json.JSONDecodeError):
            json.loads(texts[0])

    def test_continuation_rounds_complete_the_note(self, pair):
        """Token-id continuation (the analyzer's path) finishes the note,
        each round giving the JAX engine's tokens."""
        want, got = both(pair, "generate_text", PROMPT, prompt_len=16, return_status=True, return_tokens=True)
        assert got == want
        _, complete, ids = got
        all_ids = list(ids[0])
        rounds = 0
        while not complete[0] and rounds < 12:
            want, got = both(
                pair, "generate_text", PROMPT, prompt_len=16, prefixes=[all_ids],
                return_status=True, return_tokens=True,
            )
            assert got == want
            _, complete, more = got
            assert more[0]  # every round must make progress
            all_ids += more[0]
            rounds += 1
        assert complete[0], f"note incomplete after {rounds} continuations"
        data = json.loads(pair[1].tokenizer.decode(all_ids))
        assert {"title", "deep_dive", "glossary"} <= data.keys()

    def test_prefix_resumes_grammar_not_restarts(self, pair):
        """A text prefix resumes the grammar; the new tail does not re-open
        the JSON document."""
        texts, _ = pair[1].generate_text(PROMPT, prompt_len=16, return_status=True)
        want, got = both(pair, "generate_text", PROMPT, prompt_len=16, prefixes=[texts[0]], return_status=True)
        assert got == want
        assert got[0][0] and not got[0][0].startswith('{"title"')

    def test_overlong_prefix_raises(self, pair):
        huge = "x" * (pair[1].config.decoder.max_seq_len * 2)
        for engine in pair:
            with pytest.raises(ValueError, match="sequence budget"):
                engine.generate_text(PROMPT, prompt_len=16, prefixes=[huge], return_status=True)

    def test_ragged_video_prefixes_match_jax(self, pair):
        """``generate`` with id prefixes of different lengths per row (one
        row with none): the prefill is ragged and each row resumes its own
        grammar state."""
        clips = frames(3)
        prompts = ["分析视频", "总结这一段", "x"]
        _, _, ids = pair[1].generate(clips, prompts, return_status=True, return_tokens=True)
        prefixes = [ids[0][:5], [], ids[2]]
        want, got = both(pair, "generate", clips, prompts, prefixes=prefixes, return_status=True, return_tokens=True)
        assert got == want
        assert all(got[2])


class TestSessionContinuation:
    """Decode-only rounds over the live cache: no re-prefill."""

    def test_session_rounds_complete_the_note(self, pair):
        kwargs = dict(prompt_len=16, return_status=True, return_tokens=True, session_rounds=12, return_session=True)
        j_out, out = both(pair, "generate_text", PROMPT, **kwargs)
        assert out[:3] == j_out[:3]
        (_, complete, ids, session), j_session = out, j_out[3]
        assert session is not None and session.rounds_left == j_session.rounds_left > 0
        engine = pair[1]
        prefill_before = engine.stats.prefill_tokens
        all_ids = list(ids[0])
        rounds = 0
        while not complete[0] and session.rounds_left > 0:
            got, want = engine.continue_session(session), pair[0].continue_session(j_session)
            assert got == want
            _, complete, more = got
            assert more[0]  # every live round must make progress
            all_ids += more[0]
            rounds += 1
        assert complete[0], f"note incomplete after {rounds} session rounds"
        assert engine.stats.prefill_tokens == prefill_before
        assert engine.stats.session_resumes >= rounds
        data = json.loads(engine.tokenizer.decode(all_ids))
        assert {"title", "deep_dive", "glossary"} <= data.keys()

    def test_session_tail_does_not_restart_document(self, pair):
        kwargs = dict(prompt_len=16, return_status=True, return_tokens=True, session_rounds=2, return_session=True)
        j_out, out = both(pair, "generate_text", PROMPT, **kwargs)
        assert out[1] == j_out[1] == [False]
        tails, _, ids = pair[1].continue_session(out[3])
        assert ids == pair[0].continue_session(j_out[3])[2]
        assert tails[0] and not tails[0].startswith('{"title"')

    def test_completed_rows_return_empty_tails(self, pair):
        """A session resumed after acceptance leaves the row frozen."""
        engine = pair[1]
        _, complete, _, session = engine.generate_text(
            PROMPT, prompt_len=16, return_status=True, return_tokens=True, session_rounds=12, return_session=True,
        )
        while not complete[0] and session.rounds_left > 1:
            _, complete, _ = engine.continue_session(session)
        assert complete[0] and session.rounds_left > 0, f"note incomplete with rounds_left={session.rounds_left}"
        tails, now_done, tail_ids = engine.continue_session(session)
        assert tails == [""] and tail_ids == [[]] and now_done == [True]

    def test_rounds_granted_fit_sequence_budget(self, pair):
        """An oversized reserve degrades to what the cache can hold, as the
        JAX engine grants it, for every prompt width."""
        j_engine, engine = pair
        bw = engine._block_width(engine.dfa)
        for prompt_width in range(128, 2049, 128):
            for with_video in (False, True):
                r = engine._max_session_rounds(prompt_width, with_video, 10_000, engine.dfa)
                assert r == j_engine._max_session_rounds(prompt_width, with_video, 10_000, j_engine.dfa)
                video = engine.config.video_tokens if with_video else 0
                total = video + prompt_width + (1 + r) * (engine.max_new_tokens + bw) + 1 + bw + 16
                assert -(-total // 128) * 128 <= engine.config.decoder.max_seq_len
                assert engine._cache_len(prompt_width, with_video, engine.dfa, r) == -(-total // 128) * 128

    def test_unfittable_session_returns_none(self):
        """max_new at the sequence ceiling leaves no reserve -> None."""
        jc = j_config(1024)
        j_engine, engine = engines(1024, max_new_tokens=jc.decoder.max_seq_len - 256, structure_bias=2.0)
        want, got = (
            e.generate_text(["x"], prompt_len=16, session_rounds=3, return_session=True, return_tokens=True)
            for e in (j_engine, engine)
        )
        assert got[1] == want[1]
        assert got[2] is None and want[2] is None

    def test_reserve_without_return_session_is_dropped(self, pair, monkeypatch):
        """session_rounds alone reserves no cache: the session is the only
        consumer of the reserve."""
        engine = pair[1]
        reserved = []
        cache_len = engine._cache_len
        monkeypatch.setattr(engine, "_cache_len", lambda *a: reserved.append(a[-1]) or cache_len(*a))
        want, got = both(pair, "generate_text", PROMPT, prompt_len=16, session_rounds=12, return_tokens=True)
        assert got == want
        assert reserved == [0]

    def test_exhausted_session_raises(self, pair):
        engine = pair[1]
        _, _, _, session = engine.generate_text(
            PROMPT, prompt_len=16, return_status=True, return_tokens=True, session_rounds=1, return_session=True,
        )
        engine.continue_session(session)
        with pytest.raises(ValueError, match="exhausted"):
            engine.continue_session(session)

    def test_session_continuation_matches_long_budget(self):
        """A session's combined tokens equal one call whose budget gives the
        same cache length: (1 + r) * max_new + r * block_width for a reserve
        of r rounds. The reserve is large enough for the note to complete,
        so the session and the long call stop at the same token."""
        short_new, rounds = 64, 12
        j_short, short = engines(max_new_tokens=short_new)
        bw = short._block_width(short.dfa)
        j_long, long = engines(max_new_tokens=(1 + rounds) * short_new + rounds * bw)
        _, status, ids, session = short.generate_text(
            ["go"], return_status=True, return_tokens=True, session_rounds=rounds, return_session=True,
        )
        assert session.rounds_left == rounds and not status[0]
        assert session.cache["k"][0].shape[2] == long._cache_len(128, False, long.dfa, 0)
        combined, ok = list(ids[0]), status[0]
        while not ok and session.rounds_left > 0:
            _, done, more = short.continue_session(session)
            combined += more[0]
            ok = done[0]
        want = j_long.generate_text(["go"], return_status=True, return_tokens=True)
        got = long.generate_text(["go"], return_status=True, return_tokens=True)
        assert got == want
        assert ok and got[1] == [True]
        assert combined == got[2][0]


class TestBatchBucket:
    @pytest.mark.parametrize("kv_quant", [None, "int8"])
    def test_bucket_pads_and_freezes_pad_rows(self, kv_quant, monkeypatch):
        """Three clips in a bucket of four: the pad row (empty prompt, zero
        frames) is frozen from step 0, the stats count the real rows only,
        and the real rows' tokens equal the unbucketed call's and the JAX
        engine's bucketed call's."""
        j_engine, engine = engines(kv_quant=kv_quant)
        clips = frames(3, seed=1)
        prompts = ["分析视频", "分析音频", "x"]
        plain = engine.generate(clips, prompts, return_status=True, return_tokens=True)
        decoded = []
        decode = engine._decode
        monkeypatch.setattr(engine, "_decode", lambda *a: decoded.append(decode(*a)) or decoded[-1])
        before = engine.stats.tokens_generated
        got = engine.generate(clips, prompts, return_status=True, return_tokens=True, batch_bucket=4)
        want = j_engine.generate(clips, prompts, return_status=True, return_tokens=True, batch_bucket=4)
        assert got == want == plain
        out_pos = decoded[0][1]
        assert out_pos.shape[0] == 4 and int(out_pos[3]) == 0
        assert engine.stats.tokens_generated - before == sum(map(len, got[2]))

    def test_pad_rows_take_no_part_in_int8_kv_scales(self):
        """The int8 KV scales of a padded prefill equal the unpadded
        prefill's. The JAX engine lets every row of the block into the
        batch-wide amax, so a pad row whose k/v run larger than the real
        rows' raises the scales and changes the real rows' later tokens
        (seen at base width: 24 of 48 scale tensors moved). Here the pad
        row's patches are scaled up so that it would."""
        from video_transformer_tpu_torch.models.lm import init_kv_cache

        _, engine = engines(kv_quant="int8")
        model, cfg = engine.model, engine.config
        clips = frames(4, seed=2)
        patches = engine.preprocess(clips)
        patches[3] *= 8
        tokens = torch.from_numpy(np.stack([engine.tokenizer.encode_array(p, 128, add_bos=True)
                                            for p in ["分析视频", "分析音频", "x", ""]]))
        lengths = torch.full((4,), 128, dtype=torch.int32)

        def scales(rows, active=None):
            cache = init_kv_cache(cfg.decoder, rows, 512, model.compute_dtype, quant=True, device="cpu")
            if active is not None:
                cache["active"] = active
            with torch.no_grad():
                _, cache = model.prefill(patches[:rows], tokens[:rows], cache, lengths[:rows])
            return torch.stack(cache["k_scale"] + cache["v_scale"])

        real = scales(3)
        assert torch.equal(scales(4, torch.tensor([True, True, True, False])), real)
        assert not torch.equal(scales(4), real)

    def test_text_bucket_matches_jax(self, pair):
        want, got = both(pair, "generate_text", ["分析视频", "分析音频"], prompt_len=16, batch_bucket=4,
                         return_tokens=True)
        assert got == want and len(got[0]) == 2


@pytest.mark.parametrize("name", ["segment_note_dfa", "schema_dfa", "validator_dfa", "audit_dfa"])
def test_generate_text_with_analyzer_grammars(name):
    """Each analyzer grammar drives ``generate_text`` to the JAX engine's
    tokens, and every emitted byte is a transition of the grammar."""
    j_engine, engine = engines(grammar=False, max_new_tokens=96, structure_bias=2.0)
    j_dfa, dfa = getattr(j_schema, name)(512), getattr(schema, name)(512)
    np.testing.assert_array_equal(dfa.next_state, j_dfa.next_state)
    prompts = ["评分这份笔记", "审核"]
    want = j_engine.generate_text(prompts, dfa=j_dfa, return_status=True, return_tokens=True)
    got = engine.generate_text(prompts, dfa=dfa, return_status=True, return_tokens=True)
    assert got == want
    for done, row in zip(got[1], got[2]):
        state = dfa.start
        for token in row:
            state = int(dfa.next_state[state, token])
            assert state >= 0
        assert done == (int(dfa.next_state[state, engine.tokenizer.EOS]) == dfa.accept)
