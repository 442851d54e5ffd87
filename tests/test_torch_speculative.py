"""Speculative decoding: the port's draft/verify loop against the JAX
package's, on the CPU.

The cases of ``tests/test_speculative.py`` (but ``TestShardedSpec``: the
port serves on one device) and the speculative cases of
``tests/test_serving_continuous.py`` (but the sharded one) on the port's
engine and batcher, on the JAX tests' configurations: a two-layer target
and a one-layer draft with its own encoder geometry (fewer frames, so its
video-token count differs), the byte vocabulary, float32 compute. The
port's weights are the JAX engine's, through ``weights.from_jax_params``,
so that the JAX bars (completed generations, parsing notes) hold as they
do there, and the port's tokens can be held against JAX's speculative
engine and batcher.

Tolerances: greedy tokens and completion flags exact (float32 on both
sides, so argmax ties cannot flip between frameworks); sampling is checked
for grammar validity, determinism per seed and, for the first-token
marginal over 60 seeds against the plain loop's, within 0.35 (the JAX
test's bound).
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch

import tests.test_serving_continuous as j_serving
import tests.test_speculative as j_spec
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.parallel.serving import ContinuousBatcher as JBatcher
from video_transformer_tpu.parallel.serving import Request as JRequest
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig, get_preset
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.parallel.engine import EngineSession, InferenceEngine
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.weights import from_jax_params, save_npz

torch.set_num_threads(2)

MARGINAL_TOL = 0.35  # first-token marginal, speculative against plain (the JAX test's bound)


def port_config(cfg) -> VLMConfig:
    """The port's copy of a JAX ``VLMConfig``."""
    return VLMConfig(name=cfg.name, encoder=EncoderConfig(**dataclasses.asdict(cfg.encoder)),
                     decoder=DecoderConfig(**dataclasses.asdict(cfg.decoder)), dtype=cfg.dtype)


TARGET, DRAFT = port_config(j_spec.TARGET), port_config(j_spec.DRAFT)
MICRO, MICRO_DRAFT = port_config(j_serving.micro_config()), port_config(j_serving.micro_draft_config())


def note_dfa():
    """``tests/test_speculative.py``'s grammar, built by the port."""
    return (DfaBuilder().literal('{"title": ').free_string(1, 8).literal(', "tags": ').string_list(1, 6)
            .literal("}").finish())


def tiny_dfa():
    """``tests/test_serving_continuous.py``'s grammar, built by the port."""
    return DfaBuilder().literal('{"title": ').free_string(1, 24).literal("}").finish()


def one_device():
    return build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_engine(target=j_spec.TARGET, draft=None, spec_tokens=4, grammar=j_spec.note_dfa, **kwargs):
    engine = JEngine(target, mesh=one_device(), seed=0, compilation_cache_dir=None,
                     dfa=grammar() if grammar else None, **kwargs)
    if draft is not None:
        engine.attach_draft(draft, spec_tokens=spec_tokens)
    return engine


def port_engine(j_engine, target=TARGET, draft=None, spec_tokens=4, grammar=note_dfa, **kwargs) -> InferenceEngine:
    """A port engine on ``j_engine``'s served weights (and its draft's, when
    ``draft`` is given and the JAX engine has one; else seeded weights)."""
    engine = InferenceEngine(target, params=from_jax_params(numpy_tree(j_engine.params), target, device="cpu"),
                             device="cpu", **kwargs)
    engine.dfa = grammar() if grammar else None
    if draft is not None:
        params = None
        if j_engine.draft_params is not None:
            params = from_jax_params(numpy_tree(j_engine.draft_params), draft, device="cpu")
        engine.attach_draft(draft, params=params, spec_tokens=spec_tokens)
    return engine


@pytest.fixture(scope="module")
def spec_pair():
    """(JAX speculative engine, port plain engine, port speculative engine)
    on the same weights, greedy, 96 new tokens."""
    j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=96, temperature=0.0)
    plain = port_engine(j_engine, max_new_tokens=96, temperature=0.0)
    spec = port_engine(j_engine, draft=DRAFT, max_new_tokens=96, temperature=0.0)
    return j_engine, plain, spec


def clip(b=2, t=4, seed=0):
    return j_spec.clip(b, t, seed)


class TestGreedyExactness:
    """Speculative greedy tokens equal the plain loop's and JAX's."""

    def test_text_with_grammar(self, spec_pair):
        j_engine, plain, spec = spec_pair
        prompts = ["analyze the lecture", "second clip"]
        want, want_ok, want_ids = j_engine.generate_text(prompts, return_status=True, return_tokens=True)
        got, got_ok, got_ids = spec.generate_text(prompts, return_status=True, return_tokens=True)
        assert all(want_ok), "bar needs completed generations; raise max_new"
        assert (got, got_ok, got_ids) == (want, want_ok, want_ids)
        assert plain.generate_text(prompts, return_status=True, return_tokens=True) == (got, got_ok, got_ids)

    def test_capped_rows_are_prefixes_of_the_same_stream(self, spec_pair):
        """A token-capped row may cut at another point than the plain loop
        (each overshoots the cap by its own block), but both emit prefixes
        of the same greedy stream."""
        j_engine, plain, _ = spec_pair
        stream = port_engine(j_engine, max_new_tokens=192, temperature=0.0).generate_text(
            ["analyze"], return_tokens=True)[1][0]
        capped = port_engine(j_engine, draft=DRAFT, max_new_tokens=24, temperature=0.0)
        ids = capped.generate_text(["analyze"], return_tokens=True)[1][0]
        assert ids == stream[: len(ids)] and len(ids) >= 24

    def test_video_path(self, spec_pair):
        j_engine, plain, spec = spec_pair
        frames = clip()
        want = j_engine.generate(frames, ["a", "b"], return_status=True, return_tokens=True)
        got = spec.generate(frames, ["a", "b"], return_status=True, return_tokens=True)
        assert got == want and all(got[1])
        assert plain.generate(frames, ["a", "b"], return_status=True, return_tokens=True) == got

    def test_close_bias_applies(self):
        j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=96, temperature=0.0, structure_bias=4.0)
        want = j_engine.generate_text(["x"], return_tokens=True)
        spec = port_engine(j_engine, draft=DRAFT, max_new_tokens=96, temperature=0.0, structure_bias=4.0)
        plain = port_engine(j_engine, max_new_tokens=96, temperature=0.0, structure_bias=4.0)
        assert spec.generate_text(["x"], return_tokens=True) == want == plain.generate_text(["x"], return_tokens=True)

    def test_int8_target(self):
        """The verify's wide forward runs the int8 dense path (the draft
        stays float): tokens equal the plain int8 engine's and the JAX
        speculative engine's."""
        j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=96, temperature=0.0, quantize="int8")
        want, want_ok = j_engine.generate_text(["量化测试"], return_status=True)
        spec = port_engine(j_engine, draft=DRAFT, max_new_tokens=96, temperature=0.0, quantize="int8")
        plain = port_engine(j_engine, max_new_tokens=96, temperature=0.0, quantize="int8")
        assert spec.model.decoder.layer_0.attn.q.kernel.dtype == torch.int8
        assert spec.draft_model.decoder.layer_0.attn.q.kernel.dtype == torch.float32
        got, got_ok = spec.generate_text(["量化测试"], return_status=True)
        assert want_ok[0], "raise max_new: parity bar needs completion"
        assert (got, got_ok) == (want, want_ok) == plain.generate_text(["量化测试"], return_status=True)

    def test_int8_target_video_equals_jax(self):
        j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=96, temperature=0.0, quantize="int8")
        frames = clip(seed=3)
        want = j_engine.generate(frames, ["第一段", "second"], return_status=True, return_tokens=True)
        spec = port_engine(j_engine, draft=DRAFT, max_new_tokens=96, temperature=0.0, quantize="int8")
        assert spec.generate(frames, ["第一段", "second"], return_status=True, return_tokens=True) == want


class TestSelfDraftAcceptance:
    """Draft = target weights: near-total acceptance, far fewer forwards."""

    def test_fewer_target_forwards_same_text(self, spec_pair):
        j_engine, _, _ = spec_pair
        plain = port_engine(j_engine, max_new_tokens=64, temperature=0.0)
        want = plain.generate_text(["describe"], return_tokens=True)[1][0]
        plain_steps = plain.stats.decode_steps
        spec = port_engine(j_engine, max_new_tokens=64, temperature=0.0)
        spec.attach_draft(TARGET, share_target_params=True, spec_tokens=6)
        assert spec.draft_model is spec.model
        got = spec.generate_text(["describe"], return_tokens=True)[1][0]
        n = min(len(got), len(want))
        assert got[:n] == want[:n] and n > 32
        assert spec.stats.decode_steps < plain_steps

    def test_random_draft_still_terminates(self, spec_pair):
        # Every content proposal rejected: still at least one token a cycle.
        spec = port_engine(spec_pair[0], draft=DRAFT, max_new_tokens=16, grammar=None)
        texts = spec.generate_text(["q"])
        assert isinstance(texts[0], str)
        assert spec.stats.decode_steps <= 16


class TestSampling:
    """temperature > 0: rejection sampling keeps the output in the grammar
    and is deterministic per seed."""

    def test_grammar_valid_and_complete(self):
        j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=64, temperature=0.9)
        spec = port_engine(j_engine, draft=DRAFT, max_new_tokens=64, temperature=0.9)
        texts, status = spec.generate_text(["a", "b"], return_status=True)
        assert any(status)
        for text, ok in zip(texts, status):
            if ok:
                assert set(json.loads(text)) == {"title", "tags"}

    def test_seed_determinism(self, spec_pair):
        a = port_engine(spec_pair[0], draft=DRAFT, temperature=0.8, seed=7, max_new_tokens=48)
        b = port_engine(spec_pair[0], draft=DRAFT, temperature=0.8, seed=7, max_new_tokens=48)
        assert a.generate_text(["x"]) == b.generate_text(["x"])

    def test_residual_distribution_matches_target(self):
        """With a random draft of its own, the first-token marginal over 60
        seeds matches the plain engine's within ``MARGINAL_TOL``."""
        grammar = lambda: DfaBuilder().literal('"').free_string(1, 1).literal('"').finish()  # noqa: E731
        j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=8, temperature=1.0, grammar=None)
        p = port_engine(j_engine, grammar=grammar, max_new_tokens=8, temperature=1.0)
        s = port_engine(j_engine, draft=DRAFT, grammar=grammar, max_new_tokens=8, temperature=1.0)
        counts_plain: dict[str, int] = {}
        counts_spec: dict[str, int] = {}
        n = 60
        for seed in range(n):
            p._generator.manual_seed(seed)
            s._generator.manual_seed(seed)
            tp, ts = p.generate_text(["x"])[0], s.generate_text(["x"])[0]
            counts_plain[tp] = counts_plain.get(tp, 0) + 1
            counts_spec[ts] = counts_spec.get(ts, 0) + 1
        for key in set(counts_plain) | set(counts_spec):
            a, b = counts_plain.get(key, 0) / n, counts_spec.get(key, 0) / n
            assert abs(a - b) < MARGINAL_TOL, (key, counts_plain, counts_spec)


class TestSessions:
    def test_session_continuation_matches_long_budget_and_jax(self):
        """A speculative session resumed to completion equals one call with
        the longer budget, and JAX's speculative session round by round."""
        j_long = jax_engine(draft=j_spec.DRAFT, max_new_tokens=96, temperature=0.0)
        want, want_ok = port_engine(j_long, draft=DRAFT, max_new_tokens=96, temperature=0.0).generate_text(
            ["go"], return_status=True)
        j_short = jax_engine(draft=j_spec.DRAFT, max_new_tokens=24, temperature=0.0)
        short = port_engine(j_short, draft=DRAFT, max_new_tokens=24, temperature=0.0)

        def rounds(engine):
            texts, status, ids, session = engine.generate_text(
                ["go"], return_status=True, return_tokens=True, session_rounds=4, return_session=True)
            assert session is not None and session.draft_cache is not None
            out, ok = [(texts[0], ids[0])], status[0]
            while not ok and session.rounds_left > 0:
                tails, done, tail_ids = engine.continue_session(session)
                out.append((tails[0], tail_ids[0]))
                ok = done[0]
            return out, ok

        got, ok = rounds(short)
        assert rounds(j_short) == (got, ok)
        assert ok == want_ok[0] and "".join(text for text, _ in got) == want[0]
        assert short.stats.session_resumes == len(got) - 1 > 0


class TestValidation:
    def test_vocab_mismatch_rejected(self, spec_pair):
        engine = port_engine(spec_pair[0])
        bad = dataclasses.replace(DRAFT, decoder=dataclasses.replace(DRAFT.decoder, vocab_size=640))
        with pytest.raises(ValueError, match="vocab"):
            engine.attach_draft(bad)
        assert engine.draft_model is None

    def test_spec_tokens_bounds(self, spec_pair):
        engine = port_engine(spec_pair[0])
        for k in (1, 17):
            with pytest.raises(ValueError, match="spec_tokens"):
                engine.attach_draft(DRAFT, spec_tokens=k)

    def test_session_does_not_survive_attach_detach(self, spec_pair):
        engine = port_engine(spec_pair[0], max_new_tokens=16)
        *_, session = engine.generate_text(["go"], session_rounds=2, return_session=True)
        engine.attach_draft(DRAFT, spec_tokens=4)
        with pytest.raises(ValueError, match="attach_draft"):
            engine.continue_session(session)

        spec_engine = port_engine(spec_pair[0], draft=DRAFT, max_new_tokens=16)
        *_, spec_session = spec_engine.generate_text(["go"], session_rounds=2, return_session=True)
        spec_engine.detach_draft()
        with pytest.raises(ValueError, match="detach_draft"):
            spec_engine.continue_session(spec_session)

    def test_share_target_params_requires_same_geometry(self, spec_pair):
        engine = port_engine(spec_pair[0])
        with pytest.raises(ValueError, match="geometry"):
            engine.attach_draft(DRAFT, share_target_params=True)
        with pytest.raises(ValueError, match="excludes"):
            engine.attach_draft(TARGET, params=engine.model, share_target_params=True)

    def test_detach_draft_returns_to_the_plain_loop(self, spec_pair):
        j_engine, plain, _ = spec_pair
        engine = port_engine(j_engine, draft=DRAFT, max_new_tokens=96, temperature=0.0)
        engine.detach_draft()
        assert (engine.draft_model, engine.draft_config, engine.spec_tokens) == (None, None, 0)
        assert engine._block_width(engine.dfa) == 3
        assert engine.generate_text(["go"], return_tokens=True) == plain.generate_text(["go"], return_tokens=True)


class TestDraftCheckpoints:
    """``restore_draft`` takes what ``restore`` takes, and refuses an HF
    directory, as JAX's refuses one."""

    def test_npz_params_pt_and_parent(self, spec_pair, tmp_path):
        j_engine = spec_pair[0]
        draft_tree = numpy_tree(j_engine.draft_params)
        leaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                  for path, leaf in jax.tree_util.tree_flatten_with_path(draft_tree)[0]}
        npz = save_npz(tmp_path / "draft.npz", leaves)
        want = port_engine(j_engine, draft=DRAFT, max_new_tokens=48, temperature=0.0)
        want_ids = want.generate_text(["go"], return_tokens=True)
        engine = port_engine(j_engine, max_new_tokens=48, temperature=0.0)
        engine.attach_draft(DRAFT, checkpoint=npz, spec_tokens=4)
        assert engine.generate_text(["go"], return_tokens=True) == want_ids
        state = {name: t.detach().clone() for name, t in want.draft_model.state_dict().items()}
        (tmp_path / "run" / "params_7").mkdir(parents=True)
        torch.save(state, tmp_path / "run" / "params_7" / "params.pt")
        for path in (tmp_path / "run" / "params_7", tmp_path / "run"):
            engine.attach_draft(DRAFT, spec_tokens=4)  # seeded random weights first
            engine.restore_draft(path)
            assert engine.generate_text(["go"], return_tokens=True) == want_ids

    def test_refusals(self, spec_pair, tmp_path):
        engine = port_engine(spec_pair[0])
        with pytest.raises(ValueError, match="attach_draft before restore_draft"):
            engine.restore_draft(tmp_path)
        engine.attach_draft(DRAFT, spec_tokens=4)
        (tmp_path / "model.safetensors.index.json").write_text("{}")
        with pytest.raises(ValueError, match="HF safetensors"):
            engine.restore_draft(tmp_path)
        with pytest.raises(FileNotFoundError):
            engine.restore_draft(tmp_path / "missing.npz")
        with pytest.raises(FileNotFoundError):
            engine.attach_draft(DRAFT, checkpoint=tmp_path / "nothing_here")

    def test_trained_tiny_draft_for_a_bpe_target(self):
        """The shipped pairing's shapes: the committed tiny ``.npz`` drafts
        for a target of the BPE vocabulary; served bf16 under ``param_dtype``
        and never quantized."""
        from pathlib import Path

        from video_transformer_tpu_torch.models.bpe import BpeTokenizer

        repo = Path(__file__).resolve().parents[1]
        tok = BpeTokenizer.load(repo / "data" / "tokenizers" / "bpe-zh-2048.json")
        cfg = get_preset("tiny")
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, vocab_size=tok.vocab_size))
        engine = InferenceEngine(cfg, tokenizer=tok, param_dtype="bfloat16", quantize="int8", max_new_tokens=8,
                                 device="cpu")
        engine.attach_draft(cfg, checkpoint=repo / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz")
        assert engine.spec_tokens == 6
        kernel = engine.draft_model.decoder.layer_0.mlp.down.kernel
        assert kernel.dtype == torch.bfloat16 and engine.model.decoder.layer_0.mlp.down.kernel.dtype == torch.int8


class TestEngineSizing:
    def test_block_width_prompt_bucket_and_prefix_check_count_spec_tokens(self, spec_pair):
        _, plain, spec = spec_pair
        assert plain._block_width(plain.dfa) == 3 and spec._block_width(spec.dfa) == 4
        engine = port_engine(spec_pair[0], draft=DRAFT, spec_tokens=16, max_new_tokens=96)
        assert engine._block_width(None) == 16
        # The bucket's ceiling reserves 2 x max(1 + max_forced_run, spec_tokens).
        long_prompt = ["x" * 2000]
        assert engine._prompt_bucket(long_prompt, with_video=False) == \
            ((1024 - 96 - 2 * 16 - 17) // 128) * 128
        assert plain._prompt_bucket(long_prompt, with_video=False) == ((1024 - 96 - 2 * 3 - 17) // 128) * 128

    def test_caches_are_per_model_and_in_the_compute_dtype(self, spec_pair, caplog, monkeypatch):
        """Both caches follow the compute dtype whatever ``kv_quant`` says
        (as JAX's speculative program makes them); ``kv_quant`` is logged
        as unused; each cache is sized by its own model's video tokens. The
        logger propagates to caplog here whatever an earlier test in the
        same worker set up (the CLI and training tests' logger setup turns
        propagation off)."""
        monkeypatch.setattr(logging.getLogger("video_transformer"), "propagate", True)
        engine = port_engine(spec_pair[0], max_new_tokens=16, kv_quant="int8")
        with caplog.at_level(logging.INFO, logger="video_transformer"):
            engine.attach_draft(DRAFT, spec_tokens=4)
        assert any("event=draft_kv_quant_unused" in r.getMessage() for r in caplog.records)
        *_, session = engine.generate(clip(), ["a", "b"], session_rounds=1, return_session=True)
        assert isinstance(session, EngineSession)
        assert session.cache["k"][0].dtype == torch.float32 and session.draft_cache["k"][0].dtype == torch.float32
        prompt = 128
        assert session.cache["k"][0].shape[2] == engine._cache_len(prompt, True, engine.dfa, 1)
        assert session.draft_cache["k"][0].shape[2] == engine._cache_len(prompt, True, engine.dfa, 1, DRAFT)
        assert TARGET.video_tokens != DRAFT.video_tokens

    def test_draft_patches_resample_frames(self, spec_pair):
        engine = port_engine(spec_pair[0], draft=DRAFT)
        frames = clip(b=1, t=4)
        patches = engine._draft_patches(frames)
        want = engine._draft_patches(frames[:, [0, 3]])
        assert torch.equal(patches, want) and patches.shape[1] == DRAFT.encoder.tokens_per_clip


class TestSpeculativeBatching:
    """The batcher's speculative cycle over both paged pools."""

    @pytest.fixture(scope="class")
    def micro(self):
        return jax_engine(j_serving.micro_config(), draft=j_serving.micro_draft_config(), grammar=j_serving.tiny_dfa,
                          max_new_tokens=96, temperature=0.0)

    def test_greedy_spec_batcher_matches_plain_engine_and_jax(self, micro):
        """The spec batcher reproduces the plain engine's run-to-completion
        tokens (the random draft mispredicts nearly everything: the
        rejection path is what is pinned) and the JAX spec batcher's."""
        frames = np.random.default_rng(33).integers(0, 255, (2, 4, 32, 32, 3), dtype=np.uint8)
        prompts = ["分析第一段", "analyze the second clip in detail"]
        plain = port_engine(micro, MICRO, grammar=tiny_dfa, max_new_tokens=96, temperature=0.0)
        _, _, plain_ids = plain.generate(frames, prompts, return_status=True, return_tokens=True)
        engine = port_engine(micro, MICRO, draft=MICRO_DRAFT, grammar=tiny_dfa, max_new_tokens=96, temperature=0.0)
        batcher = ContinuousBatcher(engine, slots=2, prompt_len=256, chunk_steps=8)
        assert batcher.spec and batcher.spec_k == 4 and batcher.step_width == 4
        assert batcher.draft_park_len == MICRO_DRAFT.video_tokens + 256 != batcher.park_len
        for i in range(2):
            batcher.submit(Request(i, frames[i], prompts[i]))
        by_id = {c.request_id: c for c in batcher.run()}
        assert [by_id[0].token_ids, by_id[1].token_ids] == plain_ids

        j_batcher = JBatcher(micro, slots=2, prompt_len=256, chunk_steps=8)
        for i in range(2):
            j_batcher.submit(JRequest(i, frames[i], prompts[i]))
        want = {c.request_id: (c.token_ids, c.complete) for c in j_batcher.run()}
        assert {i: (c.token_ids, c.complete) for i, c in by_id.items()} == want

    def test_spec_refills_more_requests_than_slots(self, micro):
        """6 requests through 2 slots: every completion parses, so refills
        adopted both pools' state (a stale draft index would desync the
        proposals and stall the grammar)."""
        engine = port_engine(micro, MICRO, draft=MICRO_DRAFT, grammar=tiny_dfa, max_new_tokens=96, temperature=1.0)
        batcher = ContinuousBatcher(engine, slots=2, prompt_len=16, chunk_steps=8)
        for request in j_serving.make_requests(6, seed=5):
            batcher.submit(Request(request.request_id, request.frames, request.prompt))
        results = batcher.run()
        assert sorted(c.request_id for c in results) == list(range(6))
        for completion in results:
            assert completion.complete
            assert set(json.loads(completion.text)) == {"title"}

    def test_spec_requires_device_refill(self, micro):
        engine = port_engine(micro, MICRO, draft=MICRO_DRAFT, grammar=tiny_dfa, max_new_tokens=16)
        with pytest.raises(ValueError, match="device_refill"):
            ContinuousBatcher(engine, slots=2, prompt_len=16, device_refill=False)
        batcher = ContinuousBatcher(engine, slots=2, prompt_len=16)
        batcher.submit(Request(0, j_serving.make_requests(1)[0].frames, "x"))
        with pytest.raises(RuntimeError, match="device ring"):
            batcher._fill_slots()
