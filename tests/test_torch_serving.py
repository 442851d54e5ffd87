"""The continuous batcher: the port's ``ContinuousBatcher`` against the JAX
package's, on the CPU.

Both batchers serve the tiny preset in float32 with the BPE vocabulary and
the same weights (the JAX engine's variables, through
``weights.from_jax_params``). A short note grammar with the closer bias
(``structure_bias=1.5``) makes rows finish at different steps, so slots are
refilled mid-flight. The JAX batcher runs on a one-device mesh
(``tests/conftest.py`` forces eight CPU devices). Decoding is greedy and
float32, so token ids, token counts and ``complete`` flags must be equal
per request; the port's K4 and K5 run their plain versions here.
"""

from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_transformer_tpu.models.bpe import BpeTokenizer as JBpe
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.ops.constrained import DfaBuilder as JDfaBuilder
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.parallel.serving import ContinuousBatcher as JBatcher
from video_transformer_tpu.parallel.serving import Request as JRequest
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

TOKENIZER = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json"
MAX_NEW = 40
PROMPTS = ["分析这个视频", "summarize the lecture", "第三段", "a much longer prompt " * 10, "x"]


def short_note(builder_cls):
    return (
        builder_cls().literal('{"title": ').free_string(2, 12).literal(', "summary": ')
        .free_string(2, 12).literal("}").finish()
    )


def long_note(builder_cls):
    """A grammar no row can finish within 32 tokens."""
    return builder_cls().literal('{"long": ').free_string(200, 400).literal("}").finish()


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same tiny float32 weights."""
    j_tok = JBpe.load(TOKENIZER)
    j_cfg = j_get_preset("tiny")
    j_cfg = replace(j_cfg, dtype="float32", decoder=replace(j_cfg.decoder, vocab_size=j_tok.vocab_size))
    j_engine = JEngine(
        j_cfg, mesh=build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1]), max_new_tokens=MAX_NEW,
        temperature=0.0, tokenizer=j_tok, structure_bias=1.5, compilation_cache_dir=None,
    )
    tok = BpeTokenizer.load(TOKENIZER)
    cfg = get_preset("tiny")
    cfg = replace(cfg, dtype="float32", decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), cfg, device="cpu")
    engine = InferenceEngine(cfg, tokenizer=tok, params=params, max_new_tokens=MAX_NEW, temperature=0.0,
                             structure_bias=1.5, device="cpu")
    return j_engine, engine


def use_grammar(engines, builder):
    j_engine, engine = engines
    j_engine.dfa = j_engine.wrap_grammar(builder(JDfaBuilder))
    engine.dfa = engine.wrap_grammar(builder(DfaBuilder))


def clips(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 4, 64, 64, 3), dtype=np.uint8)


def serve(batcher_cls, request_cls, engine, frames, prompts, priorities=None, **kwargs):
    """Submit one request per clip; returns {request_id: (ids, tokens,
    complete)} and the completion order."""
    batcher = batcher_cls(engine, **kwargs)
    for i, clip in enumerate(frames):
        batcher.submit(request_cls(i, clip, prompts[i % len(prompts)], priority=(priorities or {}).get(i, 0)))
    order = []
    results = {}
    for c in batcher.run(on_complete=lambda c: order.append(c.request_id)):
        results[c.request_id] = (c.token_ids, c.tokens, c.complete)
    return results, order


@pytest.fixture(scope="module")
def jax_results(engines):
    """The JAX batcher's greedy results for five requests through two
    slots, per refill mode (computed once)."""
    use_grammar(engines, short_note)
    return {
        refill: serve(JBatcher, JRequest, engines[0], clips(5), PROMPTS, slots=2, prompt_len=256, chunk_steps=8,
                      device_refill=refill)[0]
        for refill in (True, False)
    }


@pytest.mark.parametrize("device_refill", [True, False], ids=["device_refill", "host_driven"])
def test_tokens_equal_jax_batcher(engines, jax_results, device_refill):
    """Per request: the same token ids, token count and complete flag as the
    JAX batcher in the same refill mode."""
    use_grammar(engines, short_note)
    got, _ = serve(ContinuousBatcher, Request, engines[1], clips(5), PROMPTS, slots=2, prompt_len=256,
                   chunk_steps=8, device_refill=device_refill)
    want = jax_results[device_refill]
    assert got == want
    assert len({n for _, n, _ in want.values()}) > 1, "rows should finish at different steps"
    assert any(done for _, _, done in want.values())


def test_tokens_equal_engine_generate(engines):
    """Parked prefill, paged adoption, refills and the chunked loop give
    ``engine.generate``'s run-to-completion tokens."""
    use_grammar(engines, short_note)
    engine = engines[1]
    frames = clips(5, seed=21)
    _, _, want = engine.generate(frames, PROMPTS, return_status=True, return_tokens=True)
    got, _ = serve(ContinuousBatcher, Request, engine, frames, PROMPTS, slots=2, prompt_len=256, chunk_steps=8)
    assert [got[i][0] for i in range(5)] == want


def test_priority_order_as_in_jax(engines):
    """One slot: a late high-priority request is served first, FIFO after."""
    use_grammar(engines, short_note)
    kwargs = dict(slots=1, prompt_len=16, chunk_steps=8, priorities={3: 5})
    want, want_order = serve(JBatcher, JRequest, engines[0], clips(4, seed=2), PROMPTS, **kwargs)
    got, order = serve(ContinuousBatcher, Request, engines[1], clips(4, seed=2), PROMPTS, **kwargs)
    assert want_order == [3, 0, 1, 2]
    assert order == want_order and got == want


def test_ring_overflow_stages_in_rounds_as_in_jax(engines):
    """Nine requests through a ring of three: the host restages between
    chunks, every request completes once, with the JAX batcher's tokens."""
    use_grammar(engines, short_note)
    kwargs = dict(slots=2, prompt_len=16, chunk_steps=8, queue_depth=3)
    want, _ = serve(JBatcher, JRequest, engines[0], clips(9, seed=5), PROMPTS, **kwargs)
    batcher = ContinuousBatcher(engines[1], **kwargs)
    for i, clip in enumerate(clips(9, seed=5)):
        batcher.submit(Request(i, clip, PROMPTS[i % len(PROMPTS)]))
    stages = []
    stage = batcher._stage

    def counted_stage():
        before = batcher._staged_total
        stage()
        stages.append(batcher._staged_total - before)

    batcher._stage = counted_stage
    got = {c.request_id: (c.token_ids, c.tokens, c.complete) for c in batcher.run()}
    assert got == want and sorted(got) == list(range(9))
    assert [n for n in stages if n] == [3, 3, 3]


def test_token_budget_exhaustion_as_in_jax(engines):
    """A grammar that cannot finish within the budget: complete=False for
    every request, the JAX batcher's tokens."""
    use_grammar(engines, long_note)
    kwargs = dict(slots=2, prompt_len=16, chunk_steps=8, max_new_tokens=32)
    want, _ = serve(JBatcher, JRequest, engines[0], clips(3, seed=1), PROMPTS, **kwargs)
    got, _ = serve(ContinuousBatcher, Request, engines[1], clips(3, seed=1), PROMPTS, **kwargs)
    assert got == want
    assert all(not done and n == 32 for _, n, done in got.values())


def test_host_fill_uses_per_request_prompt_bucket(engines):
    """A slot prefilled through the host path starts decoding at
    video_tokens + its own 128-multiple bucket, and the device loop adopts
    it: both requests complete with ``engine.generate``'s tokens."""
    use_grammar(engines, short_note)
    engine = engines[1]
    frames = clips(2, seed=3)
    prompts = ["短提示", "长提示 " * 60]
    batcher = ContinuousBatcher(engine, slots=2, prompt_len=256, chunk_steps=8)
    for i in range(2):
        batcher.submit(Request(i, frames[i], prompts[i]))
    batcher._fill_slots()
    assert batcher.cache["index"].tolist() == [engine.config.video_tokens + 128, engine.config.video_tokens + 256]
    got = {c.request_id: c.token_ids for c in batcher.run()}
    _, want = engine.generate(frames, prompts, return_tokens=True)
    assert [got[0], got[1]] == want


def test_adaptive_chunks_and_empty_run(engines):
    use_grammar(engines, short_note)
    batcher = ContinuousBatcher(engines[1], slots=2, prompt_len=16, chunk_steps=8, latency_steps=3,
                                device_refill=False)
    assert batcher.run() == []
    assert batcher._next_chunk_steps() == 8
    batcher.submit(Request(0, clips(1)[0], "x"))
    assert batcher._next_chunk_steps() == 3
    assert [c.request_id for c in batcher.run()] == [0]
    assert batcher._next_chunk_steps() == 8


def test_cache_sizing_and_pool(engines):
    """The JAX batcher's cache sizing; a bf16 engine's pool is bf16 with
    ``slots + queue_depth`` rows and a rows table, whatever its KV quant."""
    use_grammar(engines, short_note)
    j_batcher = JBatcher(engines[0], slots=2, prompt_len=256)
    batcher = ContinuousBatcher(engines[1], slots=2, prompt_len=256)
    assert (batcher.cache_len, batcher.park_len, batcher.out_width, batcher.total_rows) == (
        j_batcher.cache_len, j_batcher.park_len, j_batcher.out_width, j_batcher.total_rows)
    tok = engines[1].tokenizer
    cfg = get_preset("tiny")
    engine = InferenceEngine(replace(cfg, decoder=replace(cfg.decoder, vocab_size=tok.vocab_size)), tokenizer=tok,
                             param_dtype="bfloat16", quantize="int8", kv_quant="int8", device="cpu")
    pool = ContinuousBatcher(engine, slots=3, queue_depth=5).cache
    assert pool["k"][0].dtype == torch.bfloat16 and pool["k"][0].shape[0] == 8
    assert pool["rows"].tolist() == [0, 1, 2]
