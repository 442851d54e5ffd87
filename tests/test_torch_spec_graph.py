"""The speculative loop as cycles of a fixed carry, in chunks (CPU).

On one card the engine and the batcher replay CUDA graphs of whole
draft/verify cycles and read the device once a chunk (``parallel/graphs.py``);
on the CPU the same cycle functions run eagerly in the same chunks. Here the
chunked loop is held against the JAX package's compiled speculative loop
(``run_spec``) on ``tests/test_speculative.py``'s configurations (a two-layer
target, a one-layer draft with its own encoder geometry, the byte vocabulary,
float32, greedy): tokens, completion flags and cycles must be equal, at chunk
sizes 1, 3 and ``SPEC_CHUNK``, with rows that complete at different cycles,
rows cut by the token budget, a self-draft that accepts every proposal, and
the video path. Then the stream at temperature 0.7, sessions round for round
against JAX's resume, the batcher's speculative refill loop against the JAX
batcher, a chunk with every host read refused, the graph key and what drops
it, and the graph route's control flow with a stand-in for the CUDA graph
(nothing here can capture one).

Tolerances: tokens, flags and cycle counts exact (float32 on both sides).
"""

import pytest
import torch

import tests.test_serving_continuous as j_serving
import tests.test_speculative as j_spec
from tests.test_torch_speculative import (
    DRAFT,
    MICRO,
    MICRO_DRAFT,
    TARGET,
    clip,
    jax_engine,
    port_engine,
    tiny_dfa,
)
from video_transformer_tpu.parallel.serving import ContinuousBatcher as JBatcher
from video_transformer_tpu.parallel.serving import Request as JRequest
from video_transformer_tpu_torch.parallel import engine as engine_module
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request

torch.set_num_threads(2)

PROMPTS = ["analyze the lecture", "second clip"]
CHUNKS = [1, 3, engine_module.SPEC_CHUNK]
# name -> (draft, max_new, video): the tiny random draft (rows complete at
# different cycles), the same cut by the token budget mid-document, a
# self-draft (every proposal accepted), and the video path.
CASES = {"note": ("draft", 96, False), "capped": ("draft", 20, False), "self": ("self", 96, False),
         "video": ("draft", 96, True)}


def run(engine, video: bool, **kwargs):
    if video:
        return engine.generate(clip(), ["a", "b"], return_status=True, return_tokens=True, **kwargs)
    return engine.generate_text(PROMPTS, return_status=True, return_tokens=True, **kwargs)


def port_of(j_engine, draft: str, max_new: int, temperature: float = 0.0, **kwargs):
    """The port's speculative engine on ``j_engine``'s weights: the tiny
    random draft, or a self-draft."""
    if draft == "self":
        engine = port_engine(j_engine, max_new_tokens=max_new, temperature=temperature, **kwargs)
        engine.attach_draft(TARGET, share_target_params=True, spec_tokens=4)
        return engine
    return port_engine(j_engine, draft=DRAFT, max_new_tokens=max_new, temperature=temperature, **kwargs)


def pair(draft: str, max_new: int, temperature: float = 0.0, **kwargs):
    """A JAX speculative engine and the port's on its weights."""
    if draft == "self":
        j_engine = jax_engine(max_new_tokens=max_new, temperature=temperature, **kwargs)
        j_engine.attach_draft(j_spec.TARGET, share_target_params=True, spec_tokens=4)
    else:
        j_engine = jax_engine(draft=j_spec.DRAFT, max_new_tokens=max_new, temperature=temperature, **kwargs)
    return j_engine, port_of(j_engine, draft, max_new, temperature, **kwargs)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX engine, its greedy output and its loop's cycles."""
    runs = {}
    for name, (draft, max_new, video) in CASES.items():
        j_engine, _ = pair(draft, max_new)
        runs[name] = (j_engine, run(j_engine, video), j_engine.stats.decode_steps)
    return runs


def port_for(j_engine, name: str):
    return port_of(j_engine, *CASES[name][:2])


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_spec_loop_equals_jax(jax_runs, monkeypatch, name, chunk):
    """Tokens, completion flags and cycles equal JAX's ``run_spec``; the
    last chunk runs idle cycles past the loop's end, which change nothing."""
    monkeypatch.setattr(engine_module, "SPEC_CHUNK", chunk)
    j_engine, want, want_cycles = jax_runs[name]
    engine = port_for(j_engine, name)
    assert engine._decode_route() == "chunked"
    assert run(engine, CASES[name][2]) == want
    assert engine.stats.decode_steps == want_cycles and engine.stats.decode_route == "eager"
    assert engine.stats.idle_steps == -(-want_cycles // chunk) * chunk - want_cycles
    lengths = [len(ids) for ids in want[2]]
    if name == "capped":
        assert not any(want[1]) and min(lengths) >= CASES[name][1]
    else:
        assert all(want[1]) and len(set(lengths)) > 1, "rows should complete at different cycles"
    if name == "self":
        assert 2 * want_cycles < max(lengths)  # most proposals accepted


@pytest.mark.parametrize("chunk", [3, engine_module.SPEC_CHUNK])
def test_sampling_stream_continues_as_the_per_cycle_loop(monkeypatch, chunk):
    """At temperature 0.7 from one seed the chunked loop draws the
    per-cycle loop's tokens and leaves the generator where it does (the
    idle cycles' draws are taken back), so that the next call draws the
    same too."""
    monkeypatch.setattr(engine_module, "SPEC_CHUNK", chunk)
    _, engine = pair("draft", 48, temperature=0.7)
    outs = []
    for plain in (True, False):
        engine._plain_decode = plain
        engine._generator.manual_seed(5)
        first = run(engine, False)
        state = engine._generator.get_state()
        outs.append((first, state, run(engine, True)))
    assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2]
    assert torch.equal(outs[0][1], outs[1][1])
    assert engine.stats.idle_steps > 0


def session_rounds(engine, **kwargs):
    """A session's rounds, resumed until every row completes: each round's
    (texts, flags, ids)."""
    texts, status, ids, session = engine.generate_text(
        PROMPTS, return_status=True, return_tokens=True, session_rounds=4, return_session=True, **kwargs)
    assert session is not None and session.draft_cache is not None
    rounds = [(texts, status, ids)]
    while not all(rounds[-1][1]) and session.rounds_left > 0:
        rounds.append(engine.continue_session(session))
    return rounds, session


@pytest.mark.parametrize("chunk", [1, 3])
def test_spec_session_rounds_equal_jax(monkeypatch, chunk):
    """A speculative session's rounds in chunks give JAX's resumed rounds
    round for round, and the session's carry advances in place."""
    monkeypatch.setattr(engine_module, "SPEC_CHUNK", chunk)
    j_engine, engine = pair("draft", 24)
    want, _ = session_rounds(j_engine)
    logits_seen = []
    execute = engine._decode

    def decode(logits, *args):
        logits_seen.append(logits)
        return execute(logits, *args)

    monkeypatch.setattr(engine, "_decode", decode)
    got, session = session_rounds(engine)
    assert got == want and len(got) > 1
    assert all(t is session.logits for t in logits_seen[1:])
    assert engine.stats.session_resumes == len(got) - 1


def test_spec_batcher_refill_loop_equals_jax():
    """Five requests through two slots, a refill every 3 cycles: the port
    batcher's speculative refill loop gives the JAX batcher's tokens, and so
    does its plain loop."""
    micro = jax_engine(j_serving.micro_config(), draft=j_serving.micro_draft_config(), grammar=j_serving.tiny_dfa,
                       max_new_tokens=40, temperature=0.0)
    engine = port_engine(micro, MICRO, draft=MICRO_DRAFT, grammar=tiny_dfa, max_new_tokens=40, temperature=0.0)
    requests = j_serving.make_requests(5, seed=3)
    kwargs = dict(slots=2, prompt_len=16, chunk_steps=8, refill_period=3)

    def serve(batcher_cls, request_cls, e):
        batcher = batcher_cls(e, **kwargs)
        for r in requests:
            batcher.submit(request_cls(r.request_id, r.frames, r.prompt))
        return {c.request_id: (c.token_ids, c.tokens, c.complete) for c in batcher.run()}, batcher

    want, _ = serve(JBatcher, JRequest, micro)
    got, batcher = serve(ContinuousBatcher, Request, engine)
    assert got == want and sorted(got) == list(range(5))
    assert batcher.spec and batcher.stats.decode_route == "eager"
    engine._plain_decode = True
    assert serve(ContinuousBatcher, Request, engine)[0] == want


class Refused(AssertionError):
    pass


def refuse_host_reads(monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise Refused("a speculative cycle read the device")

    for name in ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_a_spec_chunk_reads_nothing_on_the_host(monkeypatch, temperature):
    """A chunk of the engine's speculative cycles and of the batcher's, with
    every host read of a tensor refused: the cycle functions read nothing
    on the host (at 0.7 the draws and the rejection sampling too)."""
    _, engine = pair("draft", 24, temperature=temperature)
    dfa = engine.dfa
    with torch.no_grad():
        tokens = torch.full((2, 128), 0, dtype=torch.long)
        tokens[:, :3] = torch.tensor([1, 97, 98])
        lengths = torch.tensor([3, 3], dtype=torch.int32)
        cache = engine_module.init_kv_cache(TARGET.decoder, 2, 512, torch.float32, device="cpu")
        logits, cache = engine.model.prefill_text(tokens, cache, lengths)
        draft_cache = engine_module.init_kv_cache(DRAFT.decoder, 2, 512, torch.float32, device="cpu")
        _, draft_cache = engine.draft_model.prefill_text(tokens, draft_cache, lengths)
        state = torch.full((2,), dfa.start, dtype=torch.long)
        logp = engine._process(logits, state, dfa, engine._table_for(dfa), None)
    carry = engine._new_carry(logp, cache, state, torch.zeros(2, dtype=torch.bool), dfa, draft_cache)
    carry.tokens.fill_(engine.tokenizer.EOS)
    carry.out_pos.zero_()
    carry.step.zero_()
    carry.go.fill_(True)
    indices = (cache["index"], draft_cache["index"])
    micro = jax_engine(j_serving.micro_config(), draft=j_serving.micro_draft_config(), grammar=j_serving.tiny_dfa,
                       max_new_tokens=16, temperature=temperature)
    batcher = ContinuousBatcher(port_engine(micro, MICRO, draft=MICRO_DRAFT, grammar=tiny_dfa, max_new_tokens=16,
                                            temperature=temperature), slots=2, prompt_len=16)
    request = j_serving.make_requests(1)[0]
    batcher.submit(Request(0, request.frames, request.prompt))
    batcher._stage()
    batcher._refill_one(torch.zeros((1,), dtype=torch.long))
    carried = (batcher.logits, batcher.state, batcher.done, batcher.out_pos, batcher.cache["index"],
               batcher.dcache["index"])
    with monkeypatch.context() as patched:
        refuse_host_reads(patched)
        with pytest.raises(Refused):
            bool(carry.go)
        with torch.no_grad():
            for _ in range(engine_module.SPEC_CHUNK):
                engine._spec_step(carry)
            for _ in range(3):
                batcher._step()
    assert int(carry.step) == engine_module.SPEC_CHUNK and bool(carry.go)
    assert cache["index"] is indices[0] and draft_cache["index"] is indices[1]  # the caches keep their tensors
    assert int(carry.out_pos.min()) >= engine_module.SPEC_CHUNK
    assert int(cache["index"][0]) == 3 + int(carry.out_pos[0]) and int(draft_cache["index"][0]) == 3 + int(
        carry.out_pos[0])
    assert all(now is then for now, then in zip((batcher.logits, batcher.state, batcher.done, batcher.out_pos,
                                                 batcher.cache["index"], batcher.dcache["index"]), carried))
    assert int(batcher.out_pos[0]) >= 3


def test_idle_cycles_change_nothing_read_later():
    """Cycles with ``go`` false freeze every row: ``out_pos``, both cache
    indices, the grammar state, the finished rows and ``logp`` stay as
    they were, and their writes stay inside both caches' tail slack."""
    _, engine = pair("draft", 24)
    with torch.no_grad():
        b, cache_len = 2, engine._cache_len(128, False, engine.dfa, 0)
        draft_len = engine._cache_len(128, False, engine.dfa, 0, DRAFT)
        cache = engine_module.init_kv_cache(TARGET.decoder, b, cache_len, torch.float32, device="cpu")
        draft_cache = engine_module.init_kv_cache(DRAFT.decoder, b, draft_len, torch.float32, device="cpu")
        # Each row at its furthest live index: the prompt bucket and the
        # budget overshot by a block less one.
        last = 128 + engine.max_new_tokens + engine.spec_tokens - 1
        cache["index"].fill_(last)
        draft_cache["index"].fill_(last)
        logp = torch.log_softmax(torch.randn(b, TARGET.decoder.vocab_size), dim=-1)
        state = torch.full((b,), engine.dfa.start, dtype=torch.long)
        c = engine._new_carry(logp.clone(), cache, state.clone(), torch.zeros(b, dtype=torch.bool), engine.dfa,
                              draft_cache)
        c.tokens.fill_(engine.tokenizer.EOS)
        c.out_pos.fill_(engine.max_new_tokens + engine.spec_tokens - 1)
        c.step.fill_(7)
        c.go.fill_(False)
        before = [t.clone() for t in (c.logits, c.state, c.finished, c.out_pos, c.step, cache["index"],
                                      draft_cache["index"])]
        for _ in range(3):
            engine._spec_step(c)
    after = (c.logits, c.state, c.finished, c.out_pos, c.step, cache["index"], draft_cache["index"])
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert last + engine.spec_tokens <= min(cache_len, draft_len)
    assert not bool(c.go)


def test_spec_graph_key_and_what_drops_it():
    """A speculative key adds the draft cache's length to the plain key:
    its entry owns a target cache in the compute dtype (whatever
    ``kv_quant`` says) and a draft cache of the draft's geometry. Assigning
    ``spec_tokens``, attaching, detaching or restoring the draft (which
    assigns its model) drops the graphs."""
    _, engine = pair("draft", 24, kv_quant="int8")
    dfa = engine.dfa
    plain = engine._graph_entry(2, 512, dfa)
    spec = engine._graph_entry(2, 512, dfa, 384)
    assert spec is not plain and engine._graph_entry(2, 512, dfa, 384) is spec
    assert plain.carry.draft_cache is None and plain.carry.cache["k"][0].dtype == torch.int8
    assert spec.carry.cache["k"][0].dtype == torch.float32 and "k_scale" not in spec.carry.cache
    assert spec.carry.draft_cache["k"][0].shape == (2, DRAFT.decoder.num_kv_heads, 384, DRAFT.decoder.head_dim)
    assert len(spec.carry.draft_cache["k"]) == DRAFT.decoder.num_layers and spec.carry.cols.shape == (1, 4)
    assert engine._graph_entry(2, 512, dfa, 512) is not spec
    draft_model = engine.draft_model
    for assign in (
        lambda: setattr(engine, "spec_tokens", 3), lambda: engine.attach_draft(DRAFT, spec_tokens=4),
        lambda: setattr(engine, "draft_model", draft_model),
        lambda: engine.attach_draft(TARGET, share_target_params=True, spec_tokens=4), lambda: engine.detach_draft(),
    ):
        engine._graph_entry(2, 512, dfa, 384)
        assign()
        assert not engine._graphs


class Replayed:
    """A stand-in for ``StepGraph`` on the CPU: a capture records the step,
    a replay runs it ``n`` times eagerly."""

    captured = 0

    def __init__(self, step, n, pool, counters=(), generators=(), mesh=None):
        self.step, self.n, self.seconds = step, n, 0.0
        Replayed.captured += 1

    def replay(self):
        for _ in range(self.n):
            self.step()


class Pool:
    def warm(self, fn):
        fn()


def graph_route(monkeypatch, engine) -> list[bool]:
    """Take the graph route on the CPU (``Replayed``, ``Pool``); returns a
    record, one a cache copy into or out of a key, of whether it copied
    k/v (a cache of its own) or only the index (the key's own, prefilled
    in place)."""
    monkeypatch.setattr(engine_module, "StepGraph", Replayed)
    monkeypatch.setattr(engine, "_decode_route", lambda: "graph")
    engine._graph_pool = Pool()
    copies = []
    copy_cache = engine_module._copy_cache

    def recorded(dst, src):
        copies.append(any(d is not s for d, s in zip(dst["k"], src["k"])))
        copy_cache(dst, src)

    monkeypatch.setattr(engine_module, "_copy_cache", recorded)
    return copies


@pytest.mark.parametrize("name", ["note", "video"])
def test_graph_route_equals_jax(jax_runs, monkeypatch, name):
    """The graph route's control flow on the CPU: a key's first chunk warms
    up, the next is captured, the rest replay; the tokens, flags and cycles
    are JAX's, and a call without a session prefills straight into the
    key's caches (its copies move only the indices)."""
    j_engine, want, want_cycles = jax_runs[name]
    engine = port_for(j_engine, name)
    copies = graph_route(monkeypatch, engine)
    for _ in range(2):
        assert run(engine, CASES[name][2]) == want
    assert engine.stats.decode_route == "graph" and engine.stats.graphs_captured == 1
    # The first call's first chunk is the warm-up, the second call replays every chunk.
    assert engine.stats.replays == 2 * (-(-want_cycles // engine_module.SPEC_CHUNK)) - 1
    assert engine.stats.decode_steps == 2 * want_cycles
    assert len(copies) == 8 and not any(copies)  # both caches in and out, twice: indices only
    (key,) = engine._graphs
    assert key[-1] == engine._cache_len(128, name == "video", engine.dfa, 0, DRAFT)


def test_graph_route_session_equals_jax(monkeypatch):
    """A session on the graph route: each round copies both of its caches
    into the key's and back, and the rounds are JAX's."""
    j_engine, engine = pair("draft", 24)
    want, _ = session_rounds(j_engine)
    copies = graph_route(monkeypatch, engine)
    got, session = session_rounds(engine)
    assert got == want and len(got) > 1
    assert engine.stats.decode_route == "graph"
    assert copies == [True] * 4 * len(got)
    assert session.cache["k"][0] is not next(iter(engine._graphs.values())).carry.cache["k"][0]


def test_batcher_spec_graph_route_equals_jax(monkeypatch):
    """The batcher's speculative refill periods on the graph route (the
    stand-ins above): the first period of a key warms up, the second is
    captured, the rest replay, and the tokens are the JAX batcher's."""
    from video_transformer_tpu_torch.parallel import serving as serving_module

    micro = jax_engine(j_serving.micro_config(), draft=j_serving.micro_draft_config(), grammar=j_serving.tiny_dfa,
                       max_new_tokens=40, temperature=0.0)
    engine = port_engine(micro, MICRO, draft=MICRO_DRAFT, grammar=tiny_dfa, max_new_tokens=40, temperature=0.0)
    requests = j_serving.make_requests(5, seed=3)
    kwargs = dict(slots=2, prompt_len=16, chunk_steps=8, refill_period=3)
    j_batcher = JBatcher(micro, **kwargs)
    batcher = ContinuousBatcher(engine, **kwargs)
    monkeypatch.setattr(serving_module, "StepGraph", Replayed)
    engine._graph_pool = Pool()
    batcher._graphed = True
    for r in requests:
        j_batcher.submit(JRequest(r.request_id, r.frames, r.prompt))
        batcher.submit(Request(r.request_id, r.frames, r.prompt))
    want = {c.request_id: (c.token_ids, c.complete) for c in j_batcher.run()}
    assert {c.request_id: (c.token_ids, c.complete) for c in batcher.run()} == want
    assert batcher.stats.graphs_captured == 1 and batcher.stats.replays > 0
