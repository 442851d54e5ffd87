"""The decode loop as steps of a fixed carry, in chunks (CPU).

On one card the engine and the batcher replay CUDA graphs of whole decode
steps and read the device once a chunk (``parallel/graphs.py``); on the CPU
the same step functions run eagerly in the same chunks. Here the chunked
loop is held against the JAX package's compiled loop (tiny preset, float32,
the BPE vocabulary, greedy): tokens, positions, completion flags and steps
must be equal, at chunk sizes 1, 3 and 16 with a token budget that is no
multiple of them, with and without an int8 KV cache, under the note grammar
(``max_forced_run`` 2) and a short grammar whose rows finish mid-chunk.
Then sessions, the batcher's two loops, a chunk run with every host read
refused, the graph cache's key and what drops it, the generator's stream at
temperature 0.7, and the launch bookkeeping of a captured graph (with a
stand-in for the CUDA graph: nothing here can capture one).
"""

from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.models.bpe import BpeTokenizer as JBpe
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.ops.constrained import DfaBuilder as JDfaBuilder
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.parallel.serving import ContinuousBatcher as JBatcher
from video_transformer_tpu.parallel.serving import Request as JRequest
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.parallel import engine as engine_module
from video_transformer_tpu_torch.parallel import graphs
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

TOKENIZER = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json"
MAX_NEW = 37  # no multiple of 3 or 16
PROMPTS = ["分析这个视频", "summarize the lecture"]
BATCH_PROMPTS = ["分析这个视频", "summarize the lecture", "第三段", "a much longer prompt " * 10, "x"]


def frames(n: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 4, 64, 64, 3), dtype=np.uint8)


def short_note(builder_cls):
    """A grammar that random weights finish, with the closer bias: rows end
    at different steps."""
    return (
        builder_cls().literal('{"title": ').free_string(2, 12).literal(', "summary": ')
        .free_string(2, 12).literal("}").finish()
    )


def grammar(builder_cls, note, kind: str, byte_vocab: int):
    return note(byte_vocab) if kind == "note" else short_note(builder_cls)


@pytest.fixture(scope="module")
def tokenizer():
    return BpeTokenizer.load(TOKENIZER)


def jax_engine(kind: str, kv_quant, **kwargs) -> JEngine:
    j_tok = JBpe.load(TOKENIZER)
    cfg = j_get_preset("tiny")
    cfg = replace(cfg, dtype="float32", decoder=replace(cfg.decoder, vocab_size=j_tok.vocab_size))
    kwargs = {"max_new_tokens": MAX_NEW, "temperature": 0.0, "structure_bias": 1.5, **kwargs}
    engine = JEngine(cfg, tokenizer=j_tok, kv_quant=kv_quant, compilation_cache_dir=None, **kwargs)
    engine.dfa = engine.wrap_grammar(grammar(JDfaBuilder, j_note_dfa, kind, engine.byte_vocab))
    return engine


def port_engine(tok, j_engine: JEngine, kind: str, **kwargs) -> InferenceEngine:
    """The port engine on ``j_engine``'s weights and settings."""
    cfg = get_preset("tiny")
    cfg = replace(cfg, dtype="float32", decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, j_engine.params), cfg, device="cpu")
    kwargs = {"max_new_tokens": j_engine.max_new_tokens, "temperature": 0.0, "structure_bias": 1.5,
              "kv_quant": j_engine.kv_quant, **kwargs}
    engine = InferenceEngine(cfg, tokenizer=tok, params=params, device="cpu", **kwargs)
    engine.dfa = engine.wrap_grammar(grammar(DfaBuilder, note_dfa, kind, engine.byte_vocab))
    return engine


@pytest.fixture(scope="module")
def jax_runs():
    """Per (grammar, KV quant): the JAX engine and its greedy generate
    (tokens, status, ids) with its loop's steps, computed once."""
    runs = {}
    for kind in ("note", "short"):
        for kv in (None, "int8"):
            j_engine = jax_engine(kind, kv)
            out = j_engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True)
            runs[kind, kv] = (j_engine, out, j_engine.stats.decode_steps)
    return runs


@pytest.mark.parametrize("kind,kv,chunk", [
    ("note", None, 1), ("note", None, 3), ("note", None, 16), ("note", "int8", 3), ("note", "int8", 16),
    ("short", None, 3), ("short", None, 16), ("short", "int8", 1), ("short", "int8", 16),
])
def test_chunked_loop_equals_jax(tokenizer, jax_runs, monkeypatch, kind, kv, chunk):
    """Tokens, completion flags, ``out_pos`` (the ids' lengths) and steps
    equal the JAX loop's. Under the short grammar a row finishes mid-chunk
    and then every row does: the last chunk runs idle steps, which change
    nothing."""
    monkeypatch.setattr(engine_module, "DECODE_CHUNK", chunk)
    j_engine, want, want_steps = jax_runs[kind, kv]
    engine = port_engine(tokenizer, j_engine, kind)
    assert engine._decode_route() == "chunked"
    got = engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True)
    assert got == want
    assert engine.stats.decode_steps == want_steps
    assert engine.stats.decode_route == "eager"
    ran = -(-want_steps // chunk) * chunk
    assert engine.stats.idle_steps == ran - want_steps
    if kind == "short":
        lengths = [len(ids) for ids in want[2]]
        assert all(want[1]) and len(set(lengths)) > 1, "rows should finish at different steps"
        assert max(lengths) < MAX_NEW


def test_session_after_chunked_rounds_equals_jax(tokenizer, jax_runs, monkeypatch):
    """A session's rounds in chunks of 3 give the JAX session's tokens
    round for round (the JAX decode-only program, which equals its longer
    budget), and the session's carry advances in place."""
    monkeypatch.setattr(engine_module, "DECODE_CHUNK", 3)
    j_engine = jax_engine("note", None, max_new_tokens=13)
    engine = port_engine(tokenizer, j_engine, "note")
    kwargs = dict(return_status=True, return_tokens=True, session_rounds=3, return_session=True)
    want = j_engine.generate(frames(), PROMPTS, **kwargs)
    got = engine.generate(frames(), PROMPTS, **kwargs)
    assert got[:3] == want[:3]
    session, j_session = got[3], want[3]
    logits = session.logits
    for _ in range(2):
        assert engine.continue_session(session) == j_engine.continue_session(j_session)
    assert session.logits is logits and session.rounds_left == j_session.rounds_left


@pytest.mark.parametrize("device_refill", [True, False], ids=["refill", "host_driven"])
def test_batcher_loops_equal_jax(tokenizer, device_refill):
    """Five requests through two slots: the port batcher's chunked loop (a
    host-driven chunk of 3 or 8 steps whose slots finish inside it, or the
    refill loop's periods) gives the JAX batcher's tokens, and so does its
    plain loop."""
    j_engine = jax_engine("short", None, mesh=build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1]))
    engine = port_engine(tokenizer, j_engine, "short")
    kwargs = dict(slots=2, prompt_len=256, chunk_steps=8, latency_steps=3, device_refill=device_refill)

    def serve(batcher_cls, request_cls, e):
        batcher = batcher_cls(e, **kwargs)
        for i, clip in enumerate(frames(5, seed=4)):
            batcher.submit(request_cls(i, clip, BATCH_PROMPTS[i]))
        return {c.request_id: (c.token_ids, c.tokens, c.complete) for c in batcher.run()}, batcher

    want, _ = serve(JBatcher, JRequest, j_engine)
    got, batcher = serve(ContinuousBatcher, Request, engine)
    assert got == want and sorted(got) == list(range(5))
    assert batcher.stats.decode_route == "eager"
    if not device_refill:
        assert batcher.stats.idle_steps > 0  # chunks ended with every slot done
    engine._plain_decode = True
    assert serve(ContinuousBatcher, Request, engine)[0] == want


class Refused(AssertionError):
    pass


def refuse_host_reads(monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise Refused("a decode step read the device")

    for name in ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_a_chunk_reads_nothing_on_the_host(tokenizer, jax_runs, monkeypatch):
    """A chunk of the engine's steps, of the batcher's steps and of a
    host-driven chunk's gated steps, with every host read of a tensor
    refused: the step functions read nothing on the host."""
    j_engine = jax_runs["note", "int8"][0]
    engine = port_engine(tokenizer, j_engine, "note")
    cfg = engine.config
    with torch.no_grad():
        cache = engine_module.init_kv_cache(cfg.decoder, 2, 2048, torch.float32, quant=True, device="cpu")
        lengths = torch.tensor([100, 128], dtype=torch.int32)
        tokens = torch.from_numpy(np.stack([tokenizer.encode_array(p, 128, add_bos=True) for p in PROMPTS]))
        logits, cache = engine.model.prefill_text(tokens, cache, lengths)
    state = torch.full((2,), engine.dfa.start, dtype=torch.long)
    carry = engine._new_carry(logits, cache, state, torch.zeros(2, dtype=torch.bool), engine.dfa)
    carry.tokens.fill_(tokenizer.EOS)
    carry.out_pos.zero_()
    carry.step.zero_()
    carry.go.fill_(True)
    batcher = ContinuousBatcher(engine, slots=2, prompt_len=128)
    batcher.submit(Request(0, frames(1)[0], PROMPTS[0]))
    batcher._stage()
    batcher._refill_one(torch.zeros((1,), dtype=torch.long))
    batcher._chunk_k.zero_()
    batcher._chunk_n.fill_(3)
    with monkeypatch.context() as patched:
        refuse_host_reads(patched)
        with pytest.raises(Refused):
            bool(carry.go)
        with torch.no_grad():
            for _ in range(engine_module.DECODE_CHUNK):
                engine._decode_step(carry)
            for _ in range(4):
                batcher._step()
            for _ in range(4):
                batcher._chunk_step()
    assert int(carry.step) == engine_module.DECODE_CHUNK and bool(carry.go)
    assert int(batcher._chunk_k) == 3 and not bool(batcher._live)  # the fourth step was idle
    assert int(batcher.out_pos[0]) > 0


def test_graph_cache_key_and_what_drops_it(tokenizer, jax_runs):
    """An entry per (batch, cache length, grammar, temperature above 0,
    closer bias, block width), kept least recently used first out up to
    ``GRAPH_KEYS``, each with its own KV cache; assigning the model, the
    grammar, the temperature, the closer bias, the forced-run cap or the
    token budget drops them all, as do ``restore``, ``attach_draft`` and
    ``detach_draft``."""
    engine = port_engine(tokenizer, jax_runs["note", None][0], "note")
    dfa = engine.dfa
    entry = engine._graph_entry(2, 1664, dfa)
    assert engine._graph_entry(2, 1664, dfa) is entry
    assert entry.graph is None and entry.carry.cache["k"][0].shape == (2, 1, 1664, 128)
    others = [engine._graph_entry(3, 1664, dfa), engine._graph_entry(2, 1792, dfa), engine._graph_entry(2, 1664, None)]
    engine.temperature = 0.0  # assigned: dropped
    assert not engine._graphs
    for make in (lambda: engine._graph_entry(2, 1664, dfa), lambda: engine._graph_entry(3, 1664, dfa),
                 lambda: engine._graph_entry(2, 1792, dfa), lambda: engine._graph_entry(2, 1664, None)):
        make()
    assert len(engine._graphs) == 4 and len({id(e.carry.cache["k"][0]) for e in engine._graphs.values()}) == 4
    assert others[0] is not engine._graph_entry(3, 1664, dfa)
    keys = set(engine._graphs)
    object.__setattr__(engine, "temperature", 0.7)  # the key's "above 0" (no drop: set past __setattr__)
    object.__setattr__(engine, "structure_bias", 0.0)
    engine._graph_entry(2, 1664, dfa)
    object.__setattr__(engine, "max_forced_run", 0)
    engine._graph_entry(2, 1664, dfa)
    assert len(set(engine._graphs) - keys) == 2
    for i in range(engine_module.GRAPH_KEYS):
        engine._graph_entry(1, 128 * (i + 1), None)
    assert len(engine._graphs) == engine_module.GRAPH_KEYS and not keys & set(engine._graphs)
    for assign in (
        lambda: setattr(engine, "dfa", dfa), lambda: setattr(engine, "max_new_tokens", 12),
        lambda: setattr(engine, "structure_bias", 1.5), lambda: setattr(engine, "max_forced_run", 2),
        lambda: setattr(engine, "temperature", 0.0), lambda: setattr(engine, "model", engine.model),
        lambda: engine.attach_draft(engine.config, share_target_params=True), lambda: engine.detach_draft(),
    ):
        engine._graph_entry(2, 1664, dfa)
        assign()
        assert not engine._graphs


def test_decode_routes_from_the_configuration(tokenizer, jax_runs):
    engine = port_engine(tokenizer, jax_runs["note", None][0], "note")
    assert engine._decode_route() == "chunked"
    engine._plain_decode = True
    assert engine._decode_route() == "plain"
    _, ids = engine.generate(frames(), PROMPTS, return_tokens=True)
    assert engine.stats.decode_route == "eager" and engine.stats.idle_steps == 0
    engine._plain_decode = False
    assert engine.generate(frames(), PROMPTS, return_tokens=True)[1] == ids


def test_sampling_stream_continues_as_the_plain_loop(tokenizer, jax_runs, monkeypatch):
    """At temperature 0.7 from one seed, the chunked loop draws the plain
    loop's tokens, and leaves the generator where the plain loop does (the
    idle steps' draws are taken back), so that the next call draws the
    same too."""
    monkeypatch.setattr(engine_module, "DECODE_CHUNK", 16)
    engine = port_engine(tokenizer, jax_runs["short", None][0], "short", temperature=0.7)
    outs = []
    for plain in (True, False):
        engine._plain_decode = plain
        engine._generator.manual_seed(5)
        first = engine.generate(frames(), PROMPTS, return_tokens=True)
        state = engine._generator.get_state()
        outs.append((first, state, engine.generate(frames(), PROMPTS, return_tokens=True)))
    assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2]
    assert torch.equal(outs[0][1], outs[1][1])
    assert engine.stats.idle_steps > 0


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: a capture records the
    steps, a replay runs them."""

    def __init__(self):
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)


def test_step_graph_keeps_launch_counters_true(monkeypatch):
    """Capture calls the wrappers (their counters move) but launches
    nothing: ``StepGraph`` takes the moves back, and adds them again at
    each replay, so that the counters count the launches that run."""
    def kernel():
        kernel.launches += 1

    def other():
        other.launches += 2

    kernel.launches, other.launches = 10, 0
    captured = []

    class Capture:
        def __init__(self, graph, **kwargs):
            self.graph = graph

        def __enter__(self):
            captured.append(self.graph)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(graphs.GraphPool, "pool", property(lambda self: None))
    monkeypatch.setattr(graphs.GraphPool, "stream", property(lambda self: None))
    replays = []
    monkeypatch.setattr(FakeGraph, "replay", lambda self: replays.append(self), raising=False)
    gen = torch.Generator()
    step_graph = graphs.StepGraph(lambda: (kernel(), other()), 4, graphs.GraphPool(torch.device("cpu")),
                                  (kernel, other), (gen,))
    assert captured == [step_graph.graph] and step_graph.graph.generators == [gen]
    assert (kernel.launches, other.launches) == (10, 0) and step_graph.deltas == [4, 8]
    step_graph.replay()
    step_graph.replay()
    assert len(replays) == 2 and (kernel.launches, other.launches) == (18, 16)


def test_generator_mark_rewinds_a_cpu_generator():
    gen = torch.Generator().manual_seed(3)
    mark = graphs.GeneratorMark(gen)
    draws = []
    for _ in range(5):
        mark.before_step()
        draws.append(torch.rand(4, generator=gen))
    mark.rewind(2, 5)
    assert torch.equal(torch.rand(4, generator=gen), draws[2])
    mark = graphs.GeneratorMark(gen)
    mark.before_step()
    torch.rand(4, generator=gen)
    state = gen.get_state()
    mark.rewind(1, 1)  # every step live: nothing to take back
    assert torch.equal(gen.get_state(), state)
