"""Parity of the port's tokenizers and grammar with the JAX package's (CPU).

The BPE codec and the analyzer grammars (note, segment note, schema,
validator and audit) are the port's own copies; their tables
must equal the JAX package's exactly, and the torch ``constrain``,
``advance`` and ``forced_tables`` must give the JAX functions' results on
the same states, tokens and logits.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_transformer_tpu.analyzer import schema as j_schema
from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.models.bpe import BpeTokenizer as JBpe
from video_transformer_tpu.models.tokenizer import ByteTokenizer as JByte
from video_transformer_tpu.ops.constrained import DfaBuilder as JDfaBuilder
from video_transformer_tpu.ops.token_grammar import TokenGrammar as JTokenGrammar
from video_transformer_tpu_torch.analyzer import schema
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.tokenizer import ByteTokenizer
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.ops.token_grammar import TokenGrammar, token_transition_table

torch.set_num_threads(2)

TOKENIZER = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json"
TEXTS = ["分析这段视频的内容，写出结构化的知识笔记。", '{"title": "梯度 descent"}', "", "a  b\n c"]
SCALE = 0.25  # a compact note grammar keeps the bitset precompute fast


@pytest.fixture(scope="module")
def tokenizers():
    return BpeTokenizer.load(TOKENIZER), JBpe.load(TOKENIZER)


@pytest.fixture(scope="module")
def grammars(tokenizers):
    tok, j_tok = tokenizers
    return (
        TokenGrammar(note_dfa(512, scale=SCALE), tok),
        JTokenGrammar(j_note_dfa(512, scale=SCALE), j_tok, cache_dir=None),
    )


def test_bpe_codec_matches(tokenizers):
    tok, j_tok = tokenizers
    for text in TEXTS:
        assert tok.encode(text, add_bos=True) == j_tok.encode(text, add_bos=True)
        assert tok.decode(tok.encode(text)) == j_tok.decode(j_tok.encode(text))
        np.testing.assert_array_equal(tok.encode_array(text, 64, add_bos=True), j_tok.encode_array(text, 64, add_bos=True))
        assert tok.encode_bytes(text.encode()) == j_tok.encode_bytes(text.encode())
    for a, b in zip(tok.token_table(), j_tok.token_table()):
        np.testing.assert_array_equal(a, b)


def test_byte_tokenizer_matches():
    tok, j_tok = ByteTokenizer(512), JByte(512)
    for text in TEXTS:
        assert tok.encode(text, add_bos=True, add_eos=True) == j_tok.encode(text, add_bos=True, add_eos=True)
        assert tok.decode(tok.encode(text)) == j_tok.decode(j_tok.encode(text))


@pytest.mark.parametrize("scale,unicode_text", [(1.0, True), (0.25, False)])
def test_note_dfa_tables_match(scale, unicode_text):
    dfa, j_dfa = note_dfa(512, scale, unicode_text), j_note_dfa(512, scale, unicode_text)
    np.testing.assert_array_equal(dfa.next_state, j_dfa.next_state)
    assert (dfa.start, dfa.accept) == (j_dfa.start, j_dfa.accept)
    for a, b in zip(dfa.forced_tables(24), j_dfa.forced_tables(24)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,args", [
    ("segment_note_dfa", (512, 1.0)), ("segment_note_dfa", (512, 0.25)), ("schema_dfa", (512,)),
    ("validator_dfa", (512,)), ("audit_dfa", (512,)), ("validator_dfa", (2048,)),
])
def test_analyzer_grammar_tables_match(name, args):
    """The other analyzer grammars: tables, start, accept and forced runs
    equal JAX's exactly."""
    dfa, j_dfa = getattr(schema, name)(*args), getattr(j_schema, name)(*args)
    np.testing.assert_array_equal(dfa.next_state, j_dfa.next_state)
    assert (dfa.start, dfa.accept) == (j_dfa.start, j_dfa.accept)
    for a, b in zip(dfa.forced_tables(24), j_dfa.forced_tables(24)):
        np.testing.assert_array_equal(a, b)


def test_choice_matches_and_rejects_shared_first_bytes():
    got = DfaBuilder().literal("x").choice(["true", "false", "null"]).finish()
    want = JDfaBuilder().literal("x").choice(["true", "false", "null"]).finish()
    np.testing.assert_array_equal(got.next_state, want.next_state)
    with pytest.raises(ValueError, match="first byte"):
        DfaBuilder().choice(["no", "nope"])


def test_byte_dfa_constrain_and_advance():
    dfa, j_dfa = note_dfa(512, SCALE), j_note_dfa(512, SCALE)
    rng = np.random.default_rng(0)
    states = rng.integers(0, dfa.num_states, 16)
    logits = rng.standard_normal((16, 512)).astype(np.float32)
    table, j_table = dfa.device_table("cpu"), j_dfa.device_table()
    got = dfa.constrain(torch.from_numpy(logits), torch.from_numpy(states), table)
    want = j_dfa.constrain(jnp.asarray(logits), jnp.asarray(states), j_table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tokens = np.asarray(want).argmax(axis=1)
    got = dfa.advance(torch.from_numpy(states), torch.from_numpy(tokens), table)
    want = j_dfa.advance(jnp.asarray(states), jnp.asarray(tokens), j_table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_grammar_tables_match(grammars):
    grammar, j_grammar = grammars
    np.testing.assert_array_equal(grammar.allowed_bits, j_grammar.allowed_bits)
    for a, b in zip(grammar.forced_tables(2), j_grammar.forced_tables(2)):
        np.testing.assert_array_equal(a, b)


def test_token_grammar_constrain_and_advance(grammars):
    grammar, j_grammar = grammars
    rng = np.random.default_rng(1)
    states = rng.integers(0, grammar.num_states, 32)
    states[:4] = [grammar.start, grammar.accept, grammar.start, 7]
    logits = rng.standard_normal((32, grammar.vocab_size)).astype(np.float32)
    tables, j_tables = grammar.device_table("cpu"), j_grammar.device_table()
    masked = grammar.constrain(torch.from_numpy(logits), torch.from_numpy(states), tables)
    j_masked = j_grammar.constrain(jnp.asarray(logits), jnp.asarray(states), j_tables)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(j_masked))
    # Advance by the best allowed token of each row, and by arbitrary tokens
    # (which may leave the grammar: -1 must match too).
    for tokens in (np.asarray(j_masked).argmax(axis=1), rng.integers(0, grammar.vocab_size, 32)):
        got = grammar.advance(torch.from_numpy(states), torch.from_numpy(tokens), tables)
        want = j_grammar.advance(jnp.asarray(states), jnp.asarray(tokens), j_tables)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_transition_table_advances_as_the_byte_walk(grammars):
    """The ``next_token`` table (built where ``device_table`` fits it, on
    any device) gives the byte walk's successor for every (state, token):
    ``advance`` through it equals JAX's advance and the walk's (the tables
    without it), states of -1 included."""
    grammar, j_grammar = grammars
    tables, j_tables = grammar.device_table("cpu"), j_grammar.device_table()
    table = tables["next_token"]
    assert torch.equal(table, token_transition_table(tables))
    assert table.shape == (grammar.num_states, grammar.vocab_size) and table.dtype == torch.int32
    walk = {key: value for key, value in tables.items() if key != "next_token"}
    rng = np.random.default_rng(2)
    states = rng.integers(-1, grammar.num_states, 256)
    tokens = rng.integers(0, grammar.vocab_size, 256)
    got = grammar.advance(torch.from_numpy(states), torch.from_numpy(tokens), tables)
    want = j_grammar.advance(jnp.asarray(states), jnp.asarray(tokens), j_tables)
    walked = grammar.advance(torch.from_numpy(states), torch.from_numpy(tokens), walk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), walked.numpy())

