"""The HF tokenizer, the synthetic 152k vocabulary and the token grammar at
V = 152,064, against the JAX package's (CPU).

- ``models/hf_tokenizer.py``: the cases of the JAX package's
  ``tests/test_hf_tokenizer.py`` rerun against the port (``rerun``: the
  module's ``HfTokenizer`` rebound to the port's), on the tokenizer.json that
  file's fixture builds; then ``encode`` in both branches, with the
  ``tokenizers`` runtime and with it refused (merge units), each equal to
  the JAX adapter's same branch, token for token.
- ``models/synth_vocab.py``: the 152,064-entry stand-in is byte-equal to
  JAX's; ``HfTokenizer`` over it gives JAX's token table.
- ``ops/token_grammar.py`` at V = 152,064: the validator grammar's bitset
  and forced runs equal JAX's exactly, and ``constrain`` / ``advance`` give
  JAX's results on the same states, tokens and logits. The note grammar
  (6,386 states; a minute and a half of bitset here) is ``slow``.
- The analyzer with ``engine.tokenizer.type: hf`` builds JAX's tokenizer and
  widens the preset's vocab as JAX's does.
"""

import json
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_hf_tokenizer as j_tok_tests
from tests.test_hf_tokenizer import tokenizer_path  # noqa: F401  (the JAX tests' fixture)
from tests.test_torch_pipeline_pure import rerun
from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.analyzer.schema import validator_dfa as j_validator_dfa
from video_transformer_tpu.models.hf_tokenizer import HfTokenizer as JHfTokenizer
from video_transformer_tpu.models.synth_vocab import write_synth_qwen_vocab as j_write_synth_qwen_vocab
from video_transformer_tpu.ops.token_grammar import TokenGrammar as JTokenGrammar
from video_transformer_tpu_torch.analyzer import ContentAnalyzer
from video_transformer_tpu_torch.analyzer.schema import note_dfa, validator_dfa
from video_transformer_tpu_torch.models.hf_tokenizer import HfTokenizer
from video_transformer_tpu_torch.models.synth_vocab import write_synth_qwen_vocab
from video_transformer_tpu_torch.ops.token_grammar import TokenGrammar
from video_transformer_tpu_torch.utils import counter

torch.set_num_threads(2)

VOCAB = 152064
TEXTS = ["the theme", "梯度 the 梯", "mixed 梯 ascii", '{"title": "梯度下降要点", "n": 12}', "", "a  b\n c"]


def cases(*owners):
    return [pytest.param(owner, name, id=f"{owner.__name__}.{name}")
            for owner in owners for name in vars(owner) if name.startswith("test_")]


# The grammar-backed generation case drives the JAX engine's constructor
# (mesh, compilation cache); the port's engine runs that path in
# tests/test_torch_qwen.py under the same grammar and tokenizer file.
JAX_CASES = [case for case in cases(j_tok_tests.TestAdapterBasics, j_tok_tests.TestGrammarSurface)
             if case.values[1] != "test_token_grammar_constrained_generation"]


@pytest.mark.parametrize("owner, name", JAX_CASES)
def test_jax_hf_tokenizer_cases_hold_the_port(owner, name, tokenizer_path):  # noqa: F811
    rerun(j_tok_tests, {"HfTokenizer": HfTokenizer}, getattr(owner, name), owner(), tokenizer_path)


def test_rerun_reaches_the_port_tokenizer(tokenizer_path):  # noqa: F811
    """The rebinding is real: a port class that raises fails the case."""
    class Broken(HfTokenizer):
        def encode_bytes(self, data):
            raise AssertionError("the port's encode_bytes ran")

    with pytest.raises(AssertionError, match="port's encode_bytes"):
        rerun(j_tok_tests, {"HfTokenizer": Broken},
              j_tok_tests.TestAdapterBasics.test_encode_bytes_applies_merges_in_rank_order,
              j_tok_tests.TestAdapterBasics(), tokenizer_path)


@pytest.fixture(scope="module")
def runtime_tokenizer_path(tokenizer_path, tmp_path_factory):  # noqa: F811
    """The JAX tests' tokenizer.json with the fields that the ``tokenizers``
    runtime requires (it refuses the bare file, so both adapters take merge
    units there): each added token's flags, the decoder's, and the empty
    truncation, padding and post-processor."""
    payload = json.loads(tokenizer_path.read_text(encoding="utf-8"))
    for token in payload["added_tokens"]:
        token.update(single_word=False, lstrip=False, rstrip=False, normalized=False)
    payload["decoder"] = dict(payload["pre_tokenizer"])
    payload.update(truncation=None, padding=None, post_processor=None)
    path = tmp_path_factory.mktemp("hf_tok_runtime") / "tokenizer.json"
    path.write_text(json.dumps(payload, ensure_ascii=False), encoding="utf-8")
    return path


@pytest.fixture
def refuse_tokenizers(monkeypatch):
    """``from tokenizers import ...`` raises ImportError inside the block."""
    monkeypatch.setitem(sys.modules, "tokenizers", None)


@pytest.mark.parametrize("branch,file", [("tokenizers", "runtime"), ("merge_units", "runtime"),
                                         ("merge_units", "bare")])
def test_encode_branches_equal_jax(branch, file, tokenizer_path, runtime_tokenizer_path, monkeypatch):  # noqa: F811
    """``encode`` through the ``tokenizers`` runtime, and with the runtime
    refused (or the file refused by it) through merge units: each branch
    gives the JAX adapter's ids, with and without BOS and EOS, and
    ``encode_array`` its rows."""
    path = runtime_tokenizer_path if file == "runtime" else tokenizer_path
    if branch == "merge_units" and file == "runtime":
        monkeypatch.setitem(sys.modules, "tokenizers", None)
    elif branch == "tokenizers":
        pytest.importorskip("tokenizers")
    tok, j_tok = HfTokenizer(path, vocab_size=512), JHfTokenizer(path, vocab_size=512)
    assert tok.encode_branch == branch
    assert (j_tok._fast is not None) == (branch == "tokenizers")
    for text in TEXTS:
        assert tok.encode(text) == j_tok.encode(text)
        assert tok.encode(text, add_bos=True, add_eos=True) == j_tok.encode(text, add_bos=True, add_eos=True)
        np.testing.assert_array_equal(tok.encode_array(text, 12, add_bos=True), j_tok.encode_array(text, 12, add_bos=True))
        assert tok.decode(tok.encode(text)) == j_tok.decode(j_tok.encode(text))


def test_both_branches_round_trip(runtime_tokenizer_path, monkeypatch):
    """The runtime and the merge units each decode back to the text."""
    pytest.importorskip("tokenizers")
    fast = HfTokenizer(runtime_tokenizer_path)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    plain = HfTokenizer(runtime_tokenizer_path)
    assert plain.encode_branch == "merge_units" and fast.encode_branch == "tokenizers"
    for text in TEXTS:
        assert fast.decode(fast.encode(text)) == plain.decode(plain.encode(text)) == text


def test_unknown_model_and_small_vocab_raise_as_in_jax(tmp_path, tokenizer_path):  # noqa: F811
    bad = tmp_path / "tokenizer.json"
    bad.write_text('{"model": {"type": "WordPiece", "vocab": {}}}')
    for cls in (HfTokenizer, JHfTokenizer):
        with pytest.raises(ValueError, match="unsupported tokenizer model"):
            cls(bad)
        with pytest.raises(ValueError, match="multiple of 128"):
            cls(tokenizer_path, vocab_size=300)
        with pytest.raises(ValueError, match="smaller than max token id"):
            cls(tokenizer_path, vocab_size=256)


# -- the 152k stand-in ----------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_vocab(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth152k")
    path = write_synth_qwen_vocab(root / "port.json", vocab_size=VOCAB)
    j_path = j_write_synth_qwen_vocab(root / "jax.json", vocab_size=VOCAB)
    return path, j_path


@pytest.fixture(scope="module")
def synth_tokenizers(synth_vocab):
    path, j_path = synth_vocab
    return HfTokenizer(path, vocab_size=VOCAB), JHfTokenizer(j_path, vocab_size=VOCAB)


def test_synth_vocab_is_byte_equal_to_jax(synth_vocab, tmp_path):
    path, j_path = synth_vocab
    assert path.read_bytes() == j_path.read_bytes()
    small, j_small = write_synth_qwen_vocab(tmp_path / "a.json", 25600, seed=3), \
        j_write_synth_qwen_vocab(tmp_path / "b.json", 25600, seed=3)
    assert small.read_bytes() == j_small.read_bytes()
    for fn in (write_synth_qwen_vocab, j_write_synth_qwen_vocab):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(tmp_path / "c.json", 1000)


def test_synth_tokenizer_tables_equal_jax(synth_tokenizers):
    tok, j_tok = synth_tokenizers
    assert (tok.vocab_size, tok.EOS, tok.BOS, tok.PAD, tok.VID) == \
        (j_tok.vocab_size, j_tok.EOS, j_tok.BOS, j_tok.PAD, j_tok.VID) == (VOCAB, VOCAB - 4, VOCAB - 4, VOCAB - 4,
                                                                           VOCAB - 3)
    for a, b in zip(tok.token_table(16), j_tok.token_table(16)):
        np.testing.assert_array_equal(a, b)
    for text in TEXTS:
        assert tok.encode(text) == j_tok.encode(text)
        assert tok.encode_bytes(text.encode()) == j_tok.encode_bytes(text.encode())


@pytest.fixture(scope="module")
def grammars_152k(synth_tokenizers):
    tok, j_tok = synth_tokenizers
    return (TokenGrammar(validator_dfa(512), tok, cache_dir=None),
            JTokenGrammar(j_validator_dfa(512), j_tok, cache_dir=None))


def test_validator_grammar_at_152k_equals_jax(grammars_152k):
    grammar, j_grammar = grammars_152k
    assert grammar.allowed_bits.shape == (grammar.num_states, VOCAB // 32)
    np.testing.assert_array_equal(grammar.allowed_bits, j_grammar.allowed_bits)
    for a, b in zip(grammar.forced_tables(2), j_grammar.forced_tables(2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_constrain_and_advance_at_152k_equal_jax(grammars_152k, seed):
    """The device tables at full vocab width: the masked logits and each
    row's successor state equal JAX's functions' on the same inputs."""
    grammar, j_grammar = grammars_152k
    rng = np.random.default_rng(seed)
    states = rng.integers(0, grammar.num_states, 6)
    logits = rng.standard_normal((6, VOCAB)).astype(np.float32)
    table, j_table = grammar.device_table("cpu"), j_grammar.device_table()
    got = grammar.constrain(torch.from_numpy(logits), torch.from_numpy(states), table)
    want = np.asarray(j_grammar.constrain(jnp.asarray(logits), jnp.asarray(states), j_table))
    np.testing.assert_array_equal(got.numpy(), want)
    tokens = want.argmax(axis=1)
    got = grammar.advance(torch.from_numpy(states), torch.from_numpy(tokens), table)
    want = j_grammar.advance(jnp.asarray(states), jnp.asarray(tokens), j_table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bitset_cache_round_trips_at_152k(synth_tokenizers, tmp_path):
    """The port's own cache directory: the 152k bitset written once and
    loaded back equal."""
    tok, _ = synth_tokenizers
    built = TokenGrammar(validator_dfa(512), tok, cache_dir=tmp_path)
    assert len(list(tmp_path.glob("bits_*.npz"))) == 1
    np.testing.assert_array_equal(TokenGrammar(validator_dfa(512), tok, cache_dir=tmp_path).allowed_bits,
                                  built.allowed_bits)


@pytest.mark.slow
def test_note_grammar_at_152k_equals_jax(synth_tokenizers):
    """The note grammar's bitset at V = 152,064 (6,386 states; about a
    minute and a half of CPU a build): equal to JAX's."""
    tok, j_tok = synth_tokenizers
    grammar = TokenGrammar(note_dfa(512), tok, cache_dir=None)
    np.testing.assert_array_equal(grammar.allowed_bits,
                                  JTokenGrammar(j_note_dfa(512), j_tok, cache_dir=None).allowed_bits)


# -- the analyzer's hf setting ---------------------------------------------------------------


def test_analyzer_builds_the_hf_tokenizer_as_jax(tokenizer_path, tmp_path):  # noqa: F811
    """``engine.tokenizer.type: hf``: the analyzer's engine serves an
    ``HfTokenizer`` of the file at the configured vocab, the preset's
    decoder widened to it and the note grammar projected onto it, as the
    JAX analyzer builds them."""
    from video_transformer_tpu.analyzer.content_analyzer import ContentAnalyzer as JContentAnalyzer
    from video_transformer_tpu.utils.counter import APICounter as JCounter

    config = {"engine": {"model_preset": "tiny", "max_new_tokens": 16, "temperature": 0.0,
                         "tokenizer": {"type": "hf", "path": str(tokenizer_path), "vocab_size": 512}},
              "system": {"temp_dir": str(tmp_path / "temp")}}
    engine = ContentAnalyzer(config, counter.APICounter(5), device="cpu").engine
    j_engine = JContentAnalyzer(config, JCounter(5)).engine
    assert isinstance(engine.tokenizer, HfTokenizer) and isinstance(j_engine.tokenizer, JHfTokenizer)
    assert engine.config.decoder == replace(engine.config.decoder, vocab_size=512)
    assert engine.config.decoder.vocab_size == j_engine.config.decoder.vocab_size == 512
    assert isinstance(engine.dfa, TokenGrammar)
    np.testing.assert_array_equal(engine.dfa.allowed_bits, j_engine.dfa.allowed_bits)
    for text in TEXTS:
        assert engine.tokenizer.encode(text) == j_engine.tokenizer.encode(text)


def test_refusal_fixture_blocks_the_runtime(refuse_tokenizers, tokenizer_path):  # noqa: F811
    with pytest.raises(ImportError):
        __import__("tokenizers")
    assert HfTokenizer(tokenizer_path).encode_branch == "merge_units"
