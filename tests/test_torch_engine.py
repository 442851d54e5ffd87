"""The slice end to end: the port's greedy ``InferenceEngine.generate`` emits
the JAX package's tokens (CPU).

Both engines serve the tiny preset with the BPE vocabulary and the wrapped
note grammar (fast-forward blocks of 1 + 2 tokens), from the same weights
(the JAX engine's served variables, through ``weights.from_jax_params``)
and the same frames and prompts. Compute is float32 so that argmax ties
cannot flip between the two frameworks; the token ids must be equal.
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
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

TOKENIZER = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json"
MAX_NEW = 40
PROMPTS = ["分析这个视频", "summarize the lecture"]


def frames(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)


def port_engine(tok, variables=None, **kwargs) -> InferenceEngine:
    cfg = get_preset("tiny")
    cfg = replace(cfg, dtype="float32", decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    params = None if variables is None else from_jax_params(variables, cfg, device="cpu")
    kwargs = {"max_new_tokens": MAX_NEW, "temperature": 0.0, **kwargs}
    engine = InferenceEngine(cfg, tokenizer=tok, params=params, device="cpu", **kwargs)
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    return engine


@pytest.fixture(scope="module")
def tokenizer():
    return BpeTokenizer.load(TOKENIZER)


def short_note(builder_cls):
    """A grammar that random weights can finish, with the closer bias."""
    return (
        builder_cls().literal('{"title": ').free_string(2, 12).literal(', "summary": ')
        .free_string(2, 12).literal("}").finish()
    )


@pytest.mark.parametrize(
    "quant,bias,grammar",
    [(None, 0.0, "note"), ("int8", 0.0, "note"), ("int8", 1.5, "short"), ("int4", 0.0, "note")],
)
def test_greedy_tokens_equal_jax(tokenizer, quant, bias, grammar):
    """Same tokens and completion flags. The short grammar with the closer
    bias completes rows at different steps, so frozen rows, the EOS filler
    and the per-row index rewind are exercised too. Quantized weights come
    with an int8 KV cache (int4 weights: packed nibble pairs)."""
    j_tok = JBpe.load(TOKENIZER)
    j_cfg = j_get_preset("tiny")
    j_cfg = replace(j_cfg, dtype="float32", decoder=replace(j_cfg.decoder, vocab_size=j_tok.vocab_size))
    kv_quant = "int8" if quant else None
    j_engine = JEngine(
        j_cfg, max_new_tokens=MAX_NEW, temperature=0.0, tokenizer=j_tok, quantize=quant,
        kv_quant=kv_quant, structure_bias=bias, compilation_cache_dir=None,
    )
    j_engine.dfa = j_engine.wrap_grammar(
        j_note_dfa(j_engine.byte_vocab) if grammar == "note" else short_note(JDfaBuilder)
    )
    want = j_engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True)

    variables = jax.tree_util.tree_map(np.asarray, j_engine.params)
    if quant == "int4":
        assert variables["params"]["decoder"]["layer_0"]["mlp"]["down"]["kernel"].dtype == np.uint8
    engine = port_engine(tokenizer, variables, kv_quant=kv_quant, structure_bias=bias)
    if grammar == "short":
        engine.dfa = engine.wrap_grammar(short_note(DfaBuilder))
    got = engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True)
    assert got[2] == want[2]
    assert got[0] == want[0] and got[1] == want[1]
    assert engine.stats.tokens_generated == sum(map(len, want[2]))
    assert engine.stats.prefill_tokens == 2 * (engine.config.video_tokens + 128)
    if grammar == "short":
        assert any(got[1]), "the short grammar should complete a row"


def test_complete_rows_stop_one_eos_short_of_accept(tokenizer):
    """A row completes by sampling EOS into the accepting state, and the EOS
    is not emitted (the loop advances such a row by 0, as the JAX loop
    does): a complete row's tokens walk to a state whose EOS transition is
    the accepting one, never to the accepting state itself."""
    engine = port_engine(tokenizer, structure_bias=1.5)
    engine.dfa = engine.wrap_grammar(short_note(DfaBuilder))
    _, status, ids = engine.generate(frames(), PROMPTS, return_status=True, return_tokens=True)
    assert any(status), "the short grammar should complete a row"
    grammar = engine.dfa
    for done, row in zip(status, ids):
        assert tokenizer.EOS not in row
        state = grammar.start
        for token in row:
            for byte in tokenizer.token_bytes(token):
                state = int(grammar.dfa.next_state[state, byte])
        assert state != grammar.accept
        if done:
            assert grammar.dfa.next_state[state, tokenizer.EOS] == grammar.accept


def test_sampled_output_stays_in_grammar(tokenizer):
    """At temperature 0.7 (the shipped setting) every emitted byte is a
    transition of the note grammar, and accepted notes parse as JSON."""
    import json

    engine = port_engine(tokenizer, temperature=0.7, max_new_tokens=64, param_dtype="bfloat16",
                         quantize="int8", kv_quant="int8")
    texts, status, ids = engine.generate(frames(1), PROMPTS, return_status=True, return_tokens=True)
    grammar = engine.dfa
    for text, done, row in zip(texts, status, ids):
        state = grammar.start
        for token in row:
            for byte in tokenizer.token_bytes(token):
                state = int(grammar.dfa.next_state[state, byte])
                assert state >= 0
        assert done == (state == grammar.accept)
        if done:
            json.loads(text)
        assert 0 < len(row) <= 64 + 2


def test_unported_surface_raises(tokenizer, tmp_path):
    """What stays unported raises: the speculative draft. An HF safetensors
    checkpoint needs a ported-tower preset (``qwen2vl-7b``): the tiny
    preset's native encoder raises, as in the JAX engine, and bad
    arguments raise as in the JAX engine."""
    engine = port_engine(tokenizer)
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    with pytest.raises(ValueError, match="ported-tower"):
        engine.restore(tmp_path)
    assert not hasattr(engine, "attach_draft")
    with pytest.raises(ValueError, match="quantize mode"):
        port_engine(tokenizer, quantize="int2")
    with pytest.raises(ValueError, match="one prompt per clip"):
        engine.generate(frames(), PROMPTS[:1])
