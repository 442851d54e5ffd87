"""The Qwen2-VL geometry in the port against the JAX package (CPU).

A tiny Qwen geometry that keeps the tower's head_dim 80 (``embed_dim`` 160,
2 heads, 2 blocks, 56 px frames) over a 2-layer decoder with q/k/v biases
and an untied lm_head (``chip_smoke.qwen_tiny_config``, which the card's
reference check uses too):

- exact: ``qwen_patchify``, ``_rotary_table`` (tiny and full geometry),
  ``get_preset("qwen2vl-7b")`` (512 merged video tokens a 16-frame clip,
  head_dim 80, V = 152,064) and the frames' preprocessing;
- float32: the tower's output and the decoder's prefill and decode logits
  with every bias and LayerNorm offset drawn at random (flax's init makes
  them zero), within 1e-4 x the largest value (two blocks of summation-
  order differences); bfloat16 within 5e-2;
- greedy tokens of the two engines under the validator grammar, with an
  ``HfTokenizer`` over the JAX tests' tokenizer.json: unquantized, int8 and
  int4 weights (the int8 and int4 engines with an int8 KV cache), equal
  token for token;
- training through the tower at head_dim 80 on the CPU: the loss and every
  gradient equal JAX's ``jax.grad`` of the same loss within 1e-4 (relative,
  per tensor).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from tests.test_hf_tokenizer import tokenizer_path  # noqa: F401  (the JAX tests' fixture)
from video_transformer_tpu.analyzer.schema import validator_dfa as j_validator_dfa
from video_transformer_tpu.models.config import DecoderConfig as JDecoderConfig
from video_transformer_tpu.models.config import VLMConfig as JVLMConfig
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.hf_tokenizer import HfTokenizer as JHfTokenizer
from video_transformer_tpu.models.lm import init_kv_cache as j_init_kv_cache
from video_transformer_tpu.models.qwen_vit import QwenVisionConfig as JQwenVisionConfig
from video_transformer_tpu.models.qwen_vit import _rotary_table as j_rotary_table
from video_transformer_tpu.models.qwen_vit import qwen_patchify as j_qwen_patchify
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu.ops.preprocess import preprocess_frames as j_preprocess_frames
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu_torch.analyzer.schema import validator_dfa
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.hf_tokenizer import HfTokenizer
from video_transformer_tpu_torch.models.lm import init_kv_cache
from video_transformer_tpu_torch.models.qwen_vit import QwenVisionConfig, _rotary_table, qwen_patchify
from video_transformer_tpu_torch.models.vlm import VideoLM
from video_transformer_tpu_torch.ops.preprocess import preprocess_frames
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

F32_TOL = 1e-4  # x the largest value: f32 compute, two blocks or layers
BF16_TOL = 5e-2
GRAD_TOL = 1e-4


def configs(dtype: str = "float32", vocab_size: int = 512):
    cfg = replace(chip_smoke.qwen_tiny_config(vocab_size), dtype=dtype)
    j_cfg = JVLMConfig(name=cfg.name, encoder=JQwenVisionConfig(**vars(cfg.encoder)),
                       decoder=JDecoderConfig(**vars(cfg.decoder)), dtype=dtype)
    return cfg, j_cfg


def with_random_biases(variables, seed: int):
    """JAX variables whose biases and LayerNorm offsets are drawn at random
    (std 0.1): flax initializes them to zero, which would hide them."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if "bias" in name and leaf.dtype.kind == "f":
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def jax_vars():
    _, j_cfg = configs()
    return with_random_biases(JVideoLM(j_cfg).init_variables(jax.random.PRNGKey(0)), 1)


def frames(seed: int, batch: int = 2, side: int = 56, count: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (batch, count, side, side, 3), dtype=np.uint8)


# -- exact pieces ------------------------------------------------------------------------


@pytest.mark.parametrize("shape,vision", [
    ((2, 4, 56, 56, 3), chip_smoke.QWEN_TINY_VISION),
    ((1, 16, 224, 224, 3), {}),  # qwen2vl-7b's clip geometry
])
def test_patchify_equals_jax(shape, vision):
    cfg = QwenVisionConfig(**{**vision, "num_frames": shape[1], "image_size": shape[2]})
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = qwen_patchify(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(j_qwen_patchify(jnp.asarray(x), JQwenVisionConfig(**vars(cfg))))
    assert got.shape == (shape[0], cfg.tokens_per_clip, cfg.patch_dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vision", [chip_smoke.QWEN_TINY_VISION, dict(image_size=224, num_frames=16),
                                    dict(image_size=112, num_frames=2)])
def test_rotary_table_equals_jax(vision):
    cfg = QwenVisionConfig(**vision)
    got = _rotary_table(cfg)
    assert got.dtype == np.float32 and got.shape == (cfg.tokens_per_clip, cfg.head_dim // 2)
    np.testing.assert_array_equal(got, j_rotary_table(JQwenVisionConfig(**vars(cfg))))


def test_qwen2vl_preset_equals_jax():
    """The preset's geometry: 2,048 patches a 16-frame 224 px clip merged
    into 512 video tokens, head_dim 80, patch_dim 1,176, mlp 5,120, the
    152,064 vocab, q/k/v biases, an untied head, rope_theta 1e6."""
    cfg, j_cfg = get_preset("qwen2vl-7b"), j_get_preset("qwen2vl-7b")
    assert cfg.name == j_cfg.name and cfg.dtype == j_cfg.dtype
    assert vars(cfg.encoder) == vars(j_cfg.encoder) and vars(cfg.decoder) == vars(j_cfg.decoder)
    enc = cfg.encoder
    assert (cfg.video_tokens, enc.tokens_per_clip, enc.grid) == (512, 2048, (8, 16, 16)) == \
        (j_cfg.video_tokens, j_cfg.encoder.tokens_per_clip, j_cfg.encoder.grid)
    assert (enc.head_dim, enc.patch_dim, enc.mlp_dim) == (80, 1176, 5120)
    dec = cfg.decoder
    assert (dec.vocab_size, dec.qkv_bias, dec.tied_embeddings, dec.rope_theta) == (152064, True, False, 1e6)


def test_native_presets_keep_their_video_tokens():
    for name in ("tiny", "base", "7b"):
        assert get_preset(name).video_tokens == j_get_preset(name).video_tokens == \
            get_preset(name).encoder.tokens_per_clip


@pytest.mark.parametrize("side", [56, 64, 90])
def test_preprocess_picks_the_qwen_layout_as_jax(side):
    """uint8 frames of any size: resized to 56, normalized, patchified in
    Qwen2-VL's order, equal to JAX's within float32 rounding."""
    cfg, j_cfg = configs()
    clip = frames(side, side=side)
    got = preprocess_frames(torch.from_numpy(clip), cfg.encoder, torch.float32).numpy()
    want = np.asarray(j_preprocess_frames(jnp.asarray(clip), j_cfg.encoder, jnp.float32))
    assert got.shape == (2, cfg.encoder.tokens_per_clip, cfg.encoder.patch_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tower_width_must_be_the_decoders():
    cfg, _ = configs()
    with pytest.raises(ValueError, match="hidden_size 160 != decoder hidden_dim 256"):
        VideoLM(replace(cfg, encoder=replace(cfg.encoder, hidden_size=160)))


def test_port_tree_names_follow_jax(jax_vars):
    """The ``visual`` module and the decoder's biases: every JAX leaf has a
    port parameter of the same path, and nothing else is there."""
    cfg, _ = configs()
    model = from_jax_params(jax_vars, cfg, device="cpu")
    names = set(model.state_dict())
    assert "visual.block_0.qkv.bias" in names and "decoder.layer_1.attn.k.bias" in names
    assert "decoder.lm_head" in names and not any(n.startswith(("encoder.", "projector")) for n in names)


# -- numerics ----------------------------------------------------------------------------


def assert_close(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_tower_equals_jax(jax_vars, dtype, tol):
    cfg, j_cfg = configs(dtype)
    model = from_jax_params(jax_vars, cfg, device="cpu")
    patches = np.random.default_rng(2).standard_normal((2, cfg.encoder.tokens_per_clip, cfg.encoder.patch_dim))
    patches = patches.astype(np.float32)
    want = JVideoLM(j_cfg).apply(jax_vars, jnp.asarray(patches), method=JVideoLM.encode_video)
    with torch.no_grad():
        got = model.encode_video(torch.from_numpy(patches))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, cfg.video_tokens, cfg.decoder.hidden_dim)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("dtype,kv_quant,tol", [("float32", False, F32_TOL), ("bfloat16", True, BF16_TOL)])
def test_prefill_and_decode_with_biases_equal_jax(jax_vars, dtype, kv_quant, tol):
    """Prefill over video + prompt, then two decode blocks against the
    cache: the logits of each, with the k-bias rotated by RoPE."""
    cfg, j_cfg = configs(dtype)
    model = from_jax_params(jax_vars, cfg, device="cpu")
    j_model = JVideoLM(j_cfg)
    rng = np.random.default_rng(3)
    patches = rng.standard_normal((2, cfg.encoder.tokens_per_clip, cfg.encoder.patch_dim)).astype(np.float32)
    tokens = rng.integers(0, 512, (2, 128)).astype(np.int32)
    blocks = rng.integers(0, 512, (2, 2, 3)).astype(np.int32)
    compute = getattr(jnp, dtype)
    j_cache = j_init_kv_cache(j_cfg.decoder, 2, 512, compute, quant=kv_quant)
    cache = init_kv_cache(cfg.decoder, 2, 512, getattr(torch, dtype), quant=kv_quant, device="cpu")
    want, j_cache = j_model.apply(jax_vars, jnp.asarray(patches), jnp.asarray(tokens), j_cache,
                                  method=JVideoLM.prefill)
    wants = [np.asarray(want, np.float32)]
    with torch.no_grad():
        got, cache = model.prefill(torch.from_numpy(patches), torch.from_numpy(tokens).long(), cache,
                                   torch.full((2,), 128, dtype=torch.int32))
        gots = [got.float().numpy()]
        for block in blocks:
            want, j_cache = j_model.apply(jax_vars, jnp.asarray(block), j_cache, method=JVideoLM.decode_block)
            wants.append(np.asarray(want, np.float32)[:, -1])
            got, cache = model.decode_block_pick(torch.from_numpy(block).long(), cache, torch.tensor([2, 2]))
            gots.append(got.float().numpy())
    for got, want in zip(gots, wants):
        assert_close(got, want, tol)


def test_training_at_head_dim_80_equals_jax_grad(jax_vars):
    """Teacher-forced cross entropy through the tower (head_dim 80) and the
    decoder on the CPU: the loss and each parameter's gradient equal
    ``jax.grad`` of the same loss (the plain attention's backward here; K7a-c
    take head_dim 128, and the card raises at 80)."""
    cfg, j_cfg = configs()
    rng = np.random.default_rng(4)
    patches = rng.standard_normal((2, cfg.encoder.tokens_per_clip, cfg.encoder.patch_dim)).astype(np.float32)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    video = cfg.video_tokens

    def j_loss(params):
        logits = JVideoLM(j_cfg).apply({"params": params}, jnp.asarray(patches), jnp.asarray(tokens))
        logp = jax.nn.log_softmax(logits[:, video:-1], axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(tokens)[:, 1:, None], axis=-1).mean()

    j_value, j_grads = jax.value_and_grad(j_loss)(jax_vars["params"])
    model = from_jax_params(jax_vars, cfg, device="cpu")
    logits = model(torch.from_numpy(patches), torch.from_numpy(tokens).long())
    loss = F.cross_entropy(logits[:, video:-1].reshape(-1, 512), torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    assert abs(loss.item() - float(j_value)) <= GRAD_TOL * abs(float(j_value))
    flat = {".".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    for name, param in model.named_parameters():
        want = flat[name]
        err = np.linalg.norm(param.grad.numpy() - want)
        assert err <= GRAD_TOL * max(np.linalg.norm(want), 1e-12), name


# -- the engines ---------------------------------------------------------------------------


MAX_NEW = 40
PROMPTS = ["评分这份笔记", "score the note"]


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_greedy_tokens_equal_jax_under_the_validator_grammar(tokenizer_path, quant):  # noqa: F811
    """Both engines from the same weights (the JAX engine's served
    variables, biases drawn at random, through ``from_jax_params``) and an
    ``HfTokenizer`` of the same file: greedy f32 decoding under the
    validator grammar gives the same token ids and completion flags."""
    cfg, j_cfg = configs()
    j_tok, tok = JHfTokenizer(tokenizer_path, vocab_size=512), HfTokenizer(tokenizer_path, vocab_size=512)
    kv_quant = "int8" if quant else None
    j_engine = JEngine(j_cfg, max_new_tokens=MAX_NEW, temperature=0.0, tokenizer=j_tok, quantize=quant,
                       kv_quant=kv_quant, compilation_cache_dir=None)
    j_engine.params = jax.tree_util.tree_map(jnp.asarray, with_random_biases(j_engine.params, 5))
    j_engine.dfa = j_engine.wrap_grammar(j_validator_dfa(j_engine.byte_vocab))
    clips = frames(6)
    want = j_engine.generate(clips, PROMPTS, return_status=True, return_tokens=True)

    variables = jax.tree_util.tree_map(np.asarray, j_engine.params)
    if quant == "int4":
        assert variables["params"]["decoder"]["layer_0"]["mlp"]["down"]["kernel"].dtype == np.uint8
    engine = InferenceEngine(cfg, params=from_jax_params(variables, cfg, device="cpu"), tokenizer=tok,
                             max_new_tokens=MAX_NEW, temperature=0.0, kv_quant=kv_quant, device="cpu")
    engine.dfa = engine.wrap_grammar(validator_dfa(engine.byte_vocab))
    got = engine.generate(clips, PROMPTS, return_status=True, return_tokens=True)
    assert got[2] == want[2]
    assert got[0] == want[0] and got[1] == want[1]
    assert engine.stats.prefill_tokens == 2 * (cfg.video_tokens + 128)
    assert all(len(row) > 0 for row in got[2])
