"""Serve-time projection fusion: the port's ``models/fuse.py`` against the
JAX package's (CPU).

The cases of ``tests/test_fuse.py`` on the port's modules: the fused tree's
structure, idempotence and an unaliased input, decoder logits fused against
unfused for f32, int8 and int4 kernels and with q/k/v biases (rtol and atol
1e-5, the JAX test's), and greedy engine tokens with fusion on and off.
Then the port against JAX on the same numpy weights: the fused kernels,
biases and scales equal the leaves of JAX ``fuse_projections`` exactly,
and a fused port engine's greedy tokens equal a fused JAX engine's
(float32 compute, so that argmax ties cannot flip between frameworks;
token ids exact).
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.fuse import fuse_projections as j_fuse
from video_transformer_tpu.models.quant import quantize_decoder as j_quantize
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.fuse import fuse_projections
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

RTOL = ATOL = 1e-5  # fused against unfused logits, as tests/test_fuse.py


def jax_variables(quant=None, qkv_bias=False, seed=0):
    """The JAX VideoLM's variables for the tiny preset (random q/k/v biases
    when ``qkv_bias``: zeros would hide an ordering fault), quantized as the
    JAX engine quantizes, as numpy leaves; and the matching port config."""
    j_cfg = j_get_preset("tiny")
    cfg = get_preset("tiny")
    if qkv_bias:
        j_cfg = replace(j_cfg, decoder=replace(j_cfg.decoder, qkv_bias=True))
        cfg = replace(cfg, decoder=replace(cfg.decoder, qkv_bias=True))
    variables = JVideoLM(j_cfg).init_variables(jax.random.PRNGKey(seed))

    def randomize_bias(path, leaf):
        if path[-1].key == "bias" and "decoder" in str(path):
            return jax.random.normal(jax.random.PRNGKey(hash(str(path)) % 2**31), leaf.shape) * 0.1
        return leaf

    if qkv_bias:
        variables = jax.tree_util.tree_map_with_path(randomize_bias, variables)
    if quant:
        variables = j_quantize(variables, quant)
    return jax.tree_util.tree_map(np.asarray, variables), cfg


def port_model(variables, cfg):
    return from_jax_params(variables, cfg, device="cpu")


@torch.no_grad()
def decoder_logits(model, tokens):
    logits, _ = model.decoder(torch.as_tensor(tokens), dtype=torch.float32)
    return logits


def names(model) -> set[str]:
    return set(model.state_dict())


def tokens(seed=2, shape=(2, 16), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


class TestFuseTransform:
    def test_fused_tree_structure(self):
        model = port_model(*jax_variables("int8"))
        fused = names(fuse_projections(model))
        assert "decoder.layer_0.attn.qkv.kernel" in fused and "decoder.layer_0.mlp.gateup.kernel" in fused
        assert "decoder.layer_0.attn.qkv.scale" in fused and "decoder.layer_0.mlp.gateup.scale" in fused
        assert not any(".attn.q." in n or ".attn.k." in n or ".attn.v." in n for n in fused)
        assert not any(".mlp.gate." in n or ".mlp.up." in n for n in fused)
        # out/down stay per-module, their scales too
        assert "decoder.layer_0.attn.out.kernel" in fused and "decoder.layer_1.mlp.down.scale" in fused

    def test_idempotent_and_input_unaliased(self):
        model = port_model(*jax_variables())
        fused = fuse_projections(model)
        assert names(fuse_projections(fused)) == names(fused)
        # the caller's module keeps its separate projections
        assert "decoder.layer_0.attn.q.kernel" in names(model) and "decoder.layer_0.attn.qkv.kernel" not in names(model)
        assert fused.decoder.layer_0.attn is not model.decoder.layer_0.attn
        # leaves that fusion does not touch are shared, not copied
        assert fused.decoder.layer_0.attn.out.kernel is model.decoder.layer_0.attn.out.kernel
        assert fused.decoder.embed.embedding is model.decoder.embed.embedding

    @pytest.mark.parametrize("quant", [None, "int8", "int4"])
    def test_logits_parity(self, quant):
        model = port_model(*jax_variables(quant, seed=1))
        x = tokens()
        base = decoder_logits(model, x)
        fused = decoder_logits(fuse_projections(model), x)
        np.testing.assert_allclose(fused.numpy(), base.numpy(), rtol=RTOL, atol=ATOL)

    def test_qkv_bias_parity(self):
        """Qwen2-style biased projections: the biases concatenate and add
        after the scale, in the unfused Dense's order."""
        model = port_model(*jax_variables("int8", qkv_bias=True, seed=3))
        fused = fuse_projections(model)
        assert "decoder.layer_0.attn.qkv.bias" in names(fused)
        x = tokens(4, (1, 8))
        np.testing.assert_allclose(decoder_logits(fused, x).numpy(), decoder_logits(model, x).numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant,qkv_bias", [(None, False), ("int8", False), ("int4", False), ("int8", True)])
def test_fused_leaves_equal_jax(quant, qkv_bias):
    """The same numpy leaves fused by JAX ``fuse_projections`` and by the
    port: every fused kernel, bias and scale equal, bit for bit (dtype
    included: f32, int8, packed uint8)."""
    variables, cfg = jax_variables(quant, qkv_bias)
    j_fused = jax.tree_util.tree_map(np.asarray, j_fuse(variables))
    fused = fuse_projections(port_model(variables, cfg))
    quant_tree = j_fused.get("quant", {}).get("decoder", {})
    for i in range(cfg.decoder.num_layers):
        layer = j_fused["params"]["decoder"][f"layer_{i}"]
        block = getattr(fused.decoder, f"layer_{i}")
        pairs = [(layer["attn"]["qkv_kernel"], block.attn.qkv.kernel),
                 (layer["mlp"]["gateup_kernel"], block.mlp.gateup.kernel)]
        if qkv_bias:
            pairs.append((layer["attn"]["qkv_bias"], block.attn.qkv.bias))
        if quant:
            pairs += [(quant_tree[f"layer_{i}"]["attn"]["qkv_scale"], block.attn.qkv.scale),
                      (quant_tree[f"layer_{i}"]["mlp"]["gateup_scale"], block.mlp.gateup.scale)]
        for want, got in pairs:
            want = np.asarray(want)
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            np.testing.assert_array_equal(got.detach().numpy(), want)


class TestEngineFusion:
    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_greedy_decode_parity(self, quant):
        cfg = get_preset("tiny")
        prompts = ["测试"] * 2
        outs = {}
        for fuse in (False, True):
            engine = InferenceEngine(cfg, max_new_tokens=32, temperature=0.0, seed=0, param_dtype="bfloat16",
                                     quantize=quant, fuse_projections=fuse, device="cpu")
            engine.dfa = note_dfa(cfg.decoder.vocab_size, scale=0.25)
            assert ("decoder.layer_0.attn.qkv.kernel" in names(engine.model)) == fuse
            assert engine.fuse_projections == fuse
            outs[fuse] = engine.generate_text(prompts)
        assert outs[False] == outs[True]

    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_fused_tokens_equal_a_fused_jax_engine(self, quant):
        """The JAX engine's served (quantized) leaves, fused by JAX on one
        side and by the port's ``_place`` on the other: the same greedy
        tokens under the note grammar, for clips and text."""
        j_cfg = j_get_preset("tiny")
        j_cfg = replace(j_cfg, dtype="float32")
        j_engine = JEngine(j_cfg, mesh=build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1]),
                           max_new_tokens=40, temperature=0.0, quantize=quant, compilation_cache_dir=None)
        served = jax.tree_util.tree_map(np.asarray, j_engine.params)
        j_engine.params = j_fuse(j_engine.params)
        j_engine.dfa = j_note_dfa(j_cfg.decoder.vocab_size, scale=0.25)
        frames = np.random.default_rng(0).integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
        want = j_engine.generate(frames, ["分析", "lecture"], return_status=True, return_tokens=True)

        cfg = replace(get_preset("tiny"), dtype="float32")
        engine = InferenceEngine(cfg, params=from_jax_params(served, cfg, device="cpu"), max_new_tokens=40,
                                 temperature=0.0, quantize=quant, fuse_projections=True, device="cpu")
        engine.dfa = note_dfa(cfg.decoder.vocab_size, scale=0.25)
        assert "decoder.layer_1.mlp.gateup.kernel" in names(engine.model)
        got = engine.generate(frames, ["分析", "lecture"], return_status=True, return_tokens=True)
        assert got[2] == want[2] and got[1] == want[1]

    def test_draft_is_fused_when_the_engine_fuses(self):
        cfg = get_preset("tiny")
        engine = InferenceEngine(cfg, max_new_tokens=8, temperature=0.0, fuse_projections=True, device="cpu")
        engine.attach_draft(cfg, spec_tokens=3)
        assert "decoder.layer_0.attn.qkv.kernel" in names(engine.draft_model)
        plain = InferenceEngine(cfg, max_new_tokens=8, temperature=0.0, device="cpu")
        plain.attach_draft(cfg, spec_tokens=3)
        assert "decoder.layer_0.attn.q.kernel" in names(plain.draft_model)

    def test_no_environment_switch(self, monkeypatch):
        """The JAX engine also reads VTX_FUSE_PROJ; the port takes the
        constructor argument only."""
        monkeypatch.setenv("VTX_FUSE_PROJ", "1")
        engine = InferenceEngine(get_preset("tiny"), max_new_tokens=8, device="cpu")
        assert not engine.fuse_projections and "decoder.layer_0.attn.q.kernel" in names(engine.model)

    def test_restore_reapplies_fusion(self):
        """A restored checkpoint is cast, quantized and fused again: the
        fused engine's logits equal the unfused engine's on the same trained
        weights."""
        from pathlib import Path

        from video_transformer_tpu_torch.models.bpe import BpeTokenizer

        repo = Path(__file__).resolve().parents[1]
        tok = BpeTokenizer.load(repo / "data" / "tokenizers" / "bpe-zh-2048.json")
        cfg = get_preset("tiny")
        cfg = replace(cfg, dtype="float32", decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
        npz = repo / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz"
        logits = {}
        for fuse in (False, True):
            engine = InferenceEngine(cfg, tokenizer=tok, quantize="int8", fuse_projections=fuse, device="cpu")
            engine.restore(npz)
            assert ("decoder.layer_0.mlp.gateup.kernel" in names(engine.model)) == fuse
            assert engine.model.decoder.layer_0.mlp.down.kernel.dtype == torch.int8
            logits[fuse] = decoder_logits(engine.model, tokens(5, (1, 24), tok.vocab_size))
        np.testing.assert_allclose(logits[True].numpy(), logits[False].numpy(), rtol=RTOL, atol=ATOL)


def test_fused_int8_product_is_the_unfused_columns():
    """A fused int8 product is ``x @ kernel.to(dtype)`` with the scale
    after it (models/vit.py::Dense), column for column the three unfused
    products, in bf16 too."""
    model = port_model(*jax_variables("int8", seed=6))
    attn = model.decoder.layer_0.attn
    fused = fuse_projections(model).decoder.layer_0.attn.qkv
    x = torch.randn(3, 128, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    want = torch.cat([attn.q(x, torch.bfloat16), attn.k(x, torch.bfloat16), attn.v(x, torch.bfloat16)], dim=-1)
    assert fused.kernel.dtype == torch.int8 and torch.equal(fused(x, torch.bfloat16), want)
