"""Parity of the port's model modules with the JAX package's, on the CPU.

One tiny-preset JAX VideoLM is initialized; its variables go through the
weight bridge (``weights.from_jax_params``) into the port, and the same
numpy inputs go through both: the encoder and projector, the int8 dense
layers, the prefill logits and KV cache, and decode blocks against the cache
with a bf16 or int8 KV cache. Tolerances: float32 compute agrees to ~1e-4
on logits (two layers of summation-order differences); bf16 compute is
compared in float32 within a looser stated bound.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.lm import QDense as JQDense
from video_transformer_tpu.models.lm import init_kv_cache as j_init_kv_cache
from video_transformer_tpu.models.quant import _quantize_kernel as j_quantize_kernel
from video_transformer_tpu.models.quant import quantize_decoder_int8 as j_quantize_decoder_int8
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.lm import QDense, init_kv_cache
from video_transformer_tpu_torch.models.quant import quantize_decoder_int8, quantize_kernel
from video_transformer_tpu_torch.weights import from_jax_params, random_params

torch.set_num_threads(2)

F32_LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 5e-2  # bf16 activations through two layers, logits ~0.1-1


def configs(dtype: str):
    j_cfg, cfg = j_get_preset("tiny"), get_preset("tiny")
    return replace(j_cfg, dtype=dtype), replace(cfg, dtype=dtype)


@pytest.fixture(scope="module")
def jax_vars():
    j_cfg, _ = configs("float32")
    variables = JVideoLM(j_cfg).init_variables(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, variables)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def inputs(seed: int, b: int = 2, prompt: int = 128):
    rng = np.random.default_rng(seed)
    cfg = get_preset("tiny").encoder
    patches = rng.standard_normal((b, cfg.tokens_per_clip, cfg.patch_dim)).astype(np.float32)
    tokens = rng.integers(0, 512, (b, prompt)).astype(np.int32)
    return patches, tokens


def close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_encode_video(jax_vars, dtype, tol):
    j_cfg, cfg = configs(dtype)
    patches, _ = inputs(0)
    want = JVideoLM(j_cfg).apply(jax_vars, jnp.asarray(patches), method=JVideoLM.encode_video)
    model = from_jax_params(jax_vars, cfg, device="cpu")
    got = model.encode_video(torch.from_numpy(patches))
    assert got.dtype == getattr(torch, dtype)
    close(got, want.astype(jnp.float32), tol)


def test_qdense_int8():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((128, 256)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, 128)).astype(np.float32)
    j_q, j_scale = j_quantize_kernel(w)
    q, scale = quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), j_q)
    np.testing.assert_array_equal(scale.numpy(), j_scale)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        want = JQDense(256, dtype=jnp.dtype(dtype)).apply(
            {"params": {"kernel": jnp.asarray(j_q)}, "quant": {"scale": jnp.asarray(j_scale)}},
            jnp.asarray(x, dtype),
        )
        layer = QDense(128, 256)
        layer.kernel, layer.scale = torch.nn.Parameter(q, requires_grad=False), scale
        got = layer(torch.from_numpy(x).to(getattr(torch, dtype)), getattr(torch, dtype))
        close(got, want.astype(jnp.float32), tol)


def test_quantize_decoder_int8_matches_jax(jax_vars):
    _, cfg = configs("float32")
    want = from_jax_params(to_np(j_quantize_decoder_int8(jax_vars)), cfg, device="cpu")
    got = quantize_decoder_int8(from_jax_params(jax_vars, cfg, device="cpu"))
    want_state, got_state = want.state_dict(), got.state_dict()
    assert sorted(want_state) == sorted(got_state)
    assert any(name.endswith(".scale") for name in got_state)
    for name, tensor in want_state.items():
        assert got_state[name].dtype == tensor.dtype, name
        torch.testing.assert_close(got_state[name], tensor, rtol=0, atol=0, msg=name)


def test_bridge_rejects_unknown_and_missing_leaves(jax_vars):
    _, cfg = configs("float32")
    bad = {"params": dict(jax_vars["params"], extra={"kernel": np.zeros(2)})}
    with pytest.raises(KeyError, match="unknown"):
        from_jax_params(bad, cfg, device="cpu")
    partial = {"params": {k: v for k, v in jax_vars["params"].items() if k != "projector_up"}}
    with pytest.raises(KeyError, match="lacks"):
        from_jax_params(partial, cfg, device="cpu")


def test_random_params_are_seeded_and_scaled():
    _, cfg = configs("float32")
    a = random_params(cfg, torch.Generator().manual_seed(3), device="cpu", dtype=torch.bfloat16)
    b = random_params(cfg, torch.Generator().manual_seed(3), device="cpu", dtype=torch.bfloat16)
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert x.dtype == torch.bfloat16, name
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    kernel = a.decoder.layer_0.mlp.gate.kernel.float()
    assert abs(kernel.std().item() - (1 / 128) ** 0.5) < 0.01  # lecun normal, fan_in 128
    assert abs(a.decoder.embed.embedding.float().std().item() - 0.02) < 0.002


@pytest.mark.parametrize(
    "dtype,kv_quant,tol",
    [
        ("float32", False, F32_LOGIT_TOL),
        ("float32", True, F32_LOGIT_TOL),
        ("bfloat16", False, BF16_LOGIT_TOL),
        ("bfloat16", True, BF16_LOGIT_TOL),
    ],
)
def test_prefill_and_decode_blocks(jax_vars, dtype, kv_quant, tol):
    """Prefill logits and cache, then two decode_block_pick steps."""
    j_cfg, cfg = configs(dtype)
    j_vars = to_np(j_quantize_decoder_int8(jax_vars))
    model = from_jax_params(j_vars, cfg, device="cpu")
    j_model = JVideoLM(j_cfg)
    patches, tokens = inputs(2)
    lengths = np.array([128, 100], np.int32)
    cache_len = 512
    j_dtype, dtype_t = jnp.dtype(dtype), getattr(torch, dtype)

    j_cache = j_init_kv_cache(j_cfg.decoder, 2, cache_len, j_dtype, quant=kv_quant)
    j_logits, j_cache = j_model.apply(
        j_vars, jnp.asarray(patches), jnp.asarray(tokens), j_cache, jnp.asarray(lengths),
        method=JVideoLM.prefill,
    )
    cache = init_kv_cache(cfg.decoder, 2, cache_len, dtype_t, quant=kv_quant, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(
            torch.from_numpy(patches), torch.from_numpy(tokens), cache, torch.from_numpy(lengths)
        )
    close(logits, j_logits, tol)
    np.testing.assert_array_equal(cache["index"].numpy(), np.asarray(j_cache["index"]))
    if kv_quant:
        for name in ("k_scale", "v_scale"):
            close(cache[name][0], j_cache[name][0], 1e-6)
        # Quantized rows agree but for values on a rounding boundary, which
        # bf16 rounding differences in k and v make more frequent.
        diff = cache["k"][1].int() - torch.from_numpy(np.array(j_cache["k"][1])).int()
        share = 0.01 if dtype == "float32" else 0.1
        assert diff.abs().max().item() <= 1 and (diff != 0).float().mean().item() < share

    rng = np.random.default_rng(3)
    for step in range(2):
        block = rng.integers(0, 512, (2, 3)).astype(np.int32)
        pick = np.array([2, step], np.int32)
        j_logits, j_cache = j_model.apply(
            j_vars, jnp.asarray(block), j_cache, jnp.asarray(pick), method=JVideoLM.decode_block_pick
        )
        with torch.no_grad():
            logits, cache = model.decode_block_pick(torch.from_numpy(block), cache, torch.from_numpy(pick))
        close(logits, j_logits, tol)
        np.testing.assert_array_equal(cache["index"].numpy(), np.asarray(j_cache["index"]))
