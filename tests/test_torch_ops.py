"""Parity of the port's tensor ops with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. On the CPU the
port's kernel wrappers take their plain versions, which are held here
against the JAX dispatch (its XLA reference off the TPU) and against the
Pallas kernels in interpret mode. Tolerances: float32 paths agree to
~1e-5 (summation order only); bf16 paths are compared in float32 within a
stated looser bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.lm import quantize_kv as j_quantize_kv
from video_transformer_tpu.models.vit import sincos_3d_positions as j_sincos
from video_transformer_tpu.models.vit import tubelet_patchify as j_patchify
from video_transformer_tpu.ops import attention as j_attn
from video_transformer_tpu.ops import decode_attention as j_dec
from video_transformer_tpu.ops.norms import rms_norm as j_rms_norm
from video_transformer_tpu.ops.preprocess import preprocess_frames as j_preprocess
from video_transformer_tpu.ops.preprocess import resize_weights as j_resize_weights
from video_transformer_tpu.ops.rotary import apply_rope as j_apply_rope
from video_transformer_tpu.ops.rotary import rope_angles as j_rope_angles
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.vit import sincos_3d_positions, tubelet_patchify
from video_transformer_tpu_torch.ops.attention import flash_attention, mha_reference
from video_transformer_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
    decode_attention_update,
    quantize_kv,
    update_cache_rows,
    write_cache_rows,
)
from video_transformer_tpu_torch.ops.norms import rms_norm
from video_transformer_tpu_torch.ops.preprocess import preprocess_frames, resize_weights
from video_transformer_tpu_torch.ops.rotary import apply_rope, rope_angles

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 3e-2  # a few bf16 ulps at |x| ~ 1-4, compared in float32


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


class TestPointwise:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rms_norm(self, dtype):
        rng = np.random.default_rng(0)
        x, w = rand(rng, 3, 5, 128) * 3, rand(rng, 128)
        want = j_rms_norm(jnp.asarray(x, dtype), jnp.asarray(w))
        got = rms_norm(t(x, getattr(torch, dtype)), t(w))
        close(got, want.astype(jnp.float32), F32_TOL if dtype == "float32" else BF16_TOL)

    def test_rope(self):
        rng = np.random.default_rng(1)
        cos, sin = rope_angles(512, 128, device="cpu")
        j_cos, j_sin = j_rope_angles(512, 128)
        close(cos, j_cos, F32_TOL)
        close(sin, j_sin, F32_TOL)
        x = rand(rng, 2, 3, 7, 128)
        pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
        want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), j_cos, j_sin)
        close(apply_rope(t(x), t(pos, torch.long), cos, sin), want, 1e-4)

    def test_resize_weights(self):
        for src, dst in ((48, 64), (64, 64), (100, 32)):
            np.testing.assert_array_equal(resize_weights(src, dst), j_resize_weights(src, dst))


class TestPreprocess:
    def test_patchify_and_positions(self):
        rng = np.random.default_rng(2)
        x = rand(rng, 2, 4, 32, 32, 3)
        close(tubelet_patchify(t(x), 16, 2), j_patchify(jnp.asarray(x), 16, 2), 0.0)
        cfg, j_cfg = get_preset("tiny").encoder, j_get_preset("tiny").encoder
        np.testing.assert_array_equal(sincos_3d_positions(cfg), j_sincos(j_cfg))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_preprocess_frames(self, dtype):
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 256, (2, 4, 48, 80, 3), dtype=np.uint8)
        cfg, j_cfg = get_preset("tiny").encoder, j_get_preset("tiny").encoder
        want = j_preprocess(jnp.asarray(frames), j_cfg, jnp.dtype(dtype))
        got = preprocess_frames(torch.from_numpy(frames), cfg, getattr(torch, dtype))
        assert got.shape == want.shape
        close(got, want.astype(jnp.float32), 1e-5 if dtype == "float32" else 1e-2)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("hq,hkv,sq,sk", [(4, 2, 64, 64), (2, 1, 48, 80), (1, 1, 96, 96)])
    def test_plain_matches_jax(self, causal, hq, hkv, sq, sk):
        rng = np.random.default_rng(4)
        q, k, v = rand(rng, 2, hq, sq, 128), rand(rng, 2, hkv, sk, 128), rand(rng, 2, hkv, sk, 128)
        want = j_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        got = flash_attention(t(q), t(k), t(v), causal=causal)
        close(got, want, F32_TOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_matches_pallas_interpret(self, causal):
        rng = np.random.default_rng(5)
        q, k, v = rand(rng, 1, 4, 64, 128), rand(rng, 1, 2, 64, 128), rand(rng, 1, 2, 64, 128)
        want = j_attn._flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True
        )
        close(mha_reference(t(q), t(k), t(v), causal=causal), want, F32_TOL)

    def test_bf16(self):
        rng = np.random.default_rng(6)
        q, k, v = rand(rng, 2, 4, 64, 128), rand(rng, 2, 2, 64, 128), rand(rng, 2, 2, 64, 128)
        bf = jnp.bfloat16
        want = j_attn.mha_reference(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf))
        got = flash_attention(t(q, torch.bfloat16), t(k, torch.bfloat16), t(v, torch.bfloat16))
        assert got.dtype == torch.bfloat16
        close(got, want.astype(jnp.float32), BF16_TOL)


def decode_inputs(seed, b=2, hq=4, hkv=2, w=3, s=256, r=None):
    rng = np.random.default_rng(seed)
    r = r or b
    return (rand(rng, b, hq, w, 128), rand(rng, r, hkv, s, 128), rand(rng, r, hkv, s, 128),
            rand(rng, b, hkv, w, 128), rand(rng, b, hkv, w, 128))


class TestCacheRowWrite:
    @pytest.mark.parametrize("rows", [None, (3, 0, 1)])
    def test_plain_matches_jax(self, rows):
        _, k_cache, _, k_new, _ = decode_inputs(7, b=3, r=3 if rows is None else 4)
        index = np.array([5, 100, 200], np.int32)
        rows_j = None if rows is None else jnp.asarray(rows, jnp.int32)
        rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32)
        want = j_dec.update_cache_rows(jnp.asarray(k_cache), jnp.asarray(k_new), jnp.asarray(index), rows_j)
        got = update_cache_rows(t(k_cache), t(k_new), torch.from_numpy(index), rows_t)
        close(got, want, 0.0)

    def test_wrapper_matches_pallas_interpret(self):
        """The written rows equal the Pallas kernel's; everything else is
        untouched (the Pallas kernel's aligned tail slack is not written)."""
        _, k_cache, v_cache, k_new, v_new = decode_inputs(8, b=3, w=3, r=5)
        index = np.array([17, 120, 200], np.int32)
        rows = np.array([4, 0, 2], np.int32)
        k_out, v_out = j_dec._batch_row_write_pallas(
            jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(index), jnp.asarray(rows), interpret=True,
        )
        k_t, v_t = t(k_cache), t(v_cache)
        write_cache_rows(k_t, v_t, t(k_new), t(v_new), torch.from_numpy(index), torch.from_numpy(rows))
        for got, want, orig in ((k_t, k_out, k_cache), (v_t, v_out, v_cache)):
            want, expected = np.asarray(want), orig.copy()
            for logical, phys in enumerate(rows):
                lo, hi = index[logical], index[logical] + 3
                np.testing.assert_array_equal(got[phys, :, lo:hi].numpy(), want[phys, :, lo:hi])
                expected[phys, :, lo:hi] = want[phys, :, lo:hi]
            np.testing.assert_array_equal(got.numpy(), expected)


class TestDecodeAttention:
    @pytest.mark.parametrize("rows", [None, (2, 0)])
    def test_plain_matches_jax(self, rows):
        q, k_cache, v_cache, _, _ = decode_inputs(9, r=2 if rows is None else 3)
        lengths = np.array([40, 201], np.int32)
        rows_j = None if rows is None else jnp.asarray(rows, jnp.int32)
        rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32)
        want = j_dec.decode_attention_reference(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(lengths), rows_j
        )
        got = decode_attention(t(q), t(k_cache), t(v_cache), torch.from_numpy(lengths), rows_t)
        close(got, want, F32_TOL)

    def test_plain_matches_pallas_interpret(self):
        q, k_cache, v_cache, _, _ = decode_inputs(10, r=3)
        lengths = np.array([7, 130], np.int32)
        rows = np.array([1, 2], np.int32)
        want = j_dec._decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(lengths),
            jnp.asarray(rows), interpret=True, pipelined=True,
        )
        got = decode_attention_reference(t(q), t(k_cache), t(v_cache), torch.from_numpy(lengths),
                                         torch.from_numpy(rows))
        close(got, want, F32_TOL)

    def test_quantize_kv(self):
        rng = np.random.default_rng(11)
        x, scale = rand(rng, 2, 2, 5, 128), np.array([0.01, 0.03], np.float32)
        want = j_quantize_kv(jnp.asarray(x), jnp.asarray(scale))
        got = quantize_kv(t(x), t(scale))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("quantized", [False, True])
    def test_update_dispatch_matches_jax(self, quantized):
        """The write-then-attend dispatch, with the int8 algebra (quantized
        rows, q scaled by k_scale, output by v_scale) against the JAX
        package's dequantizing reference path."""
        q, k_cache, v_cache, k_new, v_new = decode_inputs(12)
        index = np.array([30, 150], np.int32)
        k_scale = v_scale = None
        if quantized:
            k_scale, v_scale = np.array([0.02, 0.025], np.float32), np.array([0.03, 0.02], np.float32)
            k_cache = np.round(k_cache / 0.03 * 0.5).clip(-127, 127).astype(np.int8)
            v_cache = np.round(v_cache / 0.03 * 0.5).clip(-127, 127).astype(np.int8)
        want, k_want, v_want = j_dec.decode_attention_update(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(k_new),
            jnp.asarray(v_new), jnp.asarray(index),
            k_scale=None if k_scale is None else jnp.asarray(k_scale),
            v_scale=None if v_scale is None else jnp.asarray(v_scale),
        )
        cache_dtype = torch.int8 if quantized else torch.float32
        k_t, v_t = t(k_cache, cache_dtype), t(v_cache, cache_dtype)
        got = decode_attention_update(
            t(q), k_t, v_t, t(k_new), t(v_new), torch.from_numpy(index),
            k_scale=None if k_scale is None else t(k_scale),
            v_scale=None if v_scale is None else t(v_scale),
        )
        close(got, want, 1e-4 if quantized else F32_TOL)
        np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_want))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_want))


class TestWrappersNeverFallBack:
    """Off the CPU a wrapper launches its kernel or raises; here a meta
    tensor (neither CPU nor CUDA) must raise before any launch."""

    def test_flash_attention_raises_off_cpu(self):
        q = torch.empty(1, 1, 64, 128, device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q, q, q)

    def test_decode_wrappers_raise_off_cpu(self):
        q = torch.empty(1, 2, 3, 128, device="meta", dtype=torch.bfloat16)
        cache = torch.empty(1, 1, 256, 128, device="meta", dtype=torch.int8)
        lengths = torch.empty(1, device="meta", dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            decode_attention(q, cache, cache, lengths)
        new = torch.empty(1, 1, 3, 128, device="meta", dtype=torch.int8)
        with pytest.raises(ValueError, match="CUDA"):
            write_cache_rows(cache, cache, new, new, lengths)
