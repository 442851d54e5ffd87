"""K2's function on the CPU against the JAX package: the cache row write with
the int8 quantization inside.

``write_cache_rows`` with per-head scales takes bf16 rows into int8 caches,
as K2 does on the card; on the CPU it runs its plain version
(``quantize_kv`` then ``update_cache_rows``). Its bytes must equal JAX's
``quantize_kv`` followed by the Pallas ``_batch_write_kernel`` (interpret
mode) at decode widths, and JAX's ``update_cache_rows`` at a prefill's
width, on seeded random rows and on rows built at quantize_kv's edges
(``chip_smoke.quantize_edge_rows``: exact halves, the clamp, and quotients
that a multiplication by the reciprocal rounds otherwise). Every
comparison is exact. The model routes every prefill write through one
``write_cache_rows`` call a layer, and the decode step hands it the
unquantized rows and the scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import edge_rows, quantize_edge_rows
from video_transformer_tpu.models.lm import quantize_kv as j_quantize_kv
from video_transformer_tpu.ops import decode_attention as j_dec
from video_transformer_tpu_torch.models import lm
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.ops import decode_attention as dec
from video_transformer_tpu_torch.ops.decode_attention import decode_attention_update, quantize_kv, write_cache_rows
from video_transformer_tpu_torch.weights import random_params

torch.set_num_threads(2)

HKV, D = 2, 128


def bf16_exact(x: np.ndarray) -> np.ndarray:
    """f32 values cut to bf16 (the low 16 bits zeroed), so that JAX and
    torch both read the same bf16 rows."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def new_rows(source: str, seed: int, b: int, w: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """k and v rows f32 [b, HKV, w, D] (bf16-exact) and their scales [HKV]:
    seeded normal rows (|x / s| up to a few hundred, so the clamp acts) or
    ``edge_rows`` (v the negated k)."""
    if source == "edges":
        k, scales = (t.float().numpy() for t in edge_rows(b, w, torch.device("cpu")))
        return k, -k, scales, scales.copy()
    rng = np.random.default_rng(seed)
    k, v = (bf16_exact(rng.standard_normal((b, HKV, w, D)) * 2) for _ in range(2))
    return k, v, *(rng.uniform(0.02, 0.06, HKV).astype(np.float32) for _ in range(2))


def int8_caches(seed: int, r: int, s: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-127, 128, (r, HKV, s, D), dtype=np.int8) for _ in range(2))


def port_write(k_cache, v_cache, k, v, index, rows, k_scale, v_scale) -> tuple[np.ndarray, np.ndarray]:
    """The port's write on copies of the caches, rows passed as bf16."""
    k_t, v_t = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    bf16 = [torch.from_numpy(x).to(torch.bfloat16) for x in (k, v)]
    write_cache_rows(k_t, v_t, *bf16, torch.from_numpy(index), None if rows is None else torch.from_numpy(rows),
                     k_scale=torch.from_numpy(k_scale), v_scale=torch.from_numpy(v_scale))
    return k_t.numpy(), v_t.numpy()


def jax_quantized(x: np.ndarray, scale: np.ndarray):
    return j_quantize_kv(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale))


class TestEdgeRows:
    def test_rows_sit_at_quantize_kv_edges(self):
        """Head 0 holds exact halves (both parities), quotients past
        +-127.5 and infinities; every value of head 1 quantizes otherwise
        when divided through a reciprocal; all are bf16. Checked in numpy
        f32."""
        x, s = quantize_edge_rows()
        assert x.shape == (2, D) and np.array_equal(bf16_exact(x), x)
        q0 = x[0] / s[0]
        finite = q0[np.isfinite(q0)]
        halves = finite[finite - np.floor(finite) == 0.5]
        assert {int(np.floor(h)) % 2 for h in halves} == {0, 1} and len(halves) >= 16
        assert (q0 >= 127.5).any() and (q0 <= -127.5).any() and np.isinf(q0).any()
        one = np.float32(1)
        quotient, product = (np.clip(np.rint(q), -127, 127) for q in (x[1] / s[1], x[1] * (one / s[1])))
        assert (quotient != product).all() and (x[1] > 0).any() and (x[1] < 0).any()

    def test_quantize_kv_divides(self):
        """The port's quantize_kv on the edge rows equals numpy's f32
        rint(x / s) clipped, and differs from the reciprocal's product."""
        x, s = quantize_edge_rows()
        got = quantize_kv(torch.from_numpy(x)[None, :, None, :], torch.from_numpy(s))[0, :, 0].numpy()
        want = np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8)
        product = np.clip(np.rint(x * (np.float32(1) / s[:, None])), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(got, want)
        assert (got[1] != product[1]).all()


@pytest.mark.parametrize("rows", [None, (4, 0, 2)])
@pytest.mark.parametrize("w,source", [(1, "random"), (3, "random"), (7, "random"), (3, "edges"), (7, "edges")])
def test_scaled_write_matches_quantize_then_pallas_interpret(w, source, rows):
    """Decode widths: the port's quantizing write against JAX's quantize_kv
    then _batch_row_write_pallas in interpret mode: the written positions
    bit for bit, every other byte as it was (the Pallas kernel also rewrites
    its 8-aligned region's slack)."""
    k, v, k_scale, v_scale = new_rows(source, w, 3, w)
    k_cache, v_cache = int8_caches(w + 1, 5, 256)
    index = np.array([17, 120, 200], np.int32)
    rows_np = np.arange(3, dtype=np.int32) if rows is None else np.array(rows, np.int32)
    k_out, v_out = j_dec._batch_row_write_pallas(
        jnp.asarray(k_cache), jnp.asarray(v_cache), jax_quantized(k, k_scale), jax_quantized(v, v_scale),
        jnp.asarray(index), None if rows is None else jnp.asarray(rows_np), interpret=True,
    )
    got = port_write(k_cache, v_cache, k, v, index, None if rows is None else rows_np, k_scale, v_scale)
    for cache, want, orig in zip(got, (k_out, v_out), (k_cache, v_cache)):
        want, expected = np.asarray(want), orig.copy()
        for logical, phys in enumerate(rows_np):
            lo, hi = index[logical], index[logical] + w
            expected[phys, :, lo:hi] = want[phys, :, lo:hi]
        np.testing.assert_array_equal(cache, expected)


@pytest.mark.parametrize("source", ["random", "edges"])
@pytest.mark.parametrize("rows", [None, (2, 0)])
def test_scaled_prefill_write_matches_jax_update_cache_rows(rows, source):
    """A prefill's width (300 positions from per-row offsets): the port's
    quantizing write against JAX's quantize_kv then update_cache_rows, the
    whole caches bit for bit."""
    k, v, k_scale, v_scale = new_rows(source, 300, 2, 300)
    k_cache, v_cache = int8_caches(3, 3, 512)
    index = np.array([0, 150], np.int32)
    rows_np = None if rows is None else np.array(rows, np.int32)
    if rows is None:
        k_cache, v_cache = k_cache[:2].copy(), v_cache[:2].copy()
    rows_j = None if rows is None else jnp.asarray(rows_np)
    want = [j_dec.update_cache_rows(jnp.asarray(cache), jax_quantized(x, scale), jnp.asarray(index), rows_j)
            for cache, x, scale in ((k_cache, k, k_scale), (v_cache, v, v_scale))]
    got = port_write(k_cache, v_cache, k, v, index, rows_np, k_scale, v_scale)
    for cache, expected in zip(got, want):
        np.testing.assert_array_equal(cache, np.asarray(expected))


def test_scales_go_together():
    cache = torch.zeros(1, HKV, 8, D, dtype=torch.int8)
    new = torch.zeros(1, HKV, 1, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="go together"):
        write_cache_rows(cache, cache.clone(), new, new, torch.zeros(1, dtype=torch.int32), k_scale=torch.ones(HKV))


@pytest.mark.parametrize("quant", [True, False])
def test_prefill_writes_through_one_call_a_layer(monkeypatch, quant):
    """The tiny decoder's prefill makes one write_cache_rows call a layer
    with the block's unquantized rows, and the calibrated scales for an
    int8 cache (none for a bf16 one)."""
    cfg = get_preset("tiny").decoder
    model = random_params(get_preset("tiny"), torch.Generator().manual_seed(0), device="cpu", dtype=torch.bfloat16)
    calls = []

    def recorded(k_cache, v_cache, k_new, v_new, index, rows=None, k_scale=None, v_scale=None):
        calls.append((k_new.dtype, k_new.shape[2], k_scale is not None))
        write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows, k_scale=k_scale, v_scale=v_scale)

    monkeypatch.setattr(lm, "write_cache_rows", recorded)
    cache = lm.init_kv_cache(cfg, 2, 64, torch.bfloat16, quant=quant, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40)))
    with torch.no_grad():
        model.decoder(tokens, cache=cache, dtype=torch.bfloat16, prefill=True)
    assert calls == [(torch.bfloat16, 40, quant)] * cfg.num_layers


def test_decode_hands_k2_the_unquantized_rows_and_scales(monkeypatch):
    """An int8 decode step gives write_cache_rows the compute-dtype rows
    and both scales (K2 quantizes them), and leaves the same cache as
    quantize_kv then the unscaled write."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 4, 3, D)).astype(np.float32)).to(torch.bfloat16)
    k, v, k_scale, v_scale = new_rows("random", 4, 2, 3)
    k_new, v_new = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    k_cache, v_cache = (torch.from_numpy(c) for c in int8_caches(5, 2, 256))
    index = torch.tensor([30, 150], dtype=torch.int32)
    scales = torch.from_numpy(k_scale), torch.from_numpy(v_scale)
    seen = []

    def recorded(*args, k_scale=None, v_scale=None):
        seen.append((args[2].dtype, k_scale is scales[0], v_scale is scales[1]))
        write_cache_rows(*args, k_scale=k_scale, v_scale=v_scale)

    monkeypatch.setattr(dec, "write_cache_rows", recorded)
    k_got, v_got = k_cache.clone(), v_cache.clone()
    decode_attention_update(q, k_got, v_got, k_new, v_new, index, None, *scales)
    assert seen == [(torch.bfloat16, True, True)]
    k_want, v_want = k_cache.clone(), v_cache.clone()
    write_cache_rows(k_want, v_want, quantize_kv(k_new, scales[0]), quantize_kv(v_new, scales[1]), index)
    assert torch.equal(k_got, k_want) and torch.equal(v_got, v_want)
