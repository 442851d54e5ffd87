"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device, which
skips the test when ``torch.cuda.is_available()`` is false (as on a CPU-only
host). On a GPU host run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: the row write (K2) and the row adoption (K4) are exact (K2
with per-head scales equals quantize_kv then update_cache_rows bit for bit,
on the card and on the CPU, also at rounding edges), and
K5 (``decode_attention_update`` on a bf16 cache) equals K2 then K3 bit for
bit; K3 and K5 fold their splits in rank order with no atomics, so two
launches give the same bits. Attention (K1, K3 and the training
kernels K7a-c) accumulates in f32 and rounds its bf16 output once, as the
plain version does, so the two agree within 1e-2 of the largest output (one
bf16 rounding step is at most 2**-7 of the value); K7a's f32 LSE within
1e-3. K1 and K7a-c multiply bf16 on the tensor cores with P (and in K7b
and K7c dS) split into two bf16 parts, and are also held element by
element: K1 against attention with f32 weights at (1e-2, 1e-3), K7a's O
and K7b's dQ at (1e-2, 1e-3) and K7c's f32 partials at (1e-3, 1e-4)
against their f32 plain versions. K7b and K7c use no atomics: two launches
give the same bits.
The packed-int4 matmul (K6) equals its plain version bit for bit on
integer-valued x (every partial sum exact in f32), and on normal x lies
within (1e-2, 1e-3) element by element, where plain versions that swap the
nibbles or read them unsigned must fail; it uses no atomics either (two
launches give the same bits).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    DECODE_ROW_SHAPES,
    INT4_SHAPES,
    REL_TOL,
    TRAIN_KERNELS,
    check_int4,
    check_write,
    decode_rows_reading,
    device_profile,
    edge_rows,
    flash_bwd_repeatable,
    flash_errors,
    flash_train_errors,
    k5_repeatable,
    mark_decode_edges,
    reference_phase,
    split_edge_index,
)
from video_transformer_tpu_torch.ops import decode_attention as decode_module
from video_transformer_tpu_torch.ops.attention import flash_attention
from video_transformer_tpu_torch.ops.int4_matmul import int4_matmul
from video_transformer_tpu_torch.ops.decode_attention import (
    _scaled_reference,
    adopt_rows,
    adopt_rows_reference,
    decode_attention,
    decode_attention_update,
    decode_plan,
    decode_splits,
    quantize_kv,
    update_cache_rows,
    write_cache_rows,
)


def assert_close(out: torch.Tensor, ref: torch.Tensor) -> None:
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL * ref.float().abs().max().item(), err


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture
def cuda():
    return require_cuda()


def test_cuda_tests_skip_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pytest.skip.Exception):
        require_cuda()


def randn(gen, *shape, device, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,sq,sk", [
    (8, 2, 1152, 1152), (4, 4, 100, 100), (2, 1, 64, 200), (8, 8, 1024, 1024),
    (8, 2, 3, 1155), (8, 2, 129, 129), (14, 2, 384, 384),  # q_offset off the tile, one row past it, GQA 7
])
def test_flash_attention_matches_plain(cuda, causal, hq, hkv, sq, sk):
    """K1 within REL_TOL of mha_reference and element by element within
    BF16_TOL of f32-weight attention; where causal, a plain version with its
    mask shifted by one key fails that check (flash_errors raises)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = randn(gen, 2, hq, sq, 128, device=cuda), randn(gen, 2, hkv, sk, 128, device=cuda), \
        randn(gen, 2, hkv, sk, 128, device=cuda)
    before = flash_attention.launches
    errors = flash_errors(q, k, v, causal)
    assert flash_attention.launches == before + 1
    assert errors["max_abs_err"] <= errors["tol"] and errors["worst_ratio"] <= 1
    if causal:
        assert errors["shifted_mask_ratio"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("rows", [None, [3, 0, 1]])
def test_write_cache_rows_is_exact(cuda, dtype, rows):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, phys = 3, (3 if rows is None else 4)
    k_cache = randn(gen, phys, 2, 384, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype)
    v_cache = randn(gen, phys, 2, 384, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype)
    k_new = randn(gen, b, 2, 3, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype)
    v_new = randn(gen, b, 2, 3, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype)
    index = torch.tensor([0, 190, 381], dtype=torch.int32, device=cuda)
    rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32, device=cuda)
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows_t)
    update_cache_rows(k_ref, k_new, index, rows_t)
    update_cache_rows(v_ref, v_new, index, rows_t)
    assert torch.equal(k_cache, k_ref) and torch.equal(v_cache, v_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["random", "edges"])
@pytest.mark.parametrize("rows", [None, [2, 0]])
@pytest.mark.parametrize("width,hkv", [(1, 2), (3, 2), (3, 4), (7, 2), (1152, 2), (2176, 4), (1280, 2)])
def test_quantizing_write_is_bit_equal_to_plain(cuda, width, hkv, rows, source):
    """K2 with per-head scales (bf16 rows into int8 caches) at decode and
    prefill widths (base 1,152, 7b 2,176, the batcher stage's 1,280) equals
    quantize_kv then update_cache_rows on the card and on the CPU, bit for
    bit, in one launch and one kernel a call; also on rows at quantize_kv's
    edges (exact halves, the clamp, quotients that a reciprocal rounds
    otherwise)."""
    gen = torch.Generator(device=cuda).manual_seed(width + hkv)
    if source == "edges":  # two heads of edge rows, each repeated to hkv heads in all
        k_new, k_scale = edge_rows(2, width, cuda)
        k_new, k_scale = k_new.repeat_interleave(hkv // 2, dim=1), k_scale.repeat_interleave(hkv // 2)
        v_new, v_scale = -k_new, k_scale.clone()
    else:
        k_new, v_new = randn(gen, 2, hkv, width, 128, device=cuda), randn(gen, 2, hkv, width, 128, device=cuda)
        k_scale, v_scale = (torch.rand(hkv, generator=gen, device=cuda) * 0.04 + 0.02 for _ in range(2))
    s = 128 * (width // 128 + 3)
    caches = [torch.randint(-127, 128, (3, hkv, s, 128), generator=gen, device=cuda, dtype=torch.int8)
              for _ in range(2)]
    index = torch.tensor([0, s - width - 5], dtype=torch.int32, device=cuda)
    rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32, device=cuda)
    before = write_cache_rows.launches
    reading = check_write(*caches, k_new, v_new, index, rows_t, k_scale, v_scale, timed=False)
    assert reading["bit_equal_card_and_cpu"] and write_cache_rows.launches == before + 1

    def call():
        write_cache_rows(*caches, k_new, v_new, index, rows_t, k_scale=k_scale, v_scale=v_scale)

    assert device_profile(call)[1] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False])
def test_write_cache_rows_drops_positions_past_the_end(cuda, scaled):
    """Positions at or past the cache's end are dropped: a row whose three
    new positions start two before the end writes two, as the plain
    version does with those two."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    s = 256
    dtype = torch.int8 if scaled else torch.bfloat16
    caches = [randn(gen, 2, 2, s, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype) for _ in range(2)]
    new = [randn(gen, 2, 2, 3, 128, device=cuda) for _ in range(2)]
    scales = [torch.full((2,), 0.03, device=cuda), torch.full((2,), 0.05, device=cuda)] if scaled else [None, None]
    if not scaled:
        new = [n.to(dtype) for n in new]
    index = torch.tensor([s - 2, 7], dtype=torch.int32, device=cuda)
    plain = [c.clone() for c in caches]
    write_cache_rows(*caches, *new, index, k_scale=scales[0], v_scale=scales[1])
    for cache, rows, scale in zip(plain, new, scales):
        rows = quantize_kv(rows, scale) if scaled else rows
        update_cache_rows(cache[:1], rows[:1, :, :2].contiguous(), index[:1])
        update_cache_rows(cache[1:], rows[1:], index[1:])
    assert torch.equal(caches[0], plain[0]) and torch.equal(caches[1], plain[1])


@pytest.mark.cuda
def test_write_cache_rows_raises_on_unsupported_inputs(cuda):
    """K2 has no fallback: an f32 cache, int8 rows with scales, scales with
    a bf16 cache or a tensor off 16-byte alignment raise before any
    launch."""
    caches = [torch.zeros(2, 2, 64, 128, device=cuda, dtype=torch.int8) for _ in range(2)]
    rows = torch.zeros(2, 2, 3, 128, device=cuda, dtype=torch.bfloat16)
    index = torch.zeros(2, dtype=torch.int32, device=cuda)
    scale = torch.ones(2, device=cuda)
    f32 = [torch.zeros(2, 2, 64, 128, device=cuda) for _ in range(2)]
    bf16 = [c.to(torch.bfloat16) for c in caches]
    shifted = torch.zeros(rows.numel() + 8, device=cuda, dtype=torch.bfloat16)[1:rows.numel() + 1].view(rows.shape)
    before = write_cache_rows.launches
    for args, kwargs in (((*f32, rows.float(), rows.float(), index), {}),
                         ((*caches, rows.to(torch.int8), rows.to(torch.int8), index), {"k_scale": scale,
                                                                                       "v_scale": scale}),
                         ((*bf16, rows, rows, index), {"k_scale": scale, "v_scale": scale}),
                         ((*caches, shifted, rows, index), {"k_scale": scale, "v_scale": scale})):
        with pytest.raises(ValueError):
            write_cache_rows(*args, **kwargs)
    assert write_cache_rows.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("hq,hkv,w", [(8, 2, 3), (1, 1, 3), (4, 2, 1), (8, 1, 2)])
def test_decode_attention_matches_plain(cuda, quantized, hq, hkv, w):
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, phys, s = 2, 3, 1536
    q = randn(gen, b, hq, w, 128, device=cuda)
    if quantized:
        k_cache = torch.randint(-127, 128, (phys, hkv, s, 128), generator=gen, device=cuda, dtype=torch.int8)
        v_cache = torch.randint(-127, 128, (phys, hkv, s, 128), generator=gen, device=cuda, dtype=torch.int8)
        k_scale = torch.rand(hkv, generator=gen, device=cuda) * 0.04 + 0.02
        v_scale = torch.rand(hkv, generator=gen, device=cuda) * 0.04 + 0.02
    else:
        k_cache, v_cache = randn(gen, phys, hkv, s, 128, device=cuda), randn(gen, phys, hkv, s, 128, device=cuda)
        k_scale = v_scale = None
    lengths = torch.tensor([1, 1400], dtype=torch.int32, device=cuda)
    rows = torch.tensor([2, 0], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)
    assert_close(out, _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale))
    # Positions past each row's extent are never read.
    poisoned = k_cache.clone()
    poisoned[0, :, 1400 + w:] = 100 if quantized else 1e4
    poisoned[2, :, 1 + w:] = 100 if quantized else 1e4
    again = decode_attention(q, poisoned, v_cache, lengths, rows, k_scale, v_scale)
    assert torch.equal(out, again)
    # Column j sees positions < lengths + j: rows whose edge straddles a
    # 64-position tile boundary (1407 + 1 = 1408) and starts at position 0.
    edge_lengths = torch.tensor([1, 1407], dtype=torch.int32, device=cuda)
    expected = mark_decode_edges(q, k_cache, v_cache, edge_lengths, rows, v_scale)
    assert_close(decode_attention(q, k_cache, v_cache, edge_lengths, rows, k_scale, v_scale), expected)
    assert_close(_scaled_reference(q, k_cache, v_cache, edge_lengths, rows, k_scale, v_scale), expected)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group,width", DECODE_ROW_SHAPES)
def test_decode_attention_beyond_16_rows_per_kv_head(cuda, group, width, dtype):
    """20, 21, 28, 40, 49 and 80 folded q rows per kv head (16-row groups:
    two, one or a quarter of the warps a group, a second pass past 64 rows)
    agree with the plain version, also at the causal edge; on a bf16 cache
    K5 is bit-equal to K2 then K3 with new positions across a split edge
    (decode_rows_reading raises)."""
    gen = torch.Generator(device=cuda).manual_seed(group * width)
    before = (decode_attention.launches, decode_attention_update.launches)
    reading = decode_rows_reading(gen, cuda, 1664, group, width, dtype)
    fused = dtype == torch.bfloat16
    assert (decode_attention.launches, decode_attention_update.launches) == (before[0] + 2 + fused, before[1] + fused)
    assert reading["max_abs_err"] <= reading["tol"] and reading["edge_max_abs_err"] <= reading["edge_tol"]
    assert reading.get("k5_bit_equal_to_k2_k3", False) == fused


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("count", [3, 1])
def test_adopt_rows_is_exact(cuda, dtype, count):
    """K4 against its plain version: k and v pools in one launch, a pad lane
    on a valid lane's row, positions past park_len and untargeted rows left
    as they were."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    pools = [randn(gen, 6, 2, 400, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype) for _ in range(2)]
    staged = [randn(gen, 4, 2, 320, 128, device=cuda, dtype=torch.float32).mul(40).to(dtype) for _ in range(2)]
    rows = torch.tensor([5, 0, 3, 5], dtype=torch.int32, device=cuda)  # lane 3 pads onto lane 0's row
    refs = [pool.clone() for pool in pools]
    before = adopt_rows.launches
    adopt_rows(pools[0], staged[0], rows, count, 300, pools[1], staged[1])
    assert adopt_rows.launches == before + 1
    for pool, ref, src in zip(pools, refs, staged):
        orig = ref.clone()
        adopt_rows_reference(ref, src, rows, count, 300)
        assert torch.equal(pool, ref)
        assert torch.equal(pool[5, :, :300], src[0, :, :300]) and torch.equal(pool[:, :, 300:], orig[:, :, 300:])


def k2_then_k3(q, k_cache, v_cache, k_new, v_new, index, rows):
    """The split route in K5's place: K2's row write, then K3."""
    write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows)
    return decode_attention(q, k_cache, v_cache, index + 1, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("group,w", ((4, 3),) + DECODE_ROW_SHAPES)
@pytest.mark.parametrize("rows,index", [(None, (0, 1400)), ([3, 0], (127, 1279)), ([1, 2], (62, 700))])
def test_fused_update_is_bit_equal_to_k2_then_k3(cuda, rows, index, group, w):
    """K5's output and the cache it leaves equal K2 then K3 on copies of the
    same inputs, bit for bit; with new rows across a 64-position tile edge,
    at 12 folded q rows per kv head (four warps a group) and at 20-80 (two,
    one, and two passes); and within tolerance of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, hkv, s = 2, 2, 1536
    phys = 2 if rows is None else 4
    q = randn(gen, b, group * hkv, w, 128, device=cuda)
    k_cache, v_cache = randn(gen, phys, hkv, s, 128, device=cuda), randn(gen, phys, hkv, s, 128, device=cuda)
    k_new, v_new = randn(gen, b, hkv, w, 128, device=cuda), randn(gen, b, hkv, w, 128, device=cuda)
    index_t = torch.tensor(index, dtype=torch.int32, device=cuda)
    rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32, device=cuda)
    k2, v2 = k_cache.clone(), v_cache.clone()
    before = (decode_attention_update.launches, write_cache_rows.launches)
    out = decode_attention_update(q, k_cache, v_cache, k_new, v_new, index_t, rows_t)
    assert (decode_attention_update.launches, write_cache_rows.launches) == (before[0] + 1, before[1])
    write_cache_rows(k2, v2, k_new, v_new, index_t, rows_t)
    want = decode_attention(q, k2, v2, index_t + 1, rows_t)
    assert torch.equal(out, want) and torch.equal(k_cache, k2) and torch.equal(v_cache, v2)
    assert_close(out, _scaled_reference(q, k2, v2, index_t + 1, rows_t, None, None))


def decode_inputs(gen, cuda, b, hq, hkv, w, s, int8, phys=3):
    q = randn(gen, b, hq, w, 128, device=cuda)
    if int8:
        k, v = (torch.randint(-127, 128, (phys, hkv, s, 128), generator=gen, device=cuda, dtype=torch.int8)
                for _ in range(2))
        scales = [torch.rand(hkv, generator=gen, device=cuda) * 0.04 + 0.02 for _ in range(2)]
    else:
        k, v = randn(gen, phys, hkv, s, 128, device=cuda), randn(gen, phys, hkv, s, 128, device=cuda)
        scales = [None, None]
    return q, k, v, *scales


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("hq,w", [(8, 3), (14, 3), (8, 7)])
def test_decode_attention_at_length_one_and_a_full_cache(cuda, quantized, hq, w):
    """Row 0 sees one position; row 1's extent, lengths + W - 1, is the
    whole cache; on a bf16 cache K5 writes at index 0 and at the cache's
    last W positions, bit-equal to K2 then K3."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    s = 384
    q, k, v, k_scale, v_scale = decode_inputs(gen, cuda, 2, hq, 2, w, s, quantized)
    rows = torch.tensor([2, 0], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([1, s - w + 1], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths, rows, k_scale, v_scale)
    assert out.isfinite().all()
    assert_close(out, _scaled_reference(q, k, v, lengths, rows, k_scale, v_scale))
    if not quantized:
        k_new, v_new = randn(gen, 2, 2, w, 128, device=cuda), randn(gen, 2, 2, w, 128, device=cuda)
        index = torch.tensor([0, s - w], dtype=torch.int32, device=cuda)
        assert k5_repeatable(q, k, v, k_new, v_new, index, rows) == {"bit_identical_runs": True,
                                                                    "bit_equal_to_k2_k3": True}


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,b,hq,hkv,s,lengths", [
    (True, 2, 8, 2, 1536, (1200, 1351)),  # base serving
    (True, 2, 28, 4, 2560, (2200, 2251)),  # 7b serving: 21 rows per kv head
    (False, 8, 8, 2, 1664, (1408, 1343, 1227, 1264, 1301, 1338, 1375, 1412)),  # the batcher's pool
])
def test_decode_kernels_are_bit_identical_and_one_kernel_a_call(cuda, quantized, b, hq, hkv, s, lengths):
    """K3 (and on the bf16 pool K5) at the main paths' shapes: two launches
    on the same inputs give the same bits (no atomics; the fold runs in rank
    order), and the profiler sees one kernel a call (no combine pass)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, k_scale, v_scale = decode_inputs(gen, cuda, b, hq, hkv, 3, s, quantized, phys=b + 1)
    rows = torch.randperm(b + 1, generator=torch.Generator().manual_seed(0))[:b].to(cuda, torch.int32)
    lengths_t = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    run = lambda: decode_attention(q, k, v, lengths_t, rows, k_scale, v_scale)  # noqa: E731
    assert torch.equal(run(), run())
    assert device_profile(run)[1] == 1
    if not quantized:
        k_new, v_new = randn(gen, b, hkv, 3, 128, device=cuda), randn(gen, b, hkv, 3, 128, device=cuda)
        index = lengths_t - 1
        assert k5_repeatable(q, k, v, k_new, v_new, index, rows) == {"bit_identical_runs": True,
                                                                    "bit_equal_to_k2_k3": True}
        k5 = lambda: decode_attention_update(q, k, v, k_new, v_new, index, rows)  # noqa: E731
        assert device_profile(k5)[1] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("group,w", [(4, 3), (7, 3), (4, 7), (7, 7)])
def test_fused_update_across_a_split_edge(cuda, group, w):
    """K5 with a row's new positions in the tiles of two blocks of
    decode_plan (each block stores its own): bit-equal to K2 then K3, twice
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    s, hkv = 1536, 2
    splits = decode_splits(2, hkv, s)
    q, k, v, _, _ = decode_inputs(gen, cuda, 2, group * hkv, hkv, w, s, False)
    k_new, v_new = randn(gen, 2, hkv, w, 128, device=cuda), randn(gen, 2, hkv, w, 128, device=cuda)
    edge = split_edge_index(w, s, splits)
    plan = decode_plan(edge + 1, w, s, splits)
    owner = {tile: rank for rank, tiles in enumerate(plan) for tile in tiles}
    assert owner[edge // 64] != owner[(edge + w - 1) // 64]
    index = torch.tensor([edge, 1000], dtype=torch.int32, device=cuda)
    rows = torch.tensor([2, 0], dtype=torch.int32, device=cuda)
    assert k5_repeatable(q, k, v, k_new, v_new, index, rows) == {"bit_identical_runs": True,
                                                                "bit_equal_to_k2_k3": True}


@pytest.mark.cuda
def test_tiny_engine_runs_through_every_kernel(cuda):
    from dataclasses import replace
    from pathlib import Path

    from video_transformer_tpu_torch.analyzer.schema import note_dfa
    from video_transformer_tpu_torch.models.bpe import BpeTokenizer
    from video_transformer_tpu_torch.models.config import get_preset
    from video_transformer_tpu_torch.parallel.engine import InferenceEngine

    tok = BpeTokenizer.load(Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json")
    cfg = get_preset("tiny")
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    engine = InferenceEngine(cfg, max_new_tokens=32, temperature=0.0, tokenizer=tok, param_dtype="bfloat16",
                             quantize="int8", kv_quant="int8", device=cuda)
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    kernels = (flash_attention, write_cache_rows, decode_attention)
    before = [k.launches for k in kernels]
    steps = engine.stats.decode_steps
    frames = np.random.default_rng(0).integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    texts, ids = engine.generate(frames, ["分析", "hi"], return_tokens=True)
    assert all(0 < len(row) <= 34 for row in ids)
    assert all(k.launches > n for k, n in zip(kernels, before))
    # K2 once a layer for the prefill and for each decode step, K3 once a layer a step.
    layers, steps = cfg.decoder.num_layers, engine.stats.decode_steps - steps
    assert [k.launches - n for k, n in zip(kernels[1:], before[1:])] == [layers * (1 + steps), layers * steps]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,s", [(8, 2, 1024), (4, 1, 256), (8, 8, 384), (2, 2, 128), (14, 2, 384)])
def test_flash_train_kernels_match_plain(cuda, causal, hq, hkv, s):
    """K7a (O and LSE), K7b and K7c against their plain versions element by
    element, GQA groups of 4, 1 and 7; where causal, plain versions with a mask
    shifted by one position fail the same check (flash_train_errors raises
    past the tolerances, or where the shifted mask passes)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, dout = randn(gen, 2, hq, s, 128, device=cuda), randn(gen, 2, hq, s, 128, device=cuda)
    k, v = randn(gen, 2, hkv, s, 128, device=cuda), randn(gen, 2, hkv, s, 128, device=cuda)
    before = [kernel.launches for kernel in TRAIN_KERNELS]
    errors = flash_train_errors(q, k, v, dout, causal)
    assert [kernel.launches for kernel in TRAIN_KERNELS] == [n + 1 for n in before]
    assert all(check["ratio"] <= 1 for check in errors["checks"].values())
    if causal:
        assert all(check["ratio"] > 1 for check in errors["shifted_mask"].values())


@pytest.mark.cuda
def test_flash_bwd_kernels_are_bit_identical_across_launches(cuda):
    """K7b's dQ and K7c's dK/dV partials: two launches on the same inputs
    give the same bits ([2, 8, 1024, 128], causal, GQA 8/2)."""
    from video_transformer_tpu_torch.ops.flash_bwd import flash_fwd_lse

    gen = torch.Generator(device=cuda).manual_seed(4)
    q, dout = randn(gen, 2, 8, 1024, 128, device=cuda), randn(gen, 2, 8, 1024, 128, device=cuda)
    k, v = randn(gen, 2, 2, 1024, 128, device=cuda), randn(gen, 2, 2, 1024, 128, device=cuda)
    out, lse = flash_fwd_lse(q, k, v, True)
    dsum = (dout.float() * out.float()).sum(-1)
    assert flash_bwd_repeatable(q, k, v, dout, lse, dsum, True) == {"dQ": True, "dK": True, "dV": True}


@pytest.mark.cuda
def test_flash_train_kernels_reject_unsupported_shapes(cuda):
    from video_transformer_tpu_torch.ops.flash_bwd import flash_fwd_lse

    q = torch.zeros(1, 2, 200, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="Sq == Sk % 128 == 0"):
        flash_fwd_lse(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="bfloat16"):
        flash_fwd_lse(*(torch.zeros(1, 2, 256, 128, device=cuda) for _ in range(3)))


@pytest.mark.cuda
def test_tiny_trainer_step_runs_through_k7(cuda):
    """One tiny-preset training step on the card: the decoder (32 video + 224
    text positions) runs K7a-c, the encoder (32 positions) K1 and the
    reference backward; the loss is finite and the weights move."""
    from video_transformer_tpu_torch.models.config import get_preset
    from video_transformer_tpu_torch.ops.attention import flash_attention as attention
    from video_transformer_tpu_torch.train.data import synthetic_batch
    from video_transformer_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = get_preset("tiny")
    trainer = Trainer(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4), device=cuda)
    patches, tokens = synthetic_batch(np.random.default_rng(0), cfg, 2, 224)
    before = [kernel.launches for kernel in TRAIN_KERNELS] + [attention.launches, attention.reference_backwards]
    weight = trainer.model.decoder.layer_0.attn.q.kernel.detach().clone()
    for _ in range(2):  # the first update has learning rate 0
        metrics = trainer.step(patches, tokens)
    after = [kernel.launches for kernel in TRAIN_KERNELS] + [attention.launches, attention.reference_backwards]
    assert [a - b for a, b in zip(after, before)] == [4, 4, 4, 4, 4]
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    assert not torch.equal(weight, trainer.model.decoder.layer_0.attn.q.kernel)


def tiny_bf16_engine(cuda, **kwargs):
    from dataclasses import replace
    from pathlib import Path

    from video_transformer_tpu_torch.analyzer.schema import note_dfa
    from video_transformer_tpu_torch.models.bpe import BpeTokenizer
    from video_transformer_tpu_torch.models.config import get_preset
    from video_transformer_tpu_torch.parallel.engine import InferenceEngine

    tok = BpeTokenizer.load(Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json")
    cfg = get_preset("tiny")
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=tok.vocab_size))
    engine = InferenceEngine(cfg, max_new_tokens=32, temperature=0.0, tokenizer=tok, param_dtype="bfloat16",
                             quantize="int8", device=cuda, **kwargs)
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    return engine


@pytest.mark.cuda
def test_tiny_bf16_engine_decodes_through_k5(cuda, monkeypatch):
    """A bf16-KV engine decodes through K5 and no K3, writes its prefill
    through K2 once a layer, and gives the tokens of the same engine with K2
    then K3 in K5's place."""
    frames = np.random.default_rng(1).integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    engine = tiny_bf16_engine(cuda)
    before = (decode_attention_update.launches, write_cache_rows.launches, decode_attention.launches)
    _, got = engine.generate(frames, ["分析", "hi"], return_tokens=True)
    after = (decode_attention_update.launches, write_cache_rows.launches, decode_attention.launches)
    assert after[0] > before[0] and after[1] - before[1] == engine.config.decoder.num_layers
    assert after[2] == before[2]
    monkeypatch.setattr(decode_module, "_fused_update", k2_then_k3)
    _, want = engine.generate(frames, ["分析", "hi"], return_tokens=True)
    assert got == want


@pytest.mark.cuda
def test_tiny_batcher_runs_through_k4_and_k5(cuda, monkeypatch):
    """Five requests through two slots on the card: each stage writes its
    prefill through K2 once a layer and adopts it through K4, every decode
    step goes through K5 (no K3), and the tokens equal those of the same
    sweep with K2 then K3 in K5's place."""
    from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request

    engine = tiny_bf16_engine(cuda)
    rng = np.random.default_rng(2)
    clips = rng.integers(0, 256, (5, 4, 64, 64, 3), dtype=np.uint8)
    prompts = ["分析", "hi", "第三段", "summarize " * 30, "x"]

    def sweep() -> dict[int, list[int]]:
        batcher = ContinuousBatcher(engine, slots=2)
        for i in range(5):
            batcher.submit(Request(i, clips[i], prompts[i]))
        return {c.request_id: c.token_ids for c in batcher.run()}

    kernels = (adopt_rows, decode_attention_update, write_cache_rows, decode_attention)
    before = [k.launches for k in kernels]
    got = sweep()
    launched = [k.launches - n for k, n in zip(kernels, before)]
    layers = engine.config.decoder.num_layers
    assert launched[0] == 2 * layers and launched[2] == 2 * layers  # two stages (ring depth 4)
    assert launched[1] > 0 and launched[3] == 0
    monkeypatch.setattr(decode_module, "_fused_update", k2_then_k3)
    assert sweep() == got and sorted(got) == list(range(5))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 6, 9, 24, 130, 256])
@pytest.mark.parametrize("shape", sorted(INT4_SHAPES))
def test_int4_matmul_matches_plain_at_7b_shapes(cuda, m, shape):
    """K6 at the 7b decoder's four product shapes: bit-equal on integer x,
    within tolerance on normal x, and the swapped- and unsigned-nibble plain
    versions fail the same check, and two launches on normal x give the same
    bits (check_int4 raises otherwise). M = 1, 9 and 130 pad x's rows to
    wgmma widths 8, 16 and 256 (TMA's zero rows)."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    before = int4_matmul.launches
    reading = check_int4(gen, cuda, m, *INT4_SHAPES[shape], timed=False)
    assert int4_matmul.launches == before + 3  # integer x, then normal x twice
    assert reading["integer_x_bit_equal"] and reading["bit_identical_runs"] and reading["worst_ratio"] <= 1
    assert all(ratio > 1 for ratio in reading["fault_ratios"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("m,shape", [(6, "k_v"), (256, "gate_up")])
def test_int4_matmul_is_bit_identical_across_launches(cuda, m, shape):
    """K6 folds its K/2 splits in rank order through shared memory, with no
    atomics: two launches on the same normal inputs give the same bits."""
    k2, n = INT4_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(5)
    packed = torch.randint(0, 256, (k2, n), generator=gen, device=cuda, dtype=torch.uint8)
    x = torch.randn(m, 2 * k2, generator=gen, device=cuda).to(torch.bfloat16)
    assert torch.equal(int4_matmul(x, packed), int4_matmul(x, packed))


@pytest.mark.cuda
def test_int4_matmul_launch_is_counted_once(cuda):
    """A qualifying call (M = 2 x 3 rows, N and K/2 multiples of 128)
    launches K6 once; 257 rows take the unpacked route and launch nothing."""
    packed = torch.randint(0, 256, (256, 384), device=cuda, dtype=torch.uint8)
    before = int4_matmul.launches
    y = int4_matmul(torch.randn(2, 3, 512, device=cuda).to(torch.bfloat16), packed)
    assert y.shape == (2, 3, 384) and int4_matmul.launches == before + 1
    int4_matmul(torch.randn(257, 512, device=cuda).to(torch.bfloat16), packed)
    assert int4_matmul.launches == before + 1


@pytest.mark.cuda
def test_tiny_int4_engine_decodes_through_k6(cuda):
    """The whole-model int4 reference (a decoder whose every projection
    takes K6): card logits within 2e-2 x max|logit| of the CPU's over
    prefill and three decode blocks, K6 launched 7 x 2 x 3 times and never
    in prefill (reference_phase raises otherwise); then an int4 engine with
    that decoder generates on the card through K6."""
    from dataclasses import replace
    from pathlib import Path

    from chip_smoke import INT4_NARROW
    from video_transformer_tpu_torch.analyzer.schema import note_dfa
    from video_transformer_tpu_torch.models.bpe import BpeTokenizer
    from video_transformer_tpu_torch.models.config import get_preset
    from video_transformer_tpu_torch.parallel.engine import InferenceEngine

    tok = BpeTokenizer.load(Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "bpe-zh-2048.json")
    line = reference_phase(0, cuda, tok.vocab_size, int4=True)
    assert line["max_abs_err"] <= line["tol"] and line["k6_launches"] == 42
    cfg = get_preset("tiny")
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=tok.vocab_size, **INT4_NARROW))
    engine = InferenceEngine(cfg, max_new_tokens=32, temperature=0.0, tokenizer=tok, param_dtype="bfloat16",
                             quantize="int4", kv_quant="int8", device=cuda)
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    before = int4_matmul.launches
    frames = np.random.default_rng(0).integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    _, ids = engine.generate(frames, ["分析", "hi"], return_tokens=True)
    assert all(0 < len(row) <= 34 for row in ids)
    assert int4_matmul.launches - before == 7 * cfg.decoder.num_layers * engine.stats.decode_steps


def tiny_api_engines(cuda, max_new: int = 32):
    """The trained tiny checkpoint served on the card and on the CPU (int8
    weights, int8 KV cache: K1, K2 and K3 on the card), the same weights."""
    from chip_smoke import TOKENIZER, base_config, grounding_engine
    from video_transformer_tpu_torch.models.bpe import BpeTokenizer

    tok = BpeTokenizer.load(TOKENIZER)
    cfg = base_config(tok.vocab_size, "tiny")
    kwargs = dict(temperature=0.0, quantize="int8", kv_quant="int8", max_new_tokens=max_new)
    card = grounding_engine(cfg, tok, cuda, **kwargs)
    return card, grounding_engine(cfg, tok, "cpu", card.dfa, **kwargs)


def assert_first_logits_close(card, cpu, method: str, *args, **kwargs):
    """The entry logits of each decode loop (prefill's last logits) on the
    card within 2e-2 x max|logit| of the CPU's; returns the card's outputs."""
    from chip_smoke import GROUNDING_LOGIT_TOL, decode_carries

    got, want = [], []
    with decode_carries(card, got):
        out = getattr(card, method)(*args, **kwargs)
    with decode_carries(cpu, want):
        getattr(cpu, method)(*args, **dict(kwargs, return_session=False, session_rounds=0))
    for (logits, _), (ref, _) in zip(got, want, strict=True):
        err = (logits - ref).abs().max().item()
        assert err <= GROUNDING_LOGIT_TOL * max(ref.abs().max().item(), 1.0), err
    return out


@pytest.mark.cuda
def test_tiny_generate_text_on_card(cuda):
    """``generate_text`` with the validator grammar: K1 in the text prefill,
    K2 and K3 in every decode step; first-token logits held to the CPU's."""
    from chip_smoke import API_PROMPTS, check_write_routes, counts, reset_counts, walk_rows
    from video_transformer_tpu_torch.analyzer.schema import validator_dfa

    card, cpu = tiny_api_engines(cuda)
    validator = card.wrap_grammar(validator_dfa(card.byte_vocab))
    steps = card.stats.decode_steps
    reset_counts()
    _, status, ids = assert_first_logits_close(card, cpu, "generate_text", API_PROMPTS, dfa=validator,
                                               return_status=True, return_tokens=True)
    launched = counts()
    walk_rows(validator, status, ids, card.max_new_tokens + 2, "generate_text")
    assert launched["flash_attention"] > 0
    check_write_routes(launched, card.config.decoder.num_layers, 1, card.stats.decode_steps - steps, "text")


@pytest.mark.cuda
def test_tiny_id_prefix_on_card(cuda):
    """A capped generation continued by id prefixes of ragged lengths: the
    continuation's first-token logits (K1 at ragged lengths) held to the
    CPU's, and every row makes progress within the grammar."""
    from chip_smoke import PROMPT, walk_rows

    card, cpu = tiny_api_engines(cuda)
    clips = np.random.default_rng(3).integers(0, 256, (3, 4, 64, 64, 3), dtype=np.uint8)
    prompts = [PROMPT, "hi", "第三段"]
    _, _, ids = assert_first_logits_close(card, cpu, "generate", clips, prompts, return_status=True,
                                          return_tokens=True)
    prefixes = [row[: len(row) - i] for i, row in enumerate(ids)]
    _, status, more = assert_first_logits_close(card, cpu, "generate", clips, prompts, prefixes=prefixes,
                                                return_status=True, return_tokens=True)
    assert all(more)
    walk_rows(card.dfa, status, [p + m for p, m in zip(prefixes, more)], 3 * card.max_new_tokens, "prefix")


@pytest.mark.cuda
def test_tiny_session_on_card_equals_the_long_call(cuda):
    """The smoke's engine-API path on the tiny engine: a validator session
    resumed with no prefill equals the call with the same cache length, a
    batch bucket leaves the real rows unchanged, and K1-K3 carry it all
    (``engine_api_phase`` raises otherwise); the session's first call is
    held to the CPU's first-token logits, and K2 + K3 at each decode shape
    of the path to their plain versions."""
    from chip_smoke import API_PROMPTS, API_SESSION_CAP, engine_api_phase, path_decode_inputs, path_decode_readings
    from video_transformer_tpu_torch.analyzer.schema import validator_dfa

    card, cpu = tiny_api_engines(cuda, max_new=API_SESSION_CAP)
    validator = card.wrap_grammar(validator_dfa(card.byte_vocab))
    clips = np.random.default_rng(4).integers(0, 256, (3, 4, 64, 64, 3), dtype=np.uint8)
    assert_first_logits_close(card, cpu, "generate", clips[:2], API_PROMPTS, dfa=validator, session_rounds=4,
                              return_session=True)
    found: dict = {}
    with path_decode_inputs(found):
        lines, launched = engine_api_phase(card, clips)
    assert path_decode_readings(0, found, "engine_api")["worst_ratio"] <= 1  # K2 + K3 at the path's shapes
    session = next(line for line in lines if line["phase"] == "api_session")
    assert session["equals_long_call"] and session["rounds_resumed"] > 0
    assert launched["decode_attention"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk", [(16, 16, 256, 256), (2, 2, 100, 300), (2, 4, 3, 1155), (2, 2, 129, 129)])
def test_flash_attention_at_head_dim_80_matches_plain(cuda, causal, b, h, sq, sk):
    """K1 at the Qwen2-VL tower's head_dim 80 (its shape [16, 16, 256, 80]
    for two clips, and ragged Sq != Sk): within REL_TOL of mha_reference
    and element by element within BF16_TOL of f32-weight attention; where
    causal, a mask shifted by one key fails (flash_errors raises)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = randn(gen, b, h, sq, 80, device=cuda), randn(gen, b, h, sk, 80, device=cuda), \
        randn(gen, b, h, sk, 80, device=cuda)
    before = flash_attention.launches
    errors = flash_errors(q, k, v, causal)
    assert flash_attention.launches == before + 1
    assert errors["max_abs_err"] <= errors["tol"] and errors["worst_ratio"] <= 1
    if causal:
        assert errors["shifted_mask_ratio"] > 1


@pytest.mark.cuda
def test_flash_attention_refuses_other_head_dims_on_the_card(cuda):
    """Head_dim 96 raises on a CUDA tensor (never the plain version), and a
    CUDA tensor at head_dim 80 with grad raises: K7a-c take 128 only."""
    x = torch.zeros(2, 2, 128, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_attention(x, x, x, causal=False)
    y = torch.zeros(2, 2, 128, 80, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        flash_attention(y, y, y, causal=True)


@pytest.mark.cuda
def test_tiny_qwen_geometry_on_card_matches_the_cpu(cuda):
    """The tiny Qwen geometry (tower head_dim 80, decoder q/k/v biases,
    untied lm_head): the card's prefill and decode logits within 2e-2 x
    max|logit| of the CPU's, K1 in every tower block and decoder layer, no
    plain attention on the card (``qwen_reference_phase`` raises otherwise)."""
    from chip_smoke import qwen_reference_phase, watch_plain_writes

    with watch_plain_writes():
        line = qwen_reference_phase(0, cuda)
    assert line["max_abs_err"] <= line["tol"] and line["k1_launches"] == 4
