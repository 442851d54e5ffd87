"""Decode-step attention: K2 (cache row write), K3 (paged decode attention),
K4 (paged row adoption) and K5 (K2 and K3 fused).

Layout: q [B, Hq, W, D] (W = decode block width), caches [R, Hkv, S, D]
with R >= B, per-row cache offsets ``index`` [B] and optional ``rows`` [B]
mapping each logical row to its physical cache row. Query column j of row b
sees cache positions < index[b] + 1 + j.

``write_cache_rows`` wraps K2 (``csrc/write_cache_rows.cu``, replacing the
Pallas ``_batch_write_kernel`` and, for an int8 cache, the ``quantize_kv``
before it), ``decode_attention`` wraps K3 (``csrc/decode_attention.cu``,
replacing ``_kernel_pipelined``) and ``adopt_rows`` wraps K4
(``csrc/adopt_rows.cu``, replacing ``_adopt_kernel``). Each takes its plain
version, ``quantize_kv`` then ``update_cache_rows``,
``decode_attention_reference`` or ``adopt_rows_reference``, for CPU tensors
only. K2 takes every cache write on the card: a decode step's rows and a
prefill's block (``models/lm.py``). ``decode_attention_update`` is the
dispatch of the JAX package's ``decode_attention_update``: for an int8
cache K2 quantizes the new rows under the layer's scales as it writes them,
the per-head scales factor out of the attention (q scaled by k_scale, the
output by v_scale), and it takes K2 then K3; for a bf16 cache on the card
it launches K5 (``csrc/decode_attention.cu``, replacing ``_fused_kernel``),
which gives K2 then K3's output and cache bit for bit in one launch. The
JAX package reaches its fused kernel only through ``VTX_FUSED_WRITE``; here
the cache's dtype decides.
"""

from __future__ import annotations

import math

import torch

from . import _lib

__all__ = [
    "adopt_rows",
    "adopt_rows_reference",
    "decode_attention",
    "decode_attention_reference",
    "decode_attention_update",
    "decode_plan",
    "decode_splits",
    "quantize_kv",
    "update_cache_rows",
    "write_cache_rows",
]

_NEG_INF = -1e30
_DECODE_TILE = 64  # cache positions a K3/K5 tile (csrc/decode_attention.cu kBK)
_DECODE_CLUSTER = 8  # splits a (kv head, batch row) at most: the portable cluster size (kMaxSplits)
_DECODE_SLOTS = 264  # K3/K5 blocks the card holds at once: two on each of the H100's 132 SMs


def quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16/f32 [B, Hkv, S, D] -> int8 rows under per-head ``scale`` [Hkv]."""
    q = torch.round(x.float() / scale[None, :, None, None])
    return q.clamp(-127, 127).to(torch.int8)


def update_cache_rows(
    cache: torch.Tensor, new: torch.Tensor, index: torch.Tensor, rows: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain in-place write of new [B, H, W, D] into cache [R, H, S, D] at
    positions index[b] .. index[b] + W - 1 of physical row rows[b]. The
    positions must lie inside the cache (callers reserve tail slack)."""
    b, _, w, _ = new.shape
    phys = rows if rows is not None else torch.arange(b, device=cache.device)
    pos = index.long()[:, None] + torch.arange(w, device=cache.device)[None, :]  # [B, W]
    cache[phys.long()[:, None], :, pos] = new.transpose(1, 2).to(cache.dtype)
    return cache


def _check(name: str, t: torch.Tensor, dtypes: tuple[torch.dtype, ...], shape: tuple[int, ...] | None = None):
    if t.device.type != "cuda" or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CUDA tensor of {dtypes}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def write_cache_rows(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    index: torch.Tensor,
    rows: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> None:
    """In place: k/v_cache[rows[b], h, index[b] + j] = k/v_new[b, h, j] for
    every j < W (K2), k and v in one launch. With ``k_scale``/``v_scale``
    [Hkv] f32 the caches are int8 and the rows are quantized as they are
    written, bit for bit as ``quantize_kv`` does; without them the rows are
    already in the caches' dtype. On the card positions at or past the
    cache's end are dropped."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if k_cache.device.type == "cpu":
        if k_scale is not None:
            k_new, v_new = quantize_kv(k_new, k_scale), quantize_kv(v_new, v_scale)
        update_cache_rows(k_cache, k_new, index, rows)
        update_cache_rows(v_cache, v_new, index, rows)
        return
    r, hkv, s, d = k_cache.shape
    b, _, w, _ = k_new.shape
    quantized = k_scale is not None
    _check("k_cache", k_cache, (torch.int8,) if quantized else (torch.int8, torch.bfloat16))
    _check("v_cache", v_cache, (k_cache.dtype,), tuple(k_cache.shape))
    row_dtype = torch.bfloat16 if quantized else k_cache.dtype
    _check("k_new", k_new, (row_dtype,), (b, hkv, w, d))
    _check("v_new", v_new, (row_dtype,), (b, hkv, w, d))
    _check("index", index, (torch.int32,), (b,))
    if quantized:
        _check("k_scale", k_scale, (torch.float32,), (hkv,))
        _check("v_scale", v_scale, (torch.float32,), (hkv,))
    if rows is not None:
        _check("rows", rows, (torch.int32,), (b,))
    elif b > r:
        raise ValueError(f"batch {b} exceeds the cache's {r} rows")
    if d % 16 or not 0 < b <= 32767:
        raise ValueError(f"write_cache_rows: head_dim {d} must be a multiple of 16 and batch {b} in 1..32767")
    code = _lib.library().vtx_write_cache_rows(
        k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), index.data_ptr(),
        _lib.ptr(rows), _lib.ptr(k_scale), _lib.ptr(v_scale), b, hkv, s, w, d, k_cache.element_size(),
        k_new.element_size(), _lib.stream(k_cache),
    )
    _lib.check("vtx_write_cache_rows", code)
    write_cache_rows.launches += 1


write_cache_rows.launches = 0


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain full-cache masked attention (per-row causal lengths), in f32."""
    if rows is not None:
        k_cache = k_cache[rows.long()]
        v_cache = v_cache[rows.long()]
    b, hq, w, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, w, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    limit = lengths.long()[:, None, None, None, None] + torch.arange(w, device=q.device)[None, None, None, :, None]
    logits = logits.masked_fill(k_pos >= limit, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights, v_cache.float())
    return out.reshape(b, hq, w, d).to(q.dtype)


def _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale):
    """The plain version of K3's arithmetic, per-head scales applied in f32."""
    if k_scale is None:
        return decode_attention_reference(q, k_cache, v_cache, lengths, rows)
    group = q.shape[1] // k_cache.shape[1]
    ks = k_scale.float().repeat_interleave(group)[None, :, None, None]
    vs = v_scale.float().repeat_interleave(group)[None, :, None, None]
    out = decode_attention_reference(q.float() * ks, k_cache, v_cache, lengths, rows)
    return (out * vs).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    rows: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Length-aware paged decode attention through K3 (plain on CPU).

    ``k_scale``/``v_scale`` [Hkv] f32 are required for an int8 cache and
    must be absent for a bf16 one.
    """
    if q.device.type == "cpu":
        return _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)
    b, hq, w, d = q.shape
    r, hkv, s, _ = k_cache.shape
    _check("q", q, (torch.bfloat16,))
    _check("k_cache", k_cache, (torch.int8, torch.bfloat16))
    _check("v_cache", v_cache, (k_cache.dtype,), tuple(k_cache.shape))
    _check("lengths", lengths, (torch.int32,), (b,))
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale/v_scale go with an int8 cache, and only with one")
    if quantized:
        _check("k_scale", k_scale, (torch.float32,), (hkv,))
        _check("v_scale", v_scale, (torch.float32,), (hkv,))
    if rows is not None:
        _check("rows", rows, (torch.int32,), (b,))
    elif b > r:
        raise ValueError(f"batch {b} exceeds the cache's {r} rows")
    _check_decode_shape("decode_attention", q, hkv, s)
    out = torch.empty_like(q)
    code = _lib.library().vtx_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        _lib.ptr(rows), _lib.ptr(k_scale), _lib.ptr(v_scale), out.data_ptr(),
        b, hq, hkv, s, w, d, decode_splits(b, hkv, s), int(quantized), 1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_decode_attention", code)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _check_decode_shape(name: str, q: torch.Tensor, hkv: int, s: int) -> None:
    b, hq, _, d = q.shape
    if d != 128 or hq % hkv or s % _DECODE_TILE or not 0 < b <= 65535:
        raise ValueError(f"{name}: unsupported q {tuple(q.shape)} for {hkv} kv heads and a cache of {s}"
                         f" positions (head_dim 128, a multiple of {_DECODE_TILE} positions)")


def decode_splits(batch: int, hkv: int, s_cache: int) -> int:
    """K3's and K5's blocks for each (kv head, batch row), one thread-block
    cluster, from the shapes alone (never from the lengths, which stay on
    the card): the largest power of two up to 8 that the cache's tiles
    cover and that keeps the grid within two blocks an SM."""
    splits = 1
    while (2 * splits <= min(_DECODE_CLUSTER, s_cache // _DECODE_TILE)
           and batch * hkv * 2 * splits <= _DECODE_SLOTS):
        splits *= 2
    return splits


def decode_plan(length: int, width: int, s_cache: int, splits: int) -> list[range]:
    """The cache tiles (64 positions each) that each of a cluster's
    ``splits`` blocks reads, in rank order, for a row whose column 0 sees
    ``length`` positions (K5: index + 1): an equal share of the tiles that
    hold a valid position, up to ``length + width - 1``. The kernel computes
    the same (``plan`` in ``csrc/decode_attention.cu``)."""
    extent = max(0, min(length + width - 1, s_cache))
    tiles = -(-extent // _DECODE_TILE)
    return [range(c * tiles // splits, (c + 1) * tiles // splits) for c in range(splits)]


def decode_attention_update(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    index: torch.Tensor,
    rows: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Write the step's new k/v rows at ``index`` (in place), then attend.

    For an int8 cache (``k_scale``/``v_scale`` given) K2 quantizes the new
    rows under the layer's scales as it writes them, then K3 attends, as
    in the JAX package (its fused kernel has no quantize step). A bf16
    cache on the card takes K5, both in one launch; there ``rows`` must
    name distinct physical rows, as the batcher's do: a block reads the
    rows it writes from ``k_new``/``v_new``, not from another row's write
    in the same launch.
    """
    if k_scale is None:
        k_new = k_new.to(k_cache.dtype)
        v_new = v_new.to(v_cache.dtype)
        if q.device.type != "cpu" and k_cache.dtype == torch.bfloat16:
            return _fused_update(q, k_cache, v_cache, k_new, v_new, index, rows)
    write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows, k_scale=k_scale, v_scale=v_scale)
    return decode_attention(q, k_cache, v_cache, index + 1, rows, k_scale, v_scale)


decode_attention_update.launches = 0


def _fused_update(q, k_cache, v_cache, k_new, v_new, index, rows) -> torch.Tensor:
    """K5: K2's row write and K3's attention (lengths index + 1) in one launch."""
    b, hq, w, d = q.shape
    r, hkv, s, _ = k_cache.shape
    _check("q", q, (torch.bfloat16,))
    _check("k_cache", k_cache, (torch.bfloat16,))
    _check("v_cache", v_cache, (torch.bfloat16,), tuple(k_cache.shape))
    _check("k_new", k_new, (torch.bfloat16,), (b, hkv, w, d))
    _check("v_new", v_new, (torch.bfloat16,), (b, hkv, w, d))
    _check("index", index, (torch.int32,), (b,))
    if rows is not None:
        _check("rows", rows, (torch.int32,), (b,))
    elif b > r:
        raise ValueError(f"batch {b} exceeds the cache's {r} rows")
    _check_decode_shape("decode_attention_update", q, hkv, s)
    out = torch.empty_like(q)
    code = _lib.library().vtx_decode_attention_update(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        index.data_ptr(), _lib.ptr(rows), out.data_ptr(), b, hq, hkv, s, w, d, decode_splits(b, hkv, s),
        1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_decode_attention_update", code)
    decode_attention_update.launches += 1
    return out


def adopt_rows_reference(
    dst: torch.Tensor, src: torch.Tensor, rows: torch.Tensor, count: int, park_len: int
) -> torch.Tensor:
    """Plain in-place ``dst[rows[i], :, :park_len] = src[i, :, :park_len]``
    for each lane i < count, in lane order (the JAX package's scan); lanes at
    or past ``count`` write nothing."""
    for lane, row in enumerate(rows[:count].tolist()):
        dst[row, :, :park_len] = src[lane, :, :park_len]
    return dst


def adopt_rows(
    dst: torch.Tensor,
    src: torch.Tensor,
    rows: torch.Tensor,
    count: int,
    park_len: int,
    dst_v: torch.Tensor | None = None,
    src_v: torch.Tensor | None = None,
) -> None:
    """In place: dst[rows[i], :, :park_len] = src[i, :, :park_len] for each
    lane i < ``count`` (K4). src [lanes, Hkv, S_park, D], dst [R, Hkv, S, D],
    rows int32 [lanes]; ``dst_v``/``src_v``, a layer's v pool and its staged
    rows, are adopted in the same launch."""
    if (dst_v is None) != (src_v is None):
        raise ValueError("dst_v and src_v go together")
    pairs = [(dst, src)] + ([(dst_v, src_v)] if dst_v is not None else [])
    if dst.device.type == "cpu":
        for pool, staged in pairs:
            adopt_rows_reference(pool, staged, rows, count, park_len)
        return
    r, hkv, s, d = dst.shape
    lanes, _, s_park, _ = src.shape
    for name, pool, staged in (("", dst, src), ("_v", dst_v, src_v)):
        if pool is None:
            continue
        _check("dst" + name, pool, (dst.dtype,), (r, hkv, s, d))
        _check("src" + name, staged, (dst.dtype,), (lanes, hkv, s_park, d))
    _check("rows", rows, (torch.int32,), (lanes,))
    if not (0 <= count <= lanes and 0 <= park_len <= min(s, s_park)):
        raise ValueError(f"adopt_rows: count {count} of {lanes} lanes, park_len {park_len} of {min(s, s_park)}")
    if count == 0 or park_len == 0:
        return
    code = _lib.library().vtx_adopt_rows(
        dst.data_ptr(), _lib.ptr(dst_v), src.data_ptr(), _lib.ptr(src_v), rows.data_ptr(),
        lanes, count, r, hkv, s, s_park, park_len, d * dst.element_size(), _lib.stream(dst),
    )
    _lib.check("vtx_adopt_rows", code)
    adopt_rows.launches += 1


adopt_rows.launches = 0
