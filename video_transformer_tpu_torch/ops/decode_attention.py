"""Decode-step attention: K2 (cache row write) and K3 (paged decode attention).

Layout: q [B, Hq, W, D] (W = decode block width), caches [R, Hkv, S, D]
with R >= B, per-row cache offsets ``index`` [B] and optional ``rows`` [B]
mapping each logical row to its physical cache row. Query column j of row b
sees cache positions < index[b] + 1 + j.

``write_cache_rows`` wraps K2 (``csrc/write_cache_rows.cu``, replacing the
Pallas ``_batch_write_kernel``) and ``decode_attention`` wraps K3
(``csrc/decode_attention.cu``, replacing ``_kernel_pipelined``). Each takes
its plain version, ``update_cache_rows`` or ``decode_attention_reference``,
for CPU tensors only. ``decode_attention_update`` is the dispatch of the JAX
package's ``decode_attention_update``: for an int8 cache the new rows are
quantized before the write, and the per-head scales factor out of the
attention (q scaled by k_scale, the output by v_scale).
"""

from __future__ import annotations

import math

import torch

from . import _lib

__all__ = [
    "decode_attention",
    "decode_attention_reference",
    "decode_attention_update",
    "quantize_kv",
    "update_cache_rows",
    "write_cache_rows",
]

_NEG_INF = -1e30
_DECODE_TILE = 64  # cache positions per K3 tile (csrc/decode_attention.cu kBK)
_DECODE_BLOCKS = 264  # K3 splits the sequence to launch about this many blocks
_DECODE_MAX_SPLITS = 128  # csrc/decode_attention.cu kMaxSplits
_DECODE_MAX_ROWS = 16  # folded q rows G * W per kv head (csrc/decode_attention.cu kMaxRows)


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
) -> None:
    """In place: k/v_cache[rows[b], h, index[b] + j] = k/v_new[b, h, j] (K2)."""
    if k_cache.device.type == "cpu":
        update_cache_rows(k_cache, k_new, index, rows)
        update_cache_rows(v_cache, v_new, index, rows)
        return
    r, hkv, s, d = k_cache.shape
    b, _, w, _ = k_new.shape
    dtypes = (torch.int8, torch.bfloat16)
    _check("k_cache", k_cache, dtypes)
    _check("v_cache", v_cache, (k_cache.dtype,), tuple(k_cache.shape))
    _check("k_new", k_new, (k_cache.dtype,), (b, hkv, w, d))
    _check("v_new", v_new, (k_cache.dtype,), (b, hkv, w, d))
    _check("index", index, (torch.int32,), (b,))
    if rows is not None:
        _check("rows", rows, (torch.int32,), (b,))
    elif b > r:
        raise ValueError(f"batch {b} exceeds the cache's {r} rows")
    code = _lib.library().vtx_write_cache_rows(
        k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        index.data_ptr(), _lib.ptr(rows), b, hkv, s, w, d, k_cache.element_size(),
        _lib.stream(k_cache),
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
    if d != 128 or hq % hkv or (hq // hkv) * w > _DECODE_MAX_ROWS:
        raise ValueError(
            f"decode_attention: unsupported q {tuple(q.shape)} for {hkv} kv heads"
            f" (head_dim 128 and at most {_DECODE_MAX_ROWS} q rows per kv head)"
        )
    # Split the sequence so that about two blocks per SM stream the cache.
    tiles = -(-s // _DECODE_TILE)
    splits = max(1, min(tiles, -(-_DECODE_BLOCKS // (b * hkv)), _DECODE_MAX_SPLITS))
    tiles_per_split = -(-tiles // splits)
    splits = -(-tiles // tiles_per_split)
    rows_per_head = (hq // hkv) * w
    part_acc = torch.empty((b, hkv, splits, rows_per_head, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, hkv, splits, rows_per_head, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    code = _lib.library().vtx_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        _lib.ptr(rows), _lib.ptr(k_scale), _lib.ptr(v_scale), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), b, hq, hkv, s, w, d, splits,
        tiles_per_split, int(quantized), 1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_decode_attention", code)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


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

    For an int8 cache (``k_scale``/``v_scale`` given) the new rows are
    quantized under the layer's scales before the write.
    """
    if k_scale is not None:
        k_new = quantize_kv(k_new, k_scale)
        v_new = quantize_kv(v_new, v_scale)
    else:
        k_new = k_new.to(k_cache.dtype)
        v_new = v_new.to(v_cache.dtype)
    write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows)
    return decode_attention(q, k_cache, v_cache, index + 1, rows, k_scale, v_scale)
