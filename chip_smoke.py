"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``video_transformer_tpu_torch/csrc`` (one
``nvcc`` process per source, in parallel), counts the tensor-core
instructions of the flash kernels (K1, K7a-c) in the built library's SASS,
holds each kernel against its plain PyTorch version at the shapes of the
serving, batcher and training paths and times both (K1 also element by
element against f32-weight attention and at ragged lengths; K7b and K7c
also twice on the same inputs, bit for bit; K5 also bit for bit against K2
then K3; K3 and K5 also at 20-40 folded query rows per kv
head; K6, the packed-int4 matmul, at the 7b decoder's four product shapes,
bit for bit on integer inputs), checks
the whole model against the plain versions on the CPU at the tiny preset
(serving logits, the same with a narrow int4 decoder whose every projection
takes K6, then training gradients), then:

- serves three requests through ``InferenceEngine.generate`` at the full
  ``base`` width (int8 weights, int8 KV cache, BPE vocabulary, the note
  grammar, greedy) with seeded random weights, shows that the requests went
  through K1-K3, and profiles one short request (device busy share, top
  device ops);
- serves twelve requests through ``ContinuousBatcher`` (8 slots, a ring of
  16 parked requests, bf16 KV pool, device refill) on the same weights,
  shows that the one stage adopted its prefills through K4 and every decode
  step went through K5, holds the first-token logits against
  ``engine.generate``'s and the first wave's tokens against
  ``engine.generate`` at the batcher's batch of 8, and profiles a short
  sweep;
- trains five steps of ``python -m video_transformer_tpu_torch.train.run``'s
  code path at the full ``base`` width (seeded random f32 weights, bf16
  compute, BPE vocabulary, batch 2, 1,024 video + 2,048 text positions),
  shows that every step ran 36 launches each of K7a, K7b and K7c and no
  reference backward, profiles one step, and saves and restores a
  checkpoint in a temporary directory;
- serves one batch of two 16-frame clips through ``InferenceEngine.generate``
  at the full ``7b`` width (seeded random weights, bf16, int4 weights, int8
  KV cache, the same vocabulary and grammar, greedy), after holding K1-K3 at
  its shapes, shows that every decode step ran K6 for each of the 7
  projections of each of the 28 layers and prefill none, and profiles a
  32-token call.

It prints one JSON object per line, flushed; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (exit code 1). It
needs a CUDA device and exits with an error without one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import VLMConfig, get_preset
from video_transformer_tpu_torch.models.lm import init_kv_cache
from video_transformer_tpu_torch.models.quant import quantize_decoder
from video_transformer_tpu_torch.ops import _lib
from video_transformer_tpu_torch.ops import flash_bwd as flash_bwd_module
from video_transformer_tpu_torch.ops.attention import flash_attention, mha_reference
from video_transformer_tpu_torch.ops.decode_attention import (
    _decode_buffers,
    _scaled_reference,
    adopt_rows,
    adopt_rows_reference,
    decode_attention,
    decode_attention_update,
    update_cache_rows,
    write_cache_rows,
)
from video_transformer_tpu_torch.ops.flash_bwd import (
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_fwd_lse,
    flash_fwd_lse_reference,
)
from video_transformer_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_reference, unpack_int4
from video_transformer_tpu_torch.ops.preprocess import preprocess_frames
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.train.data import synthetic_batch
from video_transformer_tpu_torch.train.run import build_parser, make_prompt_sampler, prepare, setup_logging
from video_transformer_tpu_torch.train.trainer import distillation_loss
from video_transformer_tpu_torch.weights import random_params

REPO = Path(__file__).resolve().parent
TOKENIZER = REPO / "data" / "tokenizers" / "bpe-zh-2048.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
MAX_NEW_TOKENS = 256  # capped for the smoke; the shipped config says 4096
PROMPT = "分析这段视频的内容，写出结构化的知识笔记。"
KERNELS = (flash_attention, write_cache_rows, decode_attention)  # the serving path's
BATCHER_KERNELS = (adopt_rows, decode_attention_update)  # with K1; the bf16 pool takes no K2 or K3
BATCHER_SLOTS = 8  # the shipped serving_slots_per_chip; queue_depth defaults to 16
BATCHER_REQUESTS = 12  # two waves through 8 slots
# The batcher stages min(queued, queue_depth, free rows) requests at once; the
# ring (2 * slots) and the free rows (at least queue_depth) hold all twelve.
BATCHER_STAGE = min(BATCHER_REQUESTS, 2 * BATCHER_SLOTS)
TRAIN_KERNELS = (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv)
INT4_KERNELS = (int4_matmul,)  # with K1-K3 on the int4 serving path
ALL_KERNELS = KERNELS + BATCHER_KERNELS + TRAIN_KERNELS + INT4_KERNELS
# The 7b decoder's packed-int4 products (K/2, N), each run at decode M = batch
# 2 x block width 3: q and out, k and v, gate and up, down.
INT4_SHAPES = {"q_out": (1792, 3584), "k_v": (1792, 512), "gate_up": (1792, 18944), "down": (9472, 3584)}
INT4_DECODE_ROWS = 6
INT4_WIDE_ROWS = (24, 256)  # the batcher's 8 slots x 3, and the top of K6's dispatch (gate shape)
# A decoder narrow enough to run on the CPU whose every projection takes K6
# (N and K/2 multiples of 128): the int4 whole-model reference.
INT4_NARROW = dict(hidden_dim=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128, mlp_dim=512)
# K1 and K3 accumulate in f32 and round their output to bf16 once, as their
# plain versions do (K1 multiplies bf16 tiles on the tensor cores and carries
# P as bf16 P_hi + P_lo, within 2**-16 of P from f32). One rounding step is at
# most 2**-7 of the value, so the two agree within 1e-2 of the largest output.
REL_TOL = 1e-2
# K1 and K7a-c are also held element by element: |got - want| <= rel *
# |want| + floor * rms(want), so that an error confined to small
# late-position values fails as surely as one at the large early ones (K1
# against plain attention with f32 weights: mha_reference's own bf16 weights
# sit several times outside this limit, as bf16 P alone does in
# tests/test_torch_flash_numerics.py). K1 and K7a-c run bf16 products with
# f32 accumulation on the tensor cores, P split as above, and K7b and K7c
# dS as well (bf16 dS and P alone miss these limits several to hundreds of
# times over, tests/test_torch_flash_bwd_numerics.py). O and dQ are rounded
# to bf16 once, as their plain versions are: the two roundings differ by at
# most one bf16 step (2**-7 of the value), and the floor covers values that
# cancel to near zero.
BF16_TOL = (1e-2, 1e-3)
# K7c's dK/dV partials stay f32 in both; with dS and P split they differ by
# about 2**-16 of each product's terms and in summation order (0.1-0.3 of
# this limit in the CPU model of the kernels' arithmetic).
F32_TOL = (1e-3, 1e-4)
# K7a's LSE is f32 in both; the kernel's exp2/logf and summation order
# move it by far less than 1e-3 at |LSE| ~ 10.
LSE_TOL = 1e-3
# Training gradients of the tiny model, bf16 compute: card against CPU, the
# largest per-tensor ||g_card - g_cpu|| / ||g_cpu||, on GRAD_SEEDS seeds. On
# an H100 (seeds 0-3) the card reads 1.2-1.4% against the CPU, the CPU's bf16
# noise floor (bf16 against f32 compute) 1.4-1.7%, and a flash mask shifted
# by one position 11.7-15.2%: the limit sits about 3x from either side.
GRAD_REL_TOL = 4e-2
GRAD_SEEDS = 4
TRAIN_STEPS = 5
TRAIN_ARGS = [  # the training CLI at base width, as a user would call it
    "--preset", "base", "--tokenizer", str(TOKENIZER), "--batch", "2", "--text-len", "2048",
    "--steps", str(TRAIN_STEPS), "--device", "cuda",
]


def emit(obj: dict) -> None:
    print(json.dumps(obj, ensure_ascii=False), flush=True)


def time_ms(fn, warmup: int = 3, reps: int = 10, rounds: int = 20) -> float:
    """Time of one call of ``fn`` in ms: CUDA events around ``reps`` calls
    back to back, divided by ``reps``; the median of ``rounds`` such runs,
    after warm-up. Where launching takes longer than the work, this is the
    launch rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, calls: int = 20, tries: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: the self device time of the
    kernels it launches, summed by torch.profiler over ``calls`` calls, after
    one warm-up call. Unlike ``time_ms`` it leaves out the host's time between
    launches, which sets ``time_ms`` where a call's kernels are short. A
    profile that records no device activity at all (CUPTI has dropped a
    short window's records) is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if total:
            return total / 1e3 / calls
    raise AssertionError(f"device_ms: the profiler saw no device time in {tries} tries")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and which resource sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flash_sass() -> dict[str, dict[str, int]]:
    """Tensor-core instructions in each flash kernel of the built library
    (K1 is flash_fwd_kernel<false>, K7a <true>; K7b flash_bwd_dq_kernel, K7c
    flash_bwd_dkv_kernel), counted in ``cuobjdump -sass``: HGMMA (wgmma) and
    HMMA (mma.sync). Raises if a kernel is missing or has no HGMMA."""
    cuobjdump = Path(_lib._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", _lib.library()._name], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            function = line.split("Function : ", 1)[1].strip()
            name = None
            if "flash_fwd_kernel" in function:
                name = "K1 flash_fwd_kernel<false>" if "ILb0E" in function else "K7a flash_fwd_kernel<true>"
            elif "flash_bwd_dq_kernel" in function:
                name = "K7b flash_bwd_dq_kernel"
            elif "flash_bwd_dkv_kernel" in function:
                name = "K7c flash_bwd_dkv_kernel"
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    if len(counts) != 4 or not all(c["HGMMA"] for c in counts.values()):
        raise AssertionError(f"a flash kernel runs no wgmma instruction: {counts}")
    return counts


def base_config(vocab_size: int, preset: str = "base") -> VLMConfig:
    cfg = get_preset(preset)
    return replace(cfg, decoder=replace(cfg.decoder, vocab_size=vocab_size))


# -- kernel phase ----------------------------------------------------------------


def attention_f32_weights(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                          shift: int = 0) -> torch.Tensor:
    """Plain attention with f32 softmax weights: mha_reference's formula
    without its bf16 cast of the weights, the output rounded once to q's
    dtype (as K7a's plain version rounds it). The causal edge is aligned to
    the last Sq keys and moved ``shift`` keys later: a query sees ``shift``
    keys more, the fault K1's check must catch."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, s_q, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        q_pos = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q) + shift
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        logits = logits.masked_fill(k_pos > q_pos, -1e30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(logits, dim=-1), v.float())
    return out.reshape(b, hq, s_q, d).to(q.dtype)


def flash_errors(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> dict:
    """K1 on (q, k, v): within REL_TOL of the largest output of
    mha_reference, and element by element within BF16_TOL of plain attention
    with f32 weights; where causal, that plain version with its mask shifted
    by one key must fail the element-wise check. Raises otherwise; returns
    the readings and K1's output."""
    shape = f"q {list(q.shape)} kv {list(k.shape)} bf16 causal={causal}"
    out = flash_attention(q, k, v, causal=causal)
    ref = mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    if not bool(out.isfinite().all()) or err > tol:
        raise AssertionError(f"flash_attention ({shape}) disagrees with mha_reference: {err} > {tol}")
    close = closeness(out, attention_f32_weights(q, k, v, causal), *BF16_TOL)
    if not close["ratio"] <= 1:
        raise AssertionError(f"flash_attention ({shape}) disagrees with f32-weight attention: {close}")
    result = {"out": out, "max_abs_err": err, "tol": tol, "worst_ratio": close["ratio"],
              "elementwise_max_abs_err": close["max_abs_err"], "shape": shape}
    if causal:
        shifted = closeness(out, attention_f32_weights(q, k, v, causal, shift=1), *BF16_TOL)
        if shifted["ratio"] <= 1:
            raise AssertionError(f"a mask shifted by one passes K1's check ({shape}): {shifted}")
        result["shifted_mask_ratio"] = shifted["ratio"]
    return result


def check_flash(gen: torch.Generator, dev: torch.device, batch: int, heads: int, kv_heads: int,
                seq: int, causal: bool) -> dict:
    """K1 at one attention shape (``flash_errors``); times and bound."""
    d = 128
    q = torch.randn(batch, heads, seq, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(batch, kv_heads, seq, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(batch, kv_heads, seq, d, generator=gen, device=dev).to(torch.bfloat16)
    result = flash_errors(q, k, v, causal)
    out = result.pop("out")
    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    flops = 4 * batch * heads * d * pairs
    bound_ms, bound_by = bound(nbytes(q, k, v, out), flops)
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=kv_heads != heads)
    )
    return dict(
        result,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms(lambda: mha_reference(q, k, v, causal=causal), warmup=1, reps=2),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
    )


# Ragged (Sq, Sk) for K1 beside the main paths' shapes: neither a multiple
# of the 128-row tile; Sq < Sk (the causal edge at q_offset = Sk - Sq, which
# is 1152 for (3, 1155): not a multiple of the tile); one row past a tile.
FLASH_RAGGED_SHAPES = ((100, 100), (64, 200), (3, 1155), (129, 129))


def flash_ragged_reading(gen: torch.Generator, dev: torch.device, heads: int, kv_heads: int) -> dict:
    """K1 at every ``FLASH_RAGGED_SHAPES`` entry, causal and not, batch 2;
    the worst element-wise ratio and the smallest shifted-mask ratio."""
    readings = []
    for s_q, s_k in FLASH_RAGGED_SHAPES:
        for causal in (True, False):
            q = torch.randn(2, heads, s_q, 128, generator=gen, device=dev).to(torch.bfloat16)
            k, v = (torch.randn(2, kv_heads, s_k, 128, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            result = flash_errors(q, k, v, causal)
            result.pop("out")
            readings.append(result)
    return {"checks": readings, "worst_ratio": max(r["worst_ratio"] for r in readings),
            "min_shifted_mask_ratio": min(r["shifted_mask_ratio"] for r in readings if "shifted_mask_ratio" in r)}


def kernel_phase(seed: int, dev: torch.device, cfg: VLMConfig, prompt_bucket: int, cache_len: int,
                 park_len: int | None) -> dict:
    """K1-K3 at the serving path's shapes, held against their plain
    versions; K1 also at the batcher's staging prefill (``BATCHER_STAGE``
    rows of ``park_len`` positions: the video and the whole prompt block,
    whatever each row's prompt bucket, which sets only its cache index and
    its logits position) unless ``park_len`` is None."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc, dec = cfg.encoder, cfg.decoder
    batch, width = 2, 3
    results = {}

    prefill_seq = cfg.video_tokens + prompt_bucket
    k1 = check_flash(gen, dev, batch, dec.num_heads, dec.num_kv_heads, prefill_seq, causal=True)
    k1_enc = check_flash(gen, dev, batch, enc.num_heads, enc.num_heads, enc.tokens_per_clip, causal=False)
    others = {"encoder": k1_enc}
    if park_len is not None:
        others["staging"] = check_flash(gen, dev, BATCHER_STAGE, dec.num_heads, dec.num_kv_heads, park_len,
                                        causal=True)
    for prefix, other in others.items():
        for key in ("max_abs_err", "tol", "worst_ratio", "shifted_mask_ratio", "ms", "plain_ms", "bound_ms",
                    "library_ms", "shape"):
            if key in other:
                k1[f"{prefix}_{key}"] = other[key]
    ragged = flash_ragged_reading(gen, dev, dec.num_heads, dec.num_kv_heads)
    emit({"phase": "flash_ragged", "preset": cfg.name, **ragged})
    k1["ragged_worst_ratio"] = ragged["worst_ratio"]
    k1["ragged_min_shifted_mask_ratio"] = ragged["min_shifted_mask_ratio"]
    results["flash_attention"] = k1

    # K2: int8 rows into int8 caches at per-row offsets, through a row table.
    hkv, d = dec.num_kv_heads, dec.head_dim
    phys_rows = batch + 1
    k_cache = torch.randint(-127, 128, (phys_rows, hkv, cache_len, d), generator=gen, device=dev, dtype=torch.int8)
    v_cache = torch.randint(-127, 128, (phys_rows, hkv, cache_len, d), generator=gen, device=dev, dtype=torch.int8)
    k_new = torch.randint(-127, 128, (batch, hkv, width, d), generator=gen, device=dev, dtype=torch.int8)
    v_new = torch.randint(-127, 128, (batch, hkv, width, d), generator=gen, device=dev, dtype=torch.int8)
    index = torch.tensor([prefill_seq + 47, prefill_seq + 198], dtype=torch.int32, device=dev)
    rows = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows)
    update_cache_rows(k_ref, k_new, index, rows)
    update_cache_rows(v_ref, v_new, index, rows)
    torch.cuda.synchronize()
    err = max((k_cache.int() - k_ref.int()).abs().max().item(), (v_cache.int() - v_ref.int()).abs().max().item())
    if err != 0:
        raise AssertionError(f"write_cache_rows differs from update_cache_rows by {err}")
    bound_ms, bound_by = bound(2 * nbytes(k_new, v_new) + nbytes(index, rows), 0)
    results["write_cache_rows"] = {
        "max_abs_err": err, "tol": 0,
        "ms": time_ms(lambda: write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows)),
        "plain_ms": time_ms(lambda: (update_cache_rows(k_ref, k_new, index, rows),
                                     update_cache_rows(v_ref, v_new, index, rows))),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": f"caches int8 [{phys_rows},{hkv},{cache_len},{d}] new int8 [{batch},{hkv},{width},{d}] rows=[2,0]",
    }

    # K3: int8 caches, W = 3, ragged lengths, a row permutation. k_scale is
    # that of a cache whose k values reach about 5 (x 1.5 / 127), so that the
    # softmax is peaked as in serving and not flat.
    q = torch.randn(batch, dec.num_heads, width, d, generator=gen, device=dev).to(torch.bfloat16)
    k_scale = torch.rand(hkv, generator=gen, device=dev) * 0.04 + 0.02
    v_scale = torch.rand(hkv, generator=gen, device=dev) * 0.04 + 0.02
    lengths = index + 1
    out = decode_attention(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)
    ref = _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    if err > tol:
        raise AssertionError(f"decode_attention disagrees with its plain version: {err} > {tol}")
    # The causal edge: row 0's edge straddles a 64-position tile boundary.
    edge_lengths = torch.tensor([64 * (prefill_seq // 64 + 1) - 1, int(lengths[1])], dtype=torch.int32, device=dev)
    eq, ek, ev = q.clone(), k_cache.clone(), v_cache.clone()
    expected = mark_decode_edges(eq, ek, ev, edge_lengths, rows, v_scale)
    edge_out = decode_attention(eq, ek, ev, edge_lengths, rows, k_scale, v_scale)
    edge_ref = _scaled_reference(eq, ek, ev, edge_lengths, rows, k_scale, v_scale)
    torch.cuda.synchronize()
    edge_tol = REL_TOL * expected.abs().max().item()
    edge_err = (edge_out.float() - expected).abs().max().item()
    edge_ref_err = (edge_ref.float() - expected).abs().max().item()
    if max(edge_err, edge_ref_err) > edge_tol:
        raise AssertionError(f"decode_attention at the causal edge: kernel {edge_err}, plain {edge_ref_err} > {edge_tol}")
    group = dec.num_heads // hkv
    visible = sum(int(n) + width - 1 for n in lengths.tolist())  # positions read per kv head
    cache_bytes = 2 * hkv * visible * d  # int8 k and v
    flops = sum(4 * group * d * (int(n) + j) for n in lengths.tolist() for j in range(width)) * hkv
    bound_ms, bound_by = bound(cache_bytes + 2 * nbytes(q) + nbytes(lengths, rows, k_scale, v_scale), flops)
    results["decode_attention"] = {
        "max_abs_err": err, "tol": tol, "edge_max_abs_err": edge_err, "edge_tol": edge_tol,
        "ms": time_ms(lambda: decode_attention(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)),
        "plain_ms": time_ms(lambda: _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": (f"q bf16 [{batch},{dec.num_heads},{width},{d}] caches int8 [{phys_rows},{hkv},{cache_len},{d}]"
                  f" lengths={lengths.tolist()} rows=[2,0]"),
    }
    return results


DECODE_ROW_SHAPES = ((4, 5), (7, 3), (4, 7), (8, 5))  # (group, W): 20, 21, 28 and 40 rows per kv head


def decode_rows_reading(gen: torch.Generator, dev: torch.device, cache_len: int, group: int, width: int,
                        dtype: torch.dtype) -> dict:
    """K3 at ``group * width`` folded q rows per kv head (more than 16 take
    several row chunks), against its plain version and at the causal edge;
    on a bf16 cache also K5, bit for bit against K2 then K3, with row 0's
    new positions across a split edge (only the chunk-0 blocks store them,
    the other chunks' blocks read them from k_new/v_new). Raises past the
    tolerance or on any bit of difference."""
    hkv, d, batch = 2, 128, 2
    q = torch.randn(batch, group * hkv, width, d, generator=gen, device=dev).to(torch.bfloat16)
    if dtype == torch.int8:
        k_cache, v_cache = (torch.randint(-127, 128, (3, hkv, cache_len, d), generator=gen, device=dev,
                                          dtype=torch.int8) for _ in range(2))
        k_scale = torch.rand(hkv, generator=gen, device=dev) * 0.04 + 0.02
        v_scale = torch.rand(hkv, generator=gen, device=dev) * 0.04 + 0.02
    else:
        k_cache, v_cache = (torch.randn(3, hkv, cache_len, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        k_scale = v_scale = None
    rows = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    lengths = torch.tensor([cache_len // 2 + 7, cache_len - width - 3], dtype=torch.int32, device=dev)
    out = decode_attention(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)
    ref = _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)
    edge_lengths = torch.tensor([64 * 3 - 1, cache_len // 2], dtype=torch.int32, device=dev)
    expected = mark_decode_edges(q, k_cache, v_cache, edge_lengths, rows, v_scale)
    edge_out = decode_attention(q, k_cache, v_cache, edge_lengths, rows, k_scale, v_scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    edge_err = (edge_out.float() - expected).abs().max().item()
    edge_tol = REL_TOL * expected.abs().max().item()
    if err > tol or edge_err > edge_tol:
        raise AssertionError(f"decode_attention at {group * width} rows per kv head ({dtype}):"
                             f" {err} > {tol} or edge {edge_err} > {edge_tol}")
    reading = {"rows_per_kv_head": group * width, "group": group, "width": width,
               "cache": str(dtype).removeprefix("torch."), "max_abs_err": err, "tol": tol,
               "edge_max_abs_err": edge_err, "edge_tol": edge_tol}
    if dtype != torch.bfloat16:
        return reading
    q = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)  # the edge check set q to ones
    k_new, v_new = (torch.randn(batch, hkv, width, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    split_len = _decode_buffers(q, hkv, cache_len)[4] * 64
    index = torch.tensor([split_len - 1, cache_len - width - 5], dtype=torch.int32, device=dev)
    k2, v2 = k_cache.clone(), v_cache.clone()
    out = decode_attention_update(q, k_cache, v_cache, k_new, v_new, index, rows)
    write_cache_rows(k2, v2, k_new, v_new, index, rows)
    want = decode_attention(q, k2, v2, index + 1, rows)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(k_cache, k2) and torch.equal(v_cache, v2)):
        raise AssertionError(f"decode_attention_update (K5) at {group * width} rows per kv head"
                             " is not bit-equal to K2 + K3")
    return dict(reading, k5_bit_equal_to_k2_k3=True, k5_index=index.tolist())


def batcher_kernel_phase(seed: int, dev: torch.device, cfg: VLMConfig, park_len: int, cache_len: int,
                         slots: int, pool_rows: int) -> dict:
    """K4 and K5 at the batcher's base shapes (bf16 pool of ``pool_rows``
    rows, ``slots`` decode lanes, W = 3, one stage of ``BATCHER_STAGE``
    lanes), each held against its plain version; K5 also against K2 then K3
    on copies of the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    dec = cfg.decoder
    hkv, d, width = dec.num_kv_heads, dec.head_dim, 3
    results = {}

    # K4: the stage's valid lanes, checked with one pad lane more whose row
    # collides with lane 0's; timed at the stage's own launch (no pad lane).
    count, lanes = BATCHER_STAGE, BATCHER_STAGE + 1
    pool_k, pool_v = (torch.randn(pool_rows, hkv, cache_len, d, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2))
    src_k, src_v = (torch.randn(lanes, hkv, park_len, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    perm = torch.randperm(pool_rows, generator=torch.Generator().manual_seed(seed))[:count].tolist()
    rows = torch.tensor(perm + [perm[0]], dtype=torch.int32, device=dev)
    ref_k, ref_v = pool_k.clone(), pool_v.clone()
    orig_k = pool_k.clone()
    adopt_rows(pool_k, src_k, rows, count, park_len, pool_v, src_v)
    adopt_rows_reference(ref_k, src_k, rows, count, park_len)
    adopt_rows_reference(ref_v, src_v, rows, count, park_len)
    torch.cuda.synchronize()
    err = max((pool_k.float() - ref_k.float()).abs().max().item(), (pool_v.float() - ref_v.float()).abs().max().item())
    untargeted = [r for r in range(pool_rows) if r not in perm]
    if err != 0 or not torch.equal(pool_k[:, :, park_len:], orig_k[:, :, park_len:]) \
            or not torch.equal(pool_k[untargeted], orig_k[untargeted]) \
            or not torch.equal(pool_k[perm[0], :, :park_len], src_k[0]):
        raise AssertionError(f"adopt_rows differs from adopt_rows_reference by {err}, or wrote outside its rows")
    valid = rows[:count].long()
    stage_src_k, stage_src_v, stage_rows = src_k[:count], src_v[:count], rows[:count]

    def library_adopt():
        pool_k[valid, :, :park_len] = src_k[:count]
        pool_v[valid, :, :park_len] = src_v[:count]

    bound_ms, bound_by = bound(2 * 2 * count * hkv * park_len * d * 2 + nbytes(rows), 0)
    results["adopt_rows"] = {
        "max_abs_err": err, "tol": 0,
        "ms": time_ms(lambda: adopt_rows(pool_k, stage_src_k, stage_rows, count, park_len, pool_v, stage_src_v)),
        "plain_ms": time_ms(lambda: (adopt_rows_reference(ref_k, stage_src_k, stage_rows, count, park_len),
                                     adopt_rows_reference(ref_v, stage_src_v, stage_rows, count, park_len))),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library_adopt),
        "library": "two index_put_ (dst[rows[:count], :, :park_len] = src[:count]), k and v",
        "shape": (f"pools bf16 [{pool_rows},{hkv},{cache_len},{d}] x2, src [{count},{hkv},{park_len},{d}] x2,"
                  f" count {count} (checked with a pad lane on lane 0's row)"),
    }

    # K5: rows a permutation of pool rows; index of slot 0 puts its W new
    # positions across a split boundary, slot 1's across a tile boundary.
    q = torch.randn(slots, dec.num_heads, width, d, generator=gen, device=dev).to(torch.bfloat16)
    k_new, v_new = (torch.randn(slots, hkv, width, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    _, _, _, splits, tiles_per_split = _decode_buffers(q, hkv, cache_len)
    split_len = tiles_per_split * 64
    index = torch.tensor([split_len * (park_len // split_len + 1) - 1, park_len // split_len * split_len + 62]
                         + [park_len - 128 + 37 * i for i in range(2, slots)], dtype=torch.int32, device=dev)
    rows = torch.tensor(perm[:slots], dtype=torch.int32, device=dev)
    fused_k, fused_v = pool_k.clone(), pool_v.clone()
    split_k, split_v = pool_k.clone(), pool_v.clone()
    plain_k, plain_v = pool_k.clone(), pool_v.clone()
    out = decode_attention_update(q, fused_k, fused_v, k_new, v_new, index, rows)
    write_cache_rows(split_k, split_v, k_new, v_new, index, rows)
    split_out = decode_attention(q, split_k, split_v, index + 1, rows)
    update_cache_rows(plain_k, k_new, index, rows)
    update_cache_rows(plain_v, v_new, index, rows)
    ref = _scaled_reference(q, plain_k, plain_v, index + 1, rows, None, None)
    torch.cuda.synchronize()
    if not (torch.equal(out, split_out) and torch.equal(fused_k, split_k) and torch.equal(fused_v, split_v)):
        raise AssertionError("decode_attention_update (K5) is not bit-equal to K2 + K3")
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    if err > tol:
        raise AssertionError(f"decode_attention_update (K5) disagrees with its plain version: {err} > {tol}")
    # The causal edge, with the step's new rows carrying the marks.
    ek, ev = pool_k.clone(), pool_v.clone()
    eq = q.clone()
    expected = mark_decode_edges(eq, ek, ev, index + 1, rows)
    pos = index.long()[:, None] + torch.arange(width, device=dev)
    ek_new = ek[rows.long()[:, None], :, pos].transpose(1, 2).contiguous()
    ev_new = ev[rows.long()[:, None], :, pos].transpose(1, 2).contiguous()
    edge_out = decode_attention_update(eq, ek, ev, ek_new, ev_new, index, rows)
    torch.cuda.synchronize()
    edge_err = (edge_out.float() - expected).abs().max().item()
    edge_tol = REL_TOL * expected.abs().max().item()
    if edge_err > edge_tol:
        raise AssertionError(f"decode_attention_update (K5) at the causal edge: {edge_err} > {edge_tol}")
    group = dec.num_heads // hkv
    visible = sum(int(n) + width for n in index.tolist())  # positions read per kv head
    flops = sum(4 * group * d * (int(n) + 1 + j) for n in index.tolist() for j in range(width)) * hkv
    nbytes_k5 = 2 * hkv * visible * d * 2 + 2 * nbytes(q) + 2 * nbytes(k_new, v_new) + nbytes(index, rows)
    bound_ms, bound_by = bound(nbytes_k5, flops)

    def plain_update():
        update_cache_rows(plain_k, k_new, index, rows)
        update_cache_rows(plain_v, v_new, index, rows)
        return _scaled_reference(q, plain_k, plain_v, index + 1, rows, None, None)

    results["decode_attention_update"] = {
        "max_abs_err": err, "tol": tol, "edge_max_abs_err": edge_err, "edge_tol": edge_tol,
        "bit_equal_to_k2_k3": True, "splits": splits, "split_positions": split_len,
        "ms": time_ms(lambda: decode_attention_update(q, fused_k, fused_v, k_new, v_new, index, rows)),
        "k2_k3_ms": time_ms(lambda: (write_cache_rows(split_k, split_v, k_new, v_new, index, rows),
                                     decode_attention(q, split_k, split_v, index + 1, rows))),
        "plain_ms": time_ms(plain_update),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call writes the cache rows and attends",
        "shape": (f"q bf16 [{slots},{dec.num_heads},{width},{d}] pools bf16 [{pool_rows},{hkv},{cache_len},{d}]"
                  f" index={index.tolist()} rows={perm[:slots]}"),
    }
    results["decode_attention_rows"] = [decode_rows_reading(gen, dev, cache_len, group, width, dtype)
                                        for group, width in DECODE_ROW_SHAPES
                                        for dtype in (torch.bfloat16, torch.int8)]
    return results


def mark_decode_edges(q, k_cache, v_cache, lengths, rows, v_scale=None) -> torch.Tensor:
    """Rewrite q and the caches in place so that each row's attention is
    decided by the W + 1 positions around its causal edge, and return the
    output exact masking gives, f32 [B, Hq, W, D].

    q becomes all ones; at positions lengths[b] - 1 + o (o = 0..W) of the
    row's physical cache row every k element is large (its score dwarfs
    every other position's) and v is (o + 1) * step with alternating signs
    across D. Query column j sees positions < lengths[b] + j, i.e. offsets
    0..j, so it puts out (j + 2) / 2 * step * sign (times v_scale). A column
    that sees one position more or less, or misses a 64-position tile, is
    off by a quarter or more of that value.
    """
    b, hq, width, d = q.shape
    hkv = k_cache.shape[1]
    quantized = k_cache.dtype == torch.int8
    # int8 v must hold (W + 1) * step: 25 up to W = 4, less for wider blocks.
    k_hi, step = (127, float(min(25, 127 // (width + 1)))) if quantized else (4.0, 1.0)
    sign = torch.ones(d, device=q.device)
    sign[1::2] = -1
    q.fill_(1)
    phys = rows.tolist() if rows is not None else list(range(b))
    for row, n in zip(phys, lengths.tolist()):
        for o in range(width + 1):
            k_cache[row, :, n - 1 + o] = k_hi
            v_cache[row, :, n - 1 + o] = ((o + 1) * step * sign).to(v_cache.dtype)
    cols = (torch.arange(width, device=q.device, dtype=torch.float32) + 2) / 2 * step
    expected = cols[None, None, :, None] * sign[None, None, None, :]
    if v_scale is not None:
        expected = expected * v_scale.float().repeat_interleave(hq // hkv)[None, :, None, None]
    return expected.expand(b, hq, width, d)


def closeness(got: torch.Tensor, want: torch.Tensor, rel: float, floor: float) -> dict:
    """How far ``got`` is from ``want`` under the element-wise limit
    ``rel * |want| + floor * rms(want)``: the largest absolute error, and the
    largest ratio of error to limit (at most 1 passes), over all positions
    and over the second half of them (rows S/2 and later)."""
    want = want.float()
    diff = (got.float() - want).abs()
    ratio = diff / (rel * want.abs() + floor * want.square().mean().sqrt())
    return {"max_abs_err": diff.max().item(), "ratio": ratio.max().item(),
            "late_ratio": ratio[..., ratio.shape[-2] // 2:, :].max().item()}


@contextlib.contextmanager
def shifted_causal_mask(shift: int):
    """The port's plain flash versions with the causal mask moved by
    ``shift`` positions (each query sees ``shift`` keys more): the fault that
    the checks of K7a-c must catch."""
    original = flash_bwd_module._logits

    def shifted(q, k, causal):
        logits = original(q, k, causal=False)
        if causal:
            pos = torch.arange(q.shape[2], device=q.device)
            logits = logits.masked_fill(pos[None, :] > pos[:, None] + shift, flash_bwd_module._NEG_INF)
        return logits

    with mock.patch.object(flash_bwd_module, "_logits", shifted):
        yield


def flash_train_errors(q, k, v, dout, causal: bool) -> dict:
    """K7a, K7b and K7c against their plain versions on the same inputs (the
    backward kernels and their plain versions both take K7a's O and LSE).
    Raises past a tolerance; returns the errors and the kernels' outputs.
    Where causal, it also holds the kernels against plain versions whose
    mask is shifted by one position, and raises if that passes the check."""
    shape = f"q {list(q.shape)} kv {list(k.shape)} bf16 causal={causal}"
    out, lse = flash_fwd_lse(q, k, v, causal)
    dsum = (dout.float() * out.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, dout, lse, dsum, causal)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, dsum, causal)

    def plain() -> tuple[torch.Tensor, ...]:
        ref_out, ref_lse = flash_fwd_lse_reference(q, k, v, causal)
        ref_dq = flash_bwd_dq_reference(q, k, v, dout, lse, dsum, causal)
        return (ref_out, ref_dq, *flash_bwd_dkv_reference(q, k, v, dout, lse, dsum, causal), ref_lse)

    def compare(wants) -> dict[str, dict]:
        *wants, ref_lse = wants
        tols = (BF16_TOL, BF16_TOL, F32_TOL, F32_TOL)
        result = {name: closeness(got, want, *tol)
                  for name, got, want, tol in zip(("O", "dQ", "dK", "dV"), (out, dq, dk, dv), wants, tols)}
        result["LSE"] = {"max_abs_err": (lse - ref_lse).abs().max().item()}
        result["LSE"]["ratio"] = result["LSE"]["max_abs_err"] / LSE_TOL
        return result

    errors = {"shape": shape, "out": out, "lse": lse, "dsum": dsum, "dq": dq, "dk": dk, "dv": dv,
              "checks": compare(plain())}
    for name, check in errors["checks"].items():
        if not check["ratio"] <= 1:
            raise AssertionError(f"{name} ({shape}) disagrees with its plain version: {check}")
    if causal:
        with shifted_causal_mask(1):
            errors["shifted_mask"] = compare(plain())
        caught = [name for name, check in errors["shifted_mask"].items() if check["ratio"] > 1]
        if caught != list(errors["shifted_mask"]):
            raise AssertionError(f"a mask shifted by one passes the check of {errors['shifted_mask']}")
    return errors


def flash_bwd_repeatable(q, k, v, dout, lse, dsum, causal: bool) -> dict[str, bool]:
    """Whether two launches each of K7b and K7c on the same inputs give
    bit-identical dQ, dK and dV (they use no atomics)."""
    runs = [(flash_bwd_dq(q, k, v, dout, lse, dsum, causal), *flash_bwd_dkv(q, k, v, dout, lse, dsum, causal))
            for _ in range(2)]
    return {name: torch.equal(a, b) for name, a, b in zip(("dQ", "dK", "dV"), *runs)}


def check_flash_train(gen: torch.Generator, dev: torch.device, batch: int, heads: int, kv_heads: int,
                      seq: int, causal: bool) -> dict[str, dict]:
    """K7a, K7b and K7c against their plain versions at one training shape;
    times and bounds."""
    d = 128
    q, k, v, dout = (
        torch.randn(batch, h, seq, d, generator=gen, device=dev).to(torch.bfloat16)
        for h in (heads, kv_heads, kv_heads, heads)
    )
    e = flash_train_errors(q, k, v, dout, causal)
    out, lse, dsum, dq, dk, dv = (e[key] for key in ("out", "lse", "dsum", "dq", "dk", "dv"))
    repeatable = flash_bwd_repeatable(q, k, v, dout, lse, dsum, causal)
    if not all(repeatable.values()):
        raise AssertionError(f"K7b/K7c ({e['shape']}): a second launch gives other bits: {repeatable}")

    def check(*names: str) -> dict:
        """The check's readings for the named outputs, and the shifted mask's."""
        fields = {"max_abs_err": max(e["checks"][n]["max_abs_err"] for n in names),
                  "worst_ratio": max(e["checks"][n]["ratio"] for n in names),
                  "tol": {n: "|d| <= %g |want| + %g rms(want)" % (BF16_TOL if n in ("O", "dQ") else F32_TOL)
                          for n in names}}
        if "shifted_mask" in e:
            fields["shifted_mask_ratio"] = {n: e["shifted_mask"][n]["ratio"] for n in names}
            fields["shifted_mask_late_ratio"] = {n: e["shifted_mask"][n]["late_ratio"] for n in names}
        return fields

    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    flops = batch * heads * d * pairs
    rows = nbytes(lse, dsum)
    # The library yardstick: SDPA forward for K7a; its backward for K7b + K7c together.
    gqa = kv_heads != heads
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True))
    lse_check = check("O")
    lse_check.update(lse_max_abs_err=e["checks"]["LSE"]["max_abs_err"], lse_tol=LSE_TOL)
    if "shifted_mask" in e:
        lse_check["shifted_mask_lse_err"] = e["shifted_mask"]["LSE"]["max_abs_err"]
    results = {
        "flash_fwd_lse": dict(
            **lse_check,
            ms=time_ms(lambda: flash_fwd_lse(q, k, v, causal)),
            plain_ms=time_ms(lambda: flash_fwd_lse_reference(q, k, v, causal), warmup=1, reps=2),
            bound=bound(nbytes(q, k, v, out) + nbytes(lse), 4 * flops),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=gqa)),
        ),
        "flash_bwd_dq": dict(
            **check("dQ"),
            bit_identical_runs=repeatable["dQ"],
            ms=time_ms(lambda: flash_bwd_dq(q, k, v, dout, lse, dsum, causal)),
            plain_ms=time_ms(lambda: flash_bwd_dq_reference(q, k, v, dout, lse, dsum, causal), warmup=1, reps=2),
            bound=bound(nbytes(q, k, v, dout, dq) + rows, 6 * flops),
            library_ms=sdpa_bwd_ms,
        ),
        "flash_bwd_dkv": dict(
            **check("dK", "dV"),
            bit_identical_runs=repeatable["dK"] and repeatable["dV"],
            ms=time_ms(lambda: flash_bwd_dkv(q, k, v, dout, lse, dsum, causal)),
            plain_ms=time_ms(lambda: flash_bwd_dkv_reference(q, k, v, dout, lse, dsum, causal), warmup=1, reps=2),
            bound=bound(nbytes(q, k, v, dout, dk, dv) + rows, 8 * flops),
            library_ms=sdpa_bwd_ms,
        ),
    }
    for result in results.values():
        result["bound_ms"], result["bound_by"] = result.pop("bound")
        result["shape"] = e["shape"]
    return results


def train_kernel_phase(seed: int, dev: torch.device, cfg: VLMConfig) -> dict[str, dict]:
    """K7a-c at the training step's two shapes: the causal decoder (video +
    text positions, GQA) and the non-causal encoder. The decoder shape's
    numbers lead; the encoder's carry an ``encoder_`` prefix."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    enc, dec = cfg.encoder, cfg.decoder
    seq = cfg.video_tokens + int(TRAIN_ARGS[TRAIN_ARGS.index("--text-len") + 1])
    results = check_flash_train(gen, dev, 2, dec.num_heads, dec.num_kv_heads, seq, causal=True)
    encoder = check_flash_train(gen, dev, 2, enc.num_heads, enc.num_heads, enc.tokens_per_clip, causal=False)
    for name, result in results.items():
        for key in ("max_abs_err", "worst_ratio", "bit_identical_runs", "ms", "plain_ms", "bound_ms", "library_ms",
                    "shape"):
            if key in encoder[name]:
                result[f"encoder_{key}"] = encoder[name][key]
    return results


def int4_faults(x: torch.Tensor, packed: torch.Tensor) -> dict[str, torch.Tensor]:
    """K6's plain version with a fault that the element-wise check must
    catch: the two nibbles of a byte swapped, or read without sign."""
    lo, hi = (t.float() for t in unpack_int4(packed))
    xf = x.float()
    return {"swapped_nibbles": (xf[:, 0::2] @ hi + xf[:, 1::2] @ lo).to(torch.bfloat16),
            "unsigned_nibbles": (xf[:, 0::2] @ (packed & 0xF).float()
                                 + xf[:, 1::2] @ (packed >> 4).float()).to(torch.bfloat16)}


def check_int4(gen: torch.Generator, dev: torch.device, m: int, k2: int, n: int, timed: bool = True) -> dict:
    """K6 against ``int4_matmul_reference`` at x [m, 2 k2] and packed [k2, n]
    (uniform random bytes, so every nibble value in both positions): bit-equal
    on integer x in [-4, 4] (every partial sum an integer below 2**24, exact
    in f32 in any order), and element by element under ``BF16_TOL`` on
    normal x, where references with swapped or unsigned nibbles must fail.
    Raises otherwise; returns the readings and, if ``timed``, the times."""
    packed = torch.randint(0, 256, (k2, n), generator=gen, device=dev, dtype=torch.uint8)
    x_int = torch.randint(-4, 5, (m, 2 * k2), generator=gen, device=dev).to(torch.bfloat16)
    got, want = int4_matmul(x_int, packed), int4_matmul_reference(x_int, packed)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        differ = (got != want).sum().item()
        raise AssertionError(f"int4_matmul at [{m},{2 * k2}] @ [{k2},{n}]: {differ} elements differ on integer x")
    x = torch.randn(m, 2 * k2, generator=gen, device=dev).to(torch.bfloat16)
    got, want = int4_matmul(x, packed), int4_matmul_reference(x, packed)
    check = closeness(got, want, *BF16_TOL)
    faults = {name: closeness(got, fault, *BF16_TOL)["ratio"] for name, fault in int4_faults(x, packed).items()}
    if not check["ratio"] <= 1:
        raise AssertionError(f"int4_matmul at [{m},{2 * k2}] @ [{k2},{n}] disagrees with its plain version: {check}")
    if not all(ratio > 1 for ratio in faults.values()):
        raise AssertionError(f"int4_matmul: a faulty plain version passes the check: {faults}")
    reading = {"shape": f"x bf16 [{m},{2 * k2}] @ packed uint8 [{k2},{n}]", "integer_x_bit_equal": True,
               "max_abs_err": check["max_abs_err"], "worst_ratio": check["ratio"],
               "tol": "|d| <= %g |want| + %g rms(want)" % BF16_TOL, "fault_ratios": faults}
    if not timed:
        return reading
    w = torch.empty(2 * k2, n, dtype=torch.bfloat16, device=dev)  # the unpacked weight, for the library call
    w[0::2], w[1::2] = unpack_int4(packed)
    bound_ms, bound_by = bound(nbytes(packed) + 2 * m * 2 * k2 + 2 * m * n, 2 * m * 2 * k2 * n)
    return dict(reading, ms=time_ms(lambda: int4_matmul(x, packed)),
                plain_ms=time_ms(lambda: int4_matmul_reference(x, packed)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(lambda: torch.matmul(x, w)),
                device_ms=device_ms(lambda: int4_matmul(x, packed)),
                library_device_ms=device_ms(lambda: torch.matmul(x, w)))


def int4_kernel_phase(seed: int, dev: torch.device) -> dict:
    """K6 at the 7b decoder's four product shapes at decode M, and at the
    gate shape at the batcher's M and the dispatch's top. The gate shape at
    decode M leads; every shape's readings are in ``shapes``."""
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    shapes = {f"{name}_m{INT4_DECODE_ROWS}": check_int4(gen, dev, INT4_DECODE_ROWS, k2, n)
              for name, (k2, n) in INT4_SHAPES.items()}
    for m in INT4_WIDE_ROWS:
        shapes[f"gate_up_m{m}"] = check_int4(gen, dev, m, *INT4_SHAPES["gate_up"])
    lead = shapes[f"gate_up_m{INT4_DECODE_ROWS}"]
    return dict(lead, library="torch.matmul(x, w) with w the unpacked bf16 weight [K, N] (4x the weight bytes)",
                shapes=shapes)


# -- whole-model reference -------------------------------------------------------


def reference_phase(seed: int, dev: torch.device, vocab_size: int, int4: bool = False) -> dict:
    """Tiny preset, bf16, int8 KV: prefill and decode logits through the
    kernels on the card against the plain versions on the CPU, same weights.
    With ``int4`` the decoder is ``INT4_NARROW`` with packed int4 weights
    (quantized on the CPU, then copied): the three decode blocks must launch
    K6 for each of the 7 projections of each layer, and prefill (M > 256)
    never."""
    cfg = get_preset("tiny")
    decoder = replace(cfg.decoder, vocab_size=vocab_size, **(INT4_NARROW if int4 else {}))
    cfg = replace(cfg, decoder=decoder)
    cpu_model = random_params(cfg, torch.Generator(device="cpu").manual_seed(seed), device="cpu",
                              dtype=torch.bfloat16)
    if int4:
        quantize_decoder(cpu_model, "int4")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (2, cfg.encoder.num_frames, 64, 64, 3), dtype=np.uint8))
    prompt = torch.from_numpy(rng.integers(0, 256, (2, 128)).astype(np.int64))
    blocks = torch.from_numpy(rng.integers(0, 256, (3, 2, 3)).astype(np.int64))
    lengths = torch.tensor([128, 100], dtype=torch.int32)
    logits = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")), ("gpu", gpu_model, dev)):
        reset_counts()
        with torch.no_grad():
            patches = preprocess_frames(frames.to(device), cfg.encoder, torch.bfloat16)
            cache = init_kv_cache(cfg.decoder, 2, 512, torch.bfloat16, quant=True, device=device)
            last, cache = model.prefill(patches, prompt.to(device), cache, lengths.to(device))
            prefill_k6 = int4_matmul.launches
            outs = [last.float().cpu()]
            for block in blocks:
                step, cache = model.decode_block_pick(block.to(device), cache, torch.tensor([2, 1], device=device))
                outs.append(step.float().cpu())
        logits[name] = torch.stack(outs)
    err = (logits["cpu"] - logits["gpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    tol = 2e-2 * max(scale, 1.0)
    if not torch.isfinite(logits["gpu"]).all() or err > tol:
        raise AssertionError(f"tiny-preset logits: card vs CPU max_abs_err {err} > {tol}")
    line = {"phase": "reference_int4" if int4 else "reference", "preset": "tiny", "max_abs_err": err, "tol": tol,
            "logit_scale": scale}
    if int4:
        want = 7 * decoder.num_layers * len(blocks)
        if prefill_k6 or int4_matmul.launches != want:
            raise AssertionError(f"int4 reference: K6 launched {prefill_k6} times in prefill and"
                                 f" {int4_matmul.launches} in all, expected 0 and {want}")
        line.update(decoder={k: getattr(decoder, k) for k in INT4_NARROW}, weights="packed int4",
                    k6_launches=int4_matmul.launches, k6_prefill_launches=prefill_k6)
    return line


def reset_counts() -> None:
    for kernel in ALL_KERNELS:
        kernel.launches = 0
    flash_attention.reference_backwards = 0


def counts() -> dict[str, int]:
    out = {kernel.__name__: kernel.launches for kernel in ALL_KERNELS}
    out["reference_backwards"] = flash_attention.reference_backwards
    return out


def tiny_gradients(cfg: VLMConfig, seed: int, dev: torch.device) -> dict:
    """The tiny model's distillation loss and gradients for one seed, on the
    card and on the CPU from the same f32 weights and batch: ``gpu`` and
    ``cpu`` compute in bf16, ``cpu_f32`` in f32 (the bf16 noise floor), and
    ``cpu_shifted`` in bf16 with the flash mask shifted by one position (a
    fault the check must catch). Returns {name: (loss, {tensor: grad},
    launches)}."""
    cpu_model = random_params(cfg, torch.Generator(device="cpu").manual_seed(seed), device="cpu")
    f32_model = copy.deepcopy(cpu_model)
    f32_model.config = replace(cfg, dtype="float32")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(seed)
    patches, tokens = synthetic_batch(rng, cfg, 2, 224, prompt=make_prompt_sampler("compact"), prompt_len=64)
    prompt_lens = torch.tensor([64, 0], dtype=torch.int32)
    runs = (("cpu", cpu_model, 0), ("cpu_f32", f32_model, 0), ("gpu", gpu_model, 0), ("cpu_shifted", cpu_model, 1))
    results = {}
    for name, model, shift in runs:
        device = next(model.parameters()).device
        reset_counts()
        with shifted_causal_mask(shift) if shift else contextlib.nullcontext():
            loss, _ = distillation_loss(
                model, torch.from_numpy(patches).to(device), torch.from_numpy(tokens).to(device),
                prompt_lens=prompt_lens.to(device),
            )
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
        results[name] = (loss.item(), {n: g.float().cpu() for n, g in zip(params, grads)}, counts())
    return results


def worst_grad_error(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-tensor ||got - want|| / ||want||, and its tensor."""
    return max(((got[n] - w).norm().item() / max(w.norm().item(), 1e-30), n) for n, w in want.items())


def train_reference_phase(seed: int, dev: torch.device, vocab_size: int) -> dict:
    """Tiny preset, f32 weights, bf16 compute, GRAD_SEEDS seeds: the
    distillation loss's gradients through the kernels on the card against
    the plain versions on the CPU. The decoder (32 video + 224 text
    positions) takes K7a-c; the encoder (32 positions) K1 and the reference
    backward. Beside each reading, the bf16 noise floor (the CPU's bf16
    gradients against its f32 ones) and a fault's reading (a flash mask
    shifted by one position against the CPU's bf16 gradients), which must
    fail the check."""
    cfg = get_preset("tiny")
    cfg = replace(cfg, decoder=replace(cfg.decoder, vocab_size=vocab_size))
    layers = cfg.decoder.num_layers
    expected = {"flash_fwd_lse": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                "flash_attention": cfg.encoder.num_layers, "reference_backwards": cfg.encoder.num_layers}
    readings = []
    for s in range(seed, seed + GRAD_SEEDS):
        results = tiny_gradients(cfg, s, dev)
        (cpu_loss, cpu_grads, _), (gpu_loss, gpu_grads, gpu_counts) = results["cpu"], results["gpu"]
        if any(gpu_counts[key] != n for key, n in expected.items()):
            raise AssertionError(f"tiny gradient routes: {gpu_counts}, expected {expected}")
        if not all(torch.isfinite(g).all() for g in gpu_grads.values()) or not math.isfinite(gpu_loss):
            raise AssertionError(f"seed {s}: tiny loss or gradients are not finite on the card")
        err, err_name = worst_grad_error(gpu_grads, cpu_grads)
        floor, floor_name = worst_grad_error(cpu_grads, results["cpu_f32"][1])
        fault, fault_name = worst_grad_error(results["cpu_shifted"][1], cpu_grads)
        readings.append({"seed": s, "loss_cpu": cpu_loss, "loss_gpu": gpu_loss,
                         "worst_grad_rel_err": err, "worst_grad": err_name,
                         "bf16_noise_floor": floor, "noise_floor_grad": floor_name,
                         "shifted_mask_rel_err": fault, "shifted_mask_grad": fault_name})
        if not err <= GRAD_REL_TOL:
            raise AssertionError(f"tiny gradients, seed {s}: card vs CPU {err_name} off by {err} > {GRAD_REL_TOL}")
        if not fault > GRAD_REL_TOL:
            raise AssertionError(f"tiny gradients, seed {s}: a shifted mask passes the check ({fault})")
    return {"phase": "train_reference", "preset": "tiny", "tol": GRAD_REL_TOL,
            "metric": "max over tensors of ||g_card - g_cpu|| / ||g_cpu||",
            "tensors": len(cpu_grads), "gpu_launches": gpu_counts, "seeds": readings}


def train_phase(dev: torch.device, workdir: Path) -> tuple[list[dict], dict[str, int]]:
    """Five steps of the training CLI's code path at base width; then one
    profiled step and a checkpoint round trip. Returns the lines to print
    and the launches of the five steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = build_parser().parse_args(TRAIN_ARGS + ["--out", str(workdir / "ckpt"), "--log-dir", str(workdir)])
    t0 = time.perf_counter()
    config, trainer, batches = prepare(args, setup_logging(args.log_dir))
    torch.cuda.synchronize()
    lines = [{"phase": "train_setup", "seconds": time.perf_counter() - t0, "preset": config.name,
              "seq": config.video_tokens + args.text_len, "batch": args.batch, "vocab": config.decoder.vocab_size,
              "params": sum(p.numel() for p in trainer.optimizer.params), "weights": "random f32, seeded",
              "compute_dtype": config.dtype}]
    expected = {"flash_fwd_lse": 36, "flash_bwd_dq": 36, "flash_bwd_dkv": 36,
                "flash_attention": 0, "reference_backwards": 0}
    step_ms, loss_tokens = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for step in range(1, TRAIN_STEPS + 1):
        patches, tokens, prompt_lens = next(batches)
        before = counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainer.step(patches, tokens, prompt_lens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        launched = {key: n - before[key] for key, n in counts().items()}
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])):
            raise AssertionError(f"train step {step}: non-finite loss or gradient {metrics}")
        if any(launched[key] != n for key, n in expected.items()):
            raise AssertionError(f"train step {step}: launches {launched}, expected {expected}")
        step_ms.append(ms)
        loss_tokens.append(metrics["tokens"])
        lines.append({"phase": "train_step", "step": step, "loss": metrics["loss"], "accuracy": metrics["accuracy"],
                      "grad_norm": metrics["grad_norm"], "loss_tokens": metrics["tokens"], "step_ms": ms,
                      "launches": launched})
    total = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(step_ms[1:])
    lines.append({"phase": "train", "steps": TRAIN_STEPS, "steady_step_ms": steady, "first_step_ms": step_ms[0],
                  "loss_tokens_per_s": statistics.median(loss_tokens[1:]) / steady * 1e3,
                  "positions_per_s": args.batch * (config.video_tokens + args.text_len) / steady * 1e3,
                  "peak_memory_gib": peak, "launches": total})

    # One step timed alone, then the same under torch.profiler (device activity only).
    patches, tokens, prompt_lens = next(batches)
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.step(patches, tokens, prompt_lens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(patches, tokens, prompt_lens)
        torch.cuda.synchronize()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    ops = sorted((op for op in ops if op[1] > 0), key=lambda op: -op[1])
    device_ms = sum(op[1] for op in ops)
    if not ops:
        raise AssertionError("train profile: no device ops")
    kinds = {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0, "flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in ops:
        kind = next((k for k in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd") if k in name), None)
        kind = kind or ("matmul" if any(m in name for m in ("nvjet", "gemm", "cutlass")) else "other")
        kinds[kind] += ms
    lines.append({"phase": "train_profile", "wall_ms": wall_ms, "device_busy_ms": device_ms,
                  "device_busy_share": device_ms / wall_ms, "device_launches": sum(op[2] for op in ops),
                  "device_ms_by_kind": kinds,
                  "top_device_ops_ms": [[name[:60], ms, count] for name, ms, count in ops[:12]]})

    # Checkpoint round trip: save, disturb a weight, restore.
    start = time.perf_counter()
    saved = trainer.save_checkpoint(args.out)
    state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    with torch.no_grad():
        trainer.model.decoder.embed.embedding.add_(1.0)
    trainer.restore_checkpoint(saved)
    mismatched = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, state[k])]
    if mismatched or trainer.step_count != TRAIN_STEPS + 2:
        raise AssertionError(f"checkpoint round trip: {mismatched[:4]}, step {trainer.step_count}")
    lines.append({"phase": "train_checkpoint", "path": saved.name, "tensors": len(state),
                  "seconds": time.perf_counter() - start})
    return lines, total


# -- serving phase ---------------------------------------------------------------


def grammar_walk(grammar, ids: list[int]) -> int:
    """The byte-DFA state after ``ids``; raises if a byte leaves the grammar."""
    table = grammar.dfa.next_state
    state = grammar.start
    for tok in ids:
        for byte in grammar.tokenizer.token_bytes(tok):
            state = int(table[state, byte])
            if state < 0:
                raise AssertionError(f"generated token {tok} leaves the grammar")
    return state


def check_complete(grammar, row: int, ids: list[int]) -> None:
    """A row reported complete sampled EOS into the accepting state, and the
    engine does not emit that EOS: its tokens must walk to a state whose EOS
    transition is the accepting one."""
    state = grammar_walk(grammar, ids)
    if int(grammar.dfa.next_state[state, grammar.tokenizer.EOS]) != grammar.accept:
        raise AssertionError(f"row {row} reports complete but its tokens end in state {state}, short of accept")


def serve(engine: InferenceEngine, frames: np.ndarray) -> list[dict]:
    """One generate call; per-row results checked against the grammar."""
    stats = engine.stats
    before = (stats.prefill_seconds, stats.generate_seconds, stats.decode_steps, stats.tokens_generated)
    torch.cuda.reset_peak_memory_stats()
    texts, status, ids = engine.generate(
        frames, [PROMPT] * len(frames), return_status=True, return_tokens=True
    )
    prefill_s = stats.prefill_seconds - before[0]
    total_s = stats.generate_seconds - before[1]
    steps = stats.decode_steps - before[2]
    tokens = stats.tokens_generated - before[3]
    out = []
    for row, (text, done, row_ids) in enumerate(zip(texts, status, ids)):
        if not 0 < len(row_ids) <= MAX_NEW_TOKENS + 2:
            raise AssertionError(f"row {row}: {len(row_ids)} tokens")
        grammar_walk(engine.dfa, row_ids)
        if done:
            check_complete(engine.dfa, row, row_ids)
            json.loads(text)
        out.append({
            "phase": "request", "batch": len(frames), "row": row, "tokens": len(row_ids),
            "complete": done, "prefill_ms": prefill_s * 1e3, "decode_steps": steps,
            "call_tokens": tokens, "call_seconds": total_s,
            "tokens_per_s": tokens / total_s if total_s else 0.0,
            "decode_tokens_per_s": tokens / (total_s - prefill_s) if total_s > prefill_s else 0.0,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "text_head": text[:48],
        })
    return out


def batcher_phase(engine: InferenceEngine, clips: np.ndarray, prompts: list[str], slots: int) -> dict:
    """The continuous batcher's main path at base width: the requests swept
    once through ``ContinuousBatcher(engine, slots=slots)`` (device refill,
    bf16 pool), with the launches counted from 0. Every request completes
    once and its tokens walk the grammar. ``engine.generate`` then serves
    the same clips and prompts in the batcher's waves (requests 0..slots-1,
    then the rest) at the batcher's prompt block, so that its prefill
    sequence and cache length are the batcher's. Each staged request's
    first-token logits must lie within 2e-2 of the largest of
    ``engine.generate``'s prefill logits, and the first wave's tokens must
    equal ``engine.generate``'s at the batcher's batch (the same matmul and
    K5 shapes); the second wave's equality, at another batch, is reported
    only (bf16 matmuls at another M may flip near-ties)."""
    batcher = ContinuousBatcher(engine, slots=slots)
    stages, first_logits = [], {}
    stage = batcher._stage

    def counted_stage():
        """The stage, counted, with its requests' first-token logits kept."""
        before = batcher._staged_total
        stage()
        take = batcher._staged_total - before
        if take:
            stages.append(take)
            reqs = batcher._q_req[:take].tolist()
            first_logits.update(zip(reqs, batcher._q_logits[:take].to("cpu", torch.float32, copy=True)))

    batcher._stage = counted_stage
    for i, clip in enumerate(clips):
        batcher.submit(Request(i, clip, prompts[i]))
    steps0 = engine.stats.decode_steps
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    completions = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts()
    ids = sorted(c.request_id for c in completions)
    if ids != list(range(len(clips))):
        raise AssertionError(f"batcher: completed requests {ids}")
    for c in completions:
        grammar_walk(engine.dfa, c.token_ids)
        if not 0 < c.tokens <= batcher.max_new + 2:
            raise AssertionError(f"batcher request {c.request_id}: {c.tokens} tokens, complete {c.complete}")
        if c.complete:
            check_complete(engine.dfa, c.request_id, c.token_ids)
    steps = engine.stats.decode_steps - steps0
    tokens = {c.request_id: c.token_ids for c in completions}
    line = {"phase": "batcher", "requests": len(clips), "slots": slots, "queue_depth": batcher.queue_depth,
            "pool_rows": batcher.total_rows, "cache_len": batcher.cache_len, "park_len": batcher.park_len,
            "stages": stages, "refills": batcher._staged_total, "seconds": wall,
            "tokens": sum(c.tokens for c in completions),
            "tokens_per_s": sum(c.tokens for c in completions) / wall, "decode_steps": steps,
            "ms_per_step": wall * 1e3 / steps, "complete": sum(c.complete for c in completions),
            "launches": launched}

    # engine.generate on the same clips and prompts, wave by wave, its prefill logits kept.
    captured = []
    prefill = engine.model.prefill

    def recording_prefill(*args):
        logits, cache = prefill(*args)
        captured.append(logits.float().cpu())
        return logits, cache

    waves = [range(0, slots), range(slots, len(clips))]
    engine.model.prefill = recording_prefill
    try:
        wanted = [engine.generate(clips[w.start:w.stop], prompts[w.start:w.stop], prompt_len=batcher.prompt_len,
                                  return_status=True, return_tokens=True)[2] for w in waves]
    finally:
        del engine.model.prefill
    want_logits = torch.cat(captured)
    got_logits = torch.stack([first_logits[i] for i in range(len(clips))])
    logit_err = (got_logits - want_logits).abs().max().item()
    logit_tol = 2e-2 * want_logits.abs().max().item()
    if logit_err > logit_tol:
        raise AssertionError(f"batcher: first-token logits differ from engine.generate's: {logit_err} > {logit_tol}")

    def first_difference(wave: range, want: list[list[int]]) -> list[int | None]:
        """Where each request's tokens first leave ``want`` (None: equal)."""
        out = []
        for i, want_ids in zip(wave, want):
            got_ids = tokens[i]
            out.append(next((j for j, (a, b) in enumerate(zip(got_ids, want_ids)) if a != b),
                            None if len(got_ids) == len(want_ids) else min(len(got_ids), len(want_ids))))
        return out

    first_wave, second_wave = (first_difference(w, want) for w, want in zip(waves, wanted))
    if first_wave.count(None) != slots:
        raise AssertionError(f"batcher: first-wave tokens leave engine.generate's at positions {first_wave}")
    return {"line": line,
            "check": {"phase": "batcher_check", "first_logits_max_abs_err": logit_err, "first_logits_tol": logit_tol,
                      "first_wave_equal_to_generate": first_wave.count(None), "first_wave": slots,
                      "second_wave_equal_to_generate": second_wave.count(None),
                      "second_wave": len(clips) - slots, "second_wave_first_token_differing": second_wave}}


def batcher_profile(engine: InferenceEngine, clips: np.ndarray, prompts: list[str], slots: int,
                    max_new: int = 32) -> dict:
    """Where a batcher sweep's time goes (``max_new`` tokens a request):
    the sweep timed alone, then the same sweep under torch.profiler
    with device activity only, as ``profile_phase`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sweep() -> float:
        batcher = ContinuousBatcher(engine, slots=slots, max_new_tokens=max_new)
        for i, clip in enumerate(clips):
            batcher.submit(Request(i, clip, prompts[i]))
        torch.cuda.synchronize()
        start = time.perf_counter()
        batcher.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    sweep()  # warm-up at this pool size
    wall_ms = sweep()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = sweep()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    ops = sorted((op for op in ops if op[1] > 0), key=lambda op: -op[1])
    if not ops:
        raise AssertionError("batcher profile: no device ops")
    device_ms = sum(op[1] for op in ops)
    return {"phase": "batcher_profile", "requests": len(clips), "max_new_tokens": max_new,
            "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms, "device_busy_ms": device_ms,
            "device_busy_share": device_ms / wall_ms, "device_launches": sum(op[2] for op in ops),
            "top_device_ops_ms": [[name[:60], ms, count] for name, ms, count in ops[:10]]}


def profile_phase(engine: InferenceEngine, frames: np.ndarray, max_new: int = 32) -> dict:
    """Where a batch-2 request's time goes: one short generate call timed
    alone, then the same call under torch.profiler with device activity only.
    The busy share is the profiled device time over the unprofiled wall time,
    since the profiler slows the host down."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cap, engine.max_new_tokens = engine.max_new_tokens, max_new
    try:
        steps0 = engine.stats.decode_steps
        torch.cuda.synchronize()
        start = time.perf_counter()
        engine.generate(frames, [PROMPT] * len(frames))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        steps = engine.stats.decode_steps - steps0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            engine.generate(frames, [PROMPT] * len(frames))
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - start) * 1e3
        profiled_steps = engine.stats.decode_steps - steps0 - steps
    finally:
        engine.max_new_tokens = cap
    ops = [  # device-side events only (host ops carry their kernels' time too)
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    ops = sorted((op for op in ops if op[1] > 0), key=lambda op: -op[1])
    device_ms = sum(op[1] for op in ops)
    if not ops or profiled_steps != steps:
        raise AssertionError(f"profile: {len(ops)} device ops, {profiled_steps} steps against {steps}")
    return {
        "phase": "profile", "batch": len(frames), "max_new_tokens": max_new, "decode_steps": steps,
        "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms, "device_busy_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else 0.0,
        "device_launches": sum(op[2] for op in ops),
        "top_device_ops_ms": [[name[:60], ms, count] for name, ms, count in ops[:10]],
    }


def int4_serving_phase(seed: int, dev: torch.device, tokenizer, grammar) -> tuple[dict, dict]:
    """Main path 4: int4 serving at the full ``7b`` width. Builds the engine
    (seeded random f32 weights, cast to bf16, decoder quantized to packed
    int4; int8 KV cache, the note grammar, greedy), holds K1-K3 at this
    path's shapes against their plain versions, then serves one batch of two
    16-frame clips with the launches counted from 0: K6 exactly 7 x layers
    x decode steps and never in prefill (M > 256 takes the unpacked route),
    K1-K3 at least once. Prints its lines; returns the kernel readings and
    the launches."""
    cfg = base_config(tokenizer.vocab_size, "7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(
        cfg, max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
        param_dtype="bfloat16", quantize="int4", kv_quant="int8", max_forced_run=2, device=dev,
    )
    torch.cuda.synchronize()
    engine.dfa = grammar
    weights = list(engine.model.parameters())
    packed = [w for w in weights if w.dtype == torch.uint8]
    emit({"phase": "setup_7b", "engine_seconds": time.perf_counter() - t0, "preset": cfg.name,
              "weights": "random, seeded", "quantize": "int4", "kv_quant": "int8",
              "params": sum(w.numel() for w in weights) + sum(w.numel() for w in packed),
              "int4_kernels": len(packed), "int4_gib": nbytes(*packed) / 2**30,
              "resident_gib": torch.cuda.memory_allocated() / 2**30,
              "init_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})

    prompt_bucket = engine._prompt_bucket([PROMPT], with_video=True)
    width = 1 + engine.max_forced_run
    cache_len = 128 * math.ceil((cfg.video_tokens + prompt_bucket + MAX_NEW_TOKENS + 2 * width + 17) / 128)
    t0 = time.perf_counter()
    kernels = kernel_phase(seed + 5, dev, cfg, prompt_bucket, cache_len, None)
    emit({"phase": "kernels_checked_7b", "seconds": time.perf_counter() - t0})

    side = cfg.encoder.image_size
    clips = np.random.default_rng(seed + 4).integers(0, 256, (2, cfg.encoder.num_frames, side, side, 3),
                                                     dtype=np.uint8)
    prefill = engine.model.prefill
    prefill_k6 = []

    def counted_prefill(*args):
        before = int4_matmul.launches
        out = prefill(*args)
        prefill_k6.append(int4_matmul.launches - before)
        return out

    engine.model.prefill = counted_prefill
    reset_counts()
    try:
        requests = serve(engine, clips)
    finally:
        del engine.model.prefill
    served = counts()
    steps = requests[0]["decode_steps"]
    want = 7 * cfg.decoder.num_layers * steps
    if served["int4_matmul"] != want or prefill_k6 != [0] or not all(served[k.__name__] for k in KERNELS):
        raise AssertionError(f"7b int4 launches {served} (prefill K6 {prefill_k6}), expected K6 {want}")
    for line in requests:
        decode_s = line["call_seconds"] - line["prefill_ms"] / 1e3
        emit(dict(line, preset=cfg.name, quantize="int4", ms_per_step=decode_s * 1e3 / steps,
                  k6_launches=served["int4_matmul"], k6_prefill_launches=prefill_k6[0],
                  max_new_tokens_cap=MAX_NEW_TOKENS))
    emit(dict(profile_phase(engine, clips), preset=cfg.name))
    return kernels, served


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _lib.library()
    emit({"phase": "build", "nvcc_seconds": _lib.build_seconds, "load_seconds": time.perf_counter() - t0})
    ptxas = [line for line in _lib.build_log.splitlines()
             if any(word in line for word in ("Function properties", "registers", "spill", "setmaxnreg", "wgmma"))]
    emit({"phase": "ptxas", "lines": ptxas})
    emit({"phase": "sass", "flash": flash_sass()})

    t0 = time.perf_counter()
    tokenizer = BpeTokenizer.load(TOKENIZER)
    cfg = base_config(tokenizer.vocab_size)
    engine = InferenceEngine(
        cfg, max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, seed=args.seed, tokenizer=tokenizer,
        param_dtype="bfloat16", quantize="int8", kv_quant="int8", max_forced_run=2, device=dev,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    emit({"phase": "setup", "engine_seconds": t1 - t0, "grammar_seconds": time.perf_counter() - t1,
          "preset": cfg.name, "weights": "random, seeded", "quantize": "int8", "kv_quant": "int8"})
    prompt_bucket = engine._prompt_bucket([PROMPT], with_video=True)
    width = 1 + engine.max_forced_run
    # The engine's cache sizing: live positions plus tail slack.
    cache_len = 128 * math.ceil((cfg.video_tokens + prompt_bucket + MAX_NEW_TOKENS + 2 * width + 17) / 128)
    # The batcher's (default prompt_len 256): park region and pool rows.
    park_len = cfg.video_tokens + 256
    pool_len = 128 * math.ceil((park_len + MAX_NEW_TOKENS + 2 * width + 17) / 128)
    t0 = time.perf_counter()
    kernels = kernel_phase(args.seed, dev, cfg, prompt_bucket, cache_len, park_len)
    kernels.update(batcher_kernel_phase(args.seed, dev, cfg, park_len, pool_len, BATCHER_SLOTS, 3 * BATCHER_SLOTS))
    emit({"phase": "decode_rows", "checks": kernels.pop("decode_attention_rows")})
    kernels.update(train_kernel_phase(args.seed, dev, cfg))
    kernels["int4_matmul"] = int4_kernel_phase(args.seed, dev)
    emit({"phase": "kernels_checked", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit(dict(reference_phase(args.seed, dev, tokenizer.vocab_size), seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(reference_phase(args.seed, dev, tokenizer.vocab_size, int4=True), seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(train_reference_phase(args.seed, dev, tokenizer.vocab_size), seconds=time.perf_counter() - t0))

    # Main path 1, serving: three requests through K1-K3.
    rng = np.random.default_rng(args.seed)
    clips = rng.integers(0, 256, (3, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)
    reset_counts()
    requests = serve(engine, clips[:2]) + serve(engine, clips[2:])
    served = counts()
    for line in requests:
        emit(dict(line, max_new_tokens_cap=MAX_NEW_TOKENS))
    if not all(served[kernel.__name__] for kernel in KERNELS):
        raise AssertionError(f"a kernel was not launched by the requests: {served}")
    emit(profile_phase(engine, clips[:2]))

    # Main path 2, the continuous batcher: 12 requests through 8 slots on the
    # same int8 weights with a bf16 KV pool (K1, K4, K5; no K2 or K3).
    batch_engine = InferenceEngine(cfg, params=engine.model, tokenizer=tokenizer, max_new_tokens=MAX_NEW_TOKENS,
                                   temperature=0.0, max_forced_run=2, device=dev)
    batch_engine.dfa = engine.dfa
    batch_clips = rng.integers(0, 256, (BATCHER_REQUESTS, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)
    batch_prompts = [f"{PROMPT}（片段 {i + 1}）" + ("请逐条展开每个要点，并给出例子。" * 5 if i % 4 == 3 else "")
                     for i in range(BATCHER_REQUESTS)]
    batched = batcher_phase(batch_engine, batch_clips, batch_prompts, BATCHER_SLOTS)
    line, batch_launched = batched["line"], batched["line"]["launches"]
    emit(line)
    if line["stages"] != [BATCHER_STAGE]:  # the shape K4 and K1 were held at above
        raise AssertionError(f"batcher stages {line['stages']}, the kernel checks assumed [{BATCHER_STAGE}]")
    if batch_launched["adopt_rows"] != cfg.decoder.num_layers or not batch_launched["flash_attention"] \
            or batch_launched["decode_attention_update"] != cfg.decoder.num_layers * line["decode_steps"] \
            or batch_launched["write_cache_rows"] or batch_launched["decode_attention"]:
        raise AssertionError(f"batcher launches {batch_launched} for {line['decode_steps']} decode steps")
    emit(batched["check"])
    emit(batcher_profile(batch_engine, batch_clips, batch_prompts, BATCHER_SLOTS))
    grammar = engine.dfa
    del engine, batch_engine
    torch.cuda.empty_cache()

    # Main path 3, training: five base-width steps through K7a-c.
    with tempfile.TemporaryDirectory(prefix="vtx_train_") as workdir:
        train_lines, trained = train_phase(dev, Path(workdir))
    for line in train_lines:
        emit(line)

    # Main path 4, int4 serving at 7b width: K6 at every decode step, K1-K3.
    torch.cuda.empty_cache()
    int4_kernels, int4_served = int4_serving_phase(args.seed, dev, tokenizer, grammar)
    for name, result in int4_kernels.items():  # K1-K3 at the 7b shapes, beside the base ones
        for key in ("max_abs_err", "tol", "worst_ratio", "shifted_mask_ratio", "ms", "plain_ms", "bound_ms",
                    "library_ms", "shape", "encoder_max_abs_err", "encoder_worst_ratio", "encoder_ms",
                    "encoder_plain_ms", "encoder_bound_ms", "encoder_library_ms", "encoder_shape",
                    "ragged_worst_ratio"):
            if key in result:
                kernels[name][f"7b_{key}"] = result[key]
    # Each kernel's launches summed over the main paths' runs (K1-K3 run in two).
    launches = {name: served[name] + batch_launched[name] + trained[name] + int4_served[name] for name in served}

    sources = {
        "flash_attention": ("csrc/flash_fwd.cuh", "video_transformer_tpu/ops/attention.py:56"),
        "write_cache_rows": ("csrc/write_cache_rows.cu", "video_transformer_tpu/ops/decode_attention.py:570"),
        "decode_attention": ("csrc/decode_attention.cu", "video_transformer_tpu/ops/decode_attention.py:164"),
        "adopt_rows": ("csrc/adopt_rows.cu", "video_transformer_tpu/ops/decode_attention.py:992"),
        "decode_attention_update": ("csrc/decode_attention.cu", "video_transformer_tpu/ops/decode_attention.py:396"),
        "flash_fwd_lse": ("csrc/flash_fwd.cuh", "video_transformer_tpu/ops/flash_bwd.py:53"),
        "flash_bwd_dq": ("csrc/flash_bwd.cu", "video_transformer_tpu/ops/flash_bwd.py:156"),
        "flash_bwd_dkv": ("csrc/flash_bwd.cu", "video_transformer_tpu/ops/flash_bwd.py:204"),
        "int4_matmul": ("csrc/int4_matmul.cu", "video_transformer_tpu/ops/int4_matmul.py:46"),
    }
    line = []
    for name, result in kernels.items():
        source, replaces = sources[name]
        line.append(dict(
            name=name, route="cuda", source=f"video_transformer_tpu_torch/{source}", replaces=replaces,
            launches=launches[name], kernel_ms=result["ms"], **result,
        ))
    emit({"kernels": line})
    emit({"phase": "done", "seconds": time.perf_counter() - start, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
