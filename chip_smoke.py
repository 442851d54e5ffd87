"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``video_transformer_tpu_torch/csrc`` (one
``nvcc`` process per source, in parallel), counts the tensor-core
instructions of the wgmma kernels (K1, K7a-c and each width of K6) and of
each instantiation of K3 and K5 (mma.sync) in the built library's SASS,
holds each kernel against its plain PyTorch version at the shapes of the
serving, batcher and training paths and times both (K1 also element by
element against f32-weight attention and at ragged lengths; K7b and K7c
also twice on the same inputs, bit for bit; K5 also bit for bit against K2
then K3, with new positions across a split edge; K3 and K5 also at 20-80
folded query rows per kv head, twice on the same inputs, one kernel a call,
and with the host's cost of a call; K3 on the batcher's bf16 pool beside
scaled_dot_product_attention with a length mask; K6, the packed-int4
matmul, at the 7b decoder's four product shapes and at 1-256 rows, bit for
bit on integer inputs and twice on the same inputs, with the host's cost of
a call beside torch.matmul's; K2, the cache row write, bit for bit against
its plain version on the card and on the CPU, quantizing bf16 rows into
int8 caches at the decode step's and the prefill's shapes, copying at the
batcher stage's, and at constructed rounding cases: exact halves, the
clamp, and quotients that a multiplication by the reciprocal rounds
otherwise; one kernel a call, beside the parent's route of quantize_kv
then K2), checks the whole model against the plain versions on the CPU at
the tiny preset (serving logits, the same with a narrow int4 decoder whose
every projection takes K6, then training gradients), then:

- serves three requests through ``InferenceEngine.generate`` at the full
  ``base`` width and 8 of its 24 decoder layers (``SERVING_LAYERS``; int8
  weights, int8 KV cache, BPE vocabulary, the note grammar, greedy) with
  seeded random weights, shows that the requests went
  through K1-K3 (K2 exactly once a layer for each prefill call and each
  decode step, K3 once a layer a step, and no plain cache write or
  quantize on the card), profiles one short request (device busy share,
  top device ops), and counts the device kernels of one decode step beside
  the parent route's (quantize_kv for k and v, then K2);
- serves twelve requests through ``ContinuousBatcher`` (8 slots, a ring of
  16 parked requests, bf16 KV pool, device refill) on the same weights,
  shows that the one stage wrote its prefill through K2 once a layer and
  adopted it through K4, and every decode step went through K5, holds the
  first-token logits against ``engine.generate``'s and the first wave's
  tokens against ``engine.generate`` at the batcher's batch of 8, and
  profiles a short sweep;
- trains five steps of ``python -m video_transformer_tpu_torch.train.run``'s
  code path at the full ``base`` width (seeded random f32 weights, bf16
  compute, BPE vocabulary, batch 2, 1,024 video + 2,048 text positions),
  shows that every step ran 36 launches each of K7a, K7b and K7c and no
  reference backward, profiles one step, and saves and restores a
  checkpoint in a temporary directory;
- serves one batch of two 16-frame clips through ``InferenceEngine.generate``
  at the full ``7b`` width and 8 of its 28 decoder layers
  (``INT4_SERVING_LAYERS``; seeded random weights, bf16, int4 weights, int8
  KV cache, the same vocabulary and grammar, greedy), after holding K1-K3
  at its shapes, shows
  that every decode step ran K6 for each of the 7 projections of each layer
  and prefill none, and K2 and K3 as
  on the base path, profiles a 16-token call, and counts a decode step's
  device kernels beside the parent route's;
- serves ``qwen2vl-7b`` at its full width and depth (``qwen2vl``): first K1
  at the vision tower's head_dim 80 ([clips x 8, 16, 256, 80] non-causal,
  timed beside SDPA, and at the ragged shapes causal and not; head_dim 96
  must raise), the tiny Qwen geometry's logits on the card against the
  CPU's (random biases; K1 in every tower block), and an HF checkpoint
  round trip at full width and 2 tower blocks and decoder layers (HF-named
  state written as two safetensors shards and an index by the smoke's own
  writer, ``engine.restore(dir)``: weights and prefill logits equal to an
  engine built from the same state in memory); then the 32-block tower,
  the 28-layer Qwen2 decoder with q/k/v biases and the untied 152,064-wide
  head (seeded random weights made on the card, int4 decoder weights, int8
  KV cache) serve two 16-frame 224 px clips, 128 new tokens, greedy, under
  the validator grammar over the synthetic 152k vocabulary
  (``write_synth_qwen_vocab``, ``HfTokenizer``; the encode branch printed),
  with K1 32 times in the tower and 28 in the prefill, K2 28 times a
  prefill and a step, K3 28 and K6 196 a step, and no plain attention or
  cache write on a CUDA tensor;
- drives the engine API the analyzer calls on the serving engine above
  (``engine_api``): ``generate_text`` with the validator grammar, a capped
  ``generate`` continued by token-id prefixes of ragged lengths, a session
  resumed with ``continue_session`` until it completes (its tokens equal
  one call with the budget that sizes the same cache, and no round
  prefills), and ``batch_bucket=4`` with 3 real rows (the real rows' tokens
  equal the unbucketed call's, the pad row generates nothing), with K1 in
  every prefill, K2 in every prefill and decode step and K3 in every step,
  then holds K2 + K3 at each decode shape the path ran (its own first
  step's inputs, random caches to their last position, the causal edge)
  against the plain versions;
- scores the trained tiny checkpoint (``grounding``; the committed
  ``data/torch_weights`` file through ``InferenceEngine.restore``, full
  trained width) with the grounding eval's ``run_eval``: 16 topics and 8
  composites, batch 4, 1,536 new tokens, at the eval's settings greedy
  (bf16 weights and KV cache: K1, K2 in prefill, K5; first-token logits
  within 2e-2 x max|logit| of the CPU's, hits within 1 of the JAX eval's
  10/16 and 0/8, per-topic diff printed), at the serving settings greedy
  (int8 weights and KV cache: K1, K2, K3) and at temperature 0.7 (8 topics,
  no composites), with every
  row walking the note grammar and decode tok/s and ms a step beside the
  card's name and power limit, then holds K5 and K2 + K3 at the eval's
  decode shapes as on the engine API's;
- runs the analyzer (``analyzer``): ``ContentAnalyzer.analyze_video`` on the
  port's shipped config (``utils/config.json``), from a clip written to
  disk to the rendered note. (a) The trained tiny checkpoint, restored from
  the committed ``.npz`` (``event=engine_restored`` must be logged), at the
  shipped serving settings (BPE, compact prompts, int8 weights and KV
  cache), greedy, 1,536 new tokens, on a single-pass clip of one grounded
  topic. (b) ``base`` at its full width and depth (12-layer ViT, 24-layer
  decoder) with seeded random weights, int8 weights and KV, temperature
  0.7, the note grammar's fields at a quarter of their budgets and a 2.5
  closer bias: a single-pass clip through the engine, then a 25-minute clip
  that the shipped planner cuts into 4 segments, which ``auto`` sends
  through the continuous batcher (2 slots, batches of 2). Each call's
  launches are counted from 0 (K2 once a layer an engine prefill, int8
  decode step and batcher stage; K3 once a layer an engine step; K4 once a
  layer a stage; K5 once a layer a batcher step), its note renders through
  ``generate_report`` and passes ``validate_markdown_structure``; then K5
  and K2 + K3 are held at every decode shape the analyzer ran;
- runs the system's own entry point (``pipeline``), from a clip on disk to
  the saved note, blueprint and audit. (a) ``cli.main(["--url", clip,
  "--config", config.json])`` in this process at ``base`` full width and
  depth (the analyzer's (b) settings) with the validator and the auditor
  scoring through the engine (2 rounds): exit 0, the note saved and linted
  (``event=note_lint``), a quality report, ``progress.json``, a 1280x720
  PNG that the port's own reader decodes, a validator call each round, a
  rewrite after each failed round but the last, an audit call; launches
  counted from 0 (K1 in every engine call's prefill, video and text-only;
  K2 once a layer a prefill and a decode step; K3 once a layer a step;
  nothing plain on the card); the seconds of each step (download, analyze,
  validate, render, audit, save) and each engine call's steps and tok/s.
  (b) the trained tiny checkpoint through ``python -m
  video_transformer_tpu_torch --batch LIST --sharded`` in a fresh process
  on two grounded clips (exit 0, two notes and two PNGs), then again (exit
  0, both skipped through the progress file), then a ``WatchService`` scan
  over one clip in this process (launches as in (a)); then K2 + K3 are held
  at every decode shape the phase ran;
- trains on grounded and staged data (``train_grounded``, ``train_staged``)
  at the full ``base`` width and depth with the BPE vocabulary: ``train.run
  --grounded`` (a pool of 16 host-rendered samples in which every branch of
  the sampler is drawn: composite pairs with near-hue and uniform partners,
  band-only clips, stated frame attributes, plain clips; each draw jittered,
  preprocessed in float32 on the card) for 3 steps, then 4 grounded pairs
  staged on disk by ``stage_grounded_corpus``, found by
  ``distillation_records`` and trained on by ``train.run --data`` for 2
  steps; every step 36 launches each of K7a-c, no K1 and no reference
  backward; every staged row's note body is the note's ``encode_aligned``
  ids and walks the note grammar; the set-up seconds (the grammar's bitset
  from its cache, the pool's render) and the step ms;
- scores the trained tiny checkpoint with the content eval (``python -m
  video_transformer_tpu_torch.train.eval_content``'s main: 4 topics, batch
  4, greedy, the model judge on; coverage, the rubric, every parsed note's
  checks booleans) and the real-footage harness (``stage_out_of_bank``
  writes 3 held-out clips with their truths, ``run_real_eval`` scores them
  greedily; every note parses), each engine call with K1 in its prefill, K2
  once a layer a prefill and K5 once a layer a decode step; then K5 is held
  at their decode shapes;
- prints the tracer's summary of every engine call of the run (the spans
  ``engine.preprocess``, ``engine.generate``, ``engine.generate_text`` and
  ``engine.continue_session``) and runs one ``device_trace`` around a short
  greedy decode, whose exported trace must name the spans beside the
  device kernels, each span an NVTX range.

The setup line gives the note grammar's bitset seconds built and loaded
from its cache (``build/grammar_cache/``).

It prints one JSON object per line, flushed; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (exit code 1). It
needs a CUDA device and exits with an error without one.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import os
import copy
import functools
import io
import itertools
import json
import logging
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

from video_transformer_tpu_torch import cli as port_cli
from video_transformer_tpu_torch.analyzer import ContentAnalyzer
from video_transformer_tpu_torch.analyzer.prompts import render_prompt
from video_transformer_tpu_torch.analyzer.schema import note_dfa, validator_dfa
from video_transformer_tpu_torch.contracts.validators import validate_markdown_structure
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models import lm as lm_module
from video_transformer_tpu_torch.models.config import DecoderConfig, VLMConfig, get_preset
from video_transformer_tpu_torch.models.hf_tokenizer import HfTokenizer
from video_transformer_tpu_torch.models.lm import init_kv_cache
from video_transformer_tpu_torch.models.port import decoder_key_map, port_decoder_state, port_vision_state, vision_key_map
from video_transformer_tpu_torch.models.quant import quantize_decoder
from video_transformer_tpu_torch.models.qwen_vit import QwenVisionConfig
from video_transformer_tpu_torch.models.synth_vocab import write_synth_qwen_vocab
from video_transformer_tpu_torch.models.vlm import VideoLM
from video_transformer_tpu_torch.ops import _lib
from video_transformer_tpu_torch.ops import attention as attention_module
from video_transformer_tpu_torch.ops import decode_attention as decode_module
from video_transformer_tpu_torch.ops import flash_bwd as flash_bwd_module
from video_transformer_tpu_torch.ops.attention import flash_attention, mha_reference
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
from video_transformer_tpu_torch.ops.flash_bwd import (
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_fwd_lse,
    flash_fwd_lse_reference,
)
from video_transformer_tpu_torch.ops.int4_matmul import INT4_WIDTHS, int4_matmul, int4_matmul_reference, unpack_int4
from video_transformer_tpu_torch.ops.preprocess import preprocess_frames
from video_transformer_tpu_torch.ops.token_grammar import TokenGrammar
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.pipeline.auditor import QualityAuditor
from video_transformer_tpu_torch.pipeline.downloader import VideoDownloader
from video_transformer_tpu_torch.pipeline.pipeline import VideoPipeline
from video_transformer_tpu_torch.pipeline.png import decode_png
from video_transformer_tpu_torch.pipeline.service import WatchService
from video_transformer_tpu_torch.pipeline.validator import ConsistencyValidator
from video_transformer_tpu_torch.pipeline.visualizer import ImageGenerator
from video_transformer_tpu_torch.train import eval_content
from video_transformer_tpu_torch.train import grounded as grounded_module
from video_transformer_tpu_torch.train.data import distillation_records, synthetic_batch
from video_transformer_tpu_torch.train.eval_grounding import eval_inputs, run_eval
from video_transformer_tpu_torch.train.eval_real import run_real_eval, stage_out_of_bank
from video_transformer_tpu_torch.train.grounded import render_topic_clip, stage_grounded_corpus
from video_transformer_tpu_torch.train.run import build_parser, make_prompt_sampler, prepare, setup_logging
from video_transformer_tpu_torch.train.trainer import distillation_loss
from video_transformer_tpu_torch.utils.config import load_config
from video_transformer_tpu_torch.utils.logger import LOGGER_NAME
from video_transformer_tpu_torch.utils.counter import APICounter
from video_transformer_tpu_torch.utils.tracing import device_trace, tracer
from video_transformer_tpu_torch.video.containers import write_npzv
from video_transformer_tpu_torch.weights import from_jax_params, random_params

REPO = Path(__file__).resolve().parent
TOKENIZER = REPO / "data" / "tokenizers" / "bpe-zh-2048.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
MAX_NEW_TOKENS = 256  # capped for the smoke; the shipped config says 4096
# Tokens a request in the profiled windows (``profile_phase``,
# ``batcher_profile``): 32 until the smoke outgrew its 5-minute limit; the
# profiler's post-processing takes ~0.2 ms an event, a 32-token base window
# 65 k events (12 s) and the batcher's 117 k (25 s).
PROFILE_TOKENS = 16
# Decoder depth of the earlier serving paths (main paths 1, 2 and 4), cut to
# keep the smoke within its 5-minute limit: every width stays the preset's,
# each per-layer launch check counts these layers, and the kernel checks run
# at the full presets' shapes. The engine API (path 5) serves the full base
# depth.
SERVING_LAYERS = 8  # of base's 24
# The 7b int4 path's decoder depth (main path 4) since the qwen2vl path
# (main path 11) serves the same decoder geometry at its full 28 layers:
# K6, K2 and K3 keep the 7b shapes, each layer-count check counts these.
INT4_SERVING_LAYERS = 8  # of 7b's 28
PROMPT = "分析这段视频的内容，写出结构化的知识笔记。"
KERNELS = (flash_attention, write_cache_rows, decode_attention)  # the serving path's
BATCHER_KERNELS = (adopt_rows, decode_attention_update)  # with K1 and K2 (the stage); the bf16 pool takes no K3
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
# Other row counts at the gate shape: 1 and 130 (x padded to wgmma widths 8
# and 256), the batcher's 8 slots x 3, and the top of K6's dispatch.
INT4_WIDE_ROWS = (1, 24, 130, 256)
HOST_CALLS = 1000  # calls enqueued back to back, unsynchronised, for a wrapper's host cost
COLD_BYTES = 100e6  # weight copies timed in turn, twice the H100's 50 MB L2 cache
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
# A base training step's launches: K7a-c once a layer of the ViT's 12 and
# the decoder's 24, no K1 and no reference backward.
TRAIN_STEP_LAUNCHES = {"flash_fwd_lse": 36, "flash_bwd_dq": 36, "flash_bwd_dkv": 36,
                       "flash_attention": 0, "reference_backwards": 0}


_START = time.perf_counter()


def emit(obj: dict) -> None:
    """Print one JSON line; a phase's line also gets ``t``, the seconds since
    the script started (where the smoke's own time goes)."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - _START}
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


def device_profile(fn, calls: int = 20, tries: int = 10) -> tuple[float, float]:
    """Device time of one call of ``fn`` in ms, and the device kernels a
    call launches: the self device time and the count of the kernels it
    launches, summed by torch.profiler over ``calls`` calls, after one
    warm-up call. Unlike ``time_ms`` it leaves out the host's time between
    launches, which sets ``time_ms`` where a call's kernels are short.
    CUPTI sometimes drops records at the start of a session (a 7b K2 window
    read 16 kernels for 20 calls in each of 10 sessions), so each session
    first runs the calls in a traced warm-up window whose records are
    discarded, and counts the next window. A profile that records no device
    activity, or a count of kernels that is no multiple of ``calls``, is
    taken again, up to ``tries`` times; after that the last profile with
    device time stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    reading = None
    for _ in range(tries):
        windows = []
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: windows.append(p.key_averages())) as prof:
            for _ in range(2):  # the warm-up window, then the counted one
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in (windows[0] if windows else []) if e.device_type == DeviceType.CUDA]
        total, count = sum(e.self_device_time_total for e in events), sum(e.count for e in events)
        if total:
            reading = (total / 1e3 / calls, count / calls)
            if count % calls == 0:
                return reading
    if reading is None:
        raise AssertionError(f"device_ms: the profiler saw no device time in {tries} tries")
    return reading


def device_ms(fn, calls: int = 20, tries: int = 10) -> float:
    """Device time of one call of ``fn`` in ms (``device_profile``)."""
    return device_profile(fn, calls, tries)[0]


def unwarmed_kernels(fn, calls: int = 20) -> float:
    """Device kernels a call that torch.profiler records for ``calls``
    calls of ``fn`` in a session of its own with no warm-up window, as
    ``device_profile`` read before it warmed its sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / calls


def one_kernel_readings(fn) -> dict:
    """A kernel's timings at one shape (K2, K3, K5): CUDA-event ms, the
    profiler's device ms, and the host's enqueue µs a call; raises unless
    the profiler sees exactly one kernel a call. Beside the count it gives
    an unwarmed session's count of the same calls (``unwarmed_kernels``): a
    profiler that drops records at a session's start reads less there and
    one a call in the warmed window; a launch that did not happen reads
    less in both, and raises."""
    unwarmed = unwarmed_kernels(fn)
    ms, kernels = device_profile(fn)
    if kernels != 1:
        raise AssertionError(f"{kernels} device kernels a call (unwarmed session: {unwarmed}), expected one")
    return {"ms": time_ms(fn), "device_ms": ms, "kernels_per_call": kernels,
            "unwarmed_kernels_per_call": unwarmed, "host_us": host_us(fn)}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and which resource sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


DECODE_INSTANTIATIONS = 9  # K3 int8 and bf16, K5 bf16; each with 4, 2 and 1 warps a 16-row group


def decode_name(function: str) -> str:
    """K3/K5's name for a mangled decode_kernel<T, kFused, kParts>."""
    kind = "K5" if "Lb1E" in function else "K3"
    cache = "int8" if "decode_kernelIa" in function else "bf16"
    parts = re.search(r"Lb[01]ELi(\d+)E", function).group(1)
    return f"{kind} decode_kernel<{cache}, parts {parts}>"


def kernel_sass() -> dict[str, dict[str, int]]:
    """Tensor-core instructions in each wgmma kernel of the built library
    (K1 is flash_fwd_kernel<false>, K7a <true>; K7b flash_bwd_dq_kernel, K7c
    flash_bwd_dkv_kernel; K6 int4_matmul_kernel<width> for each wgmma width)
    and in each instantiation of K3 and K5 (decode_kernel<cache, fused,
    warps a group>), counted in ``cuobjdump -sass``: HGMMA (wgmma) and HMMA
    (mma.sync). Raises if a kernel is missing, a wgmma kernel has no HGMMA
    or a K3/K5 instantiation no HMMA."""
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
            elif "int4_matmul_kernel" in function:
                name = f"K6 int4_matmul_kernel<{re.search(r'ILi(\d+)E', function).group(1)}>"
            elif "decode_kernel" in function:
                name = decode_name(function)
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    k6 = [name for name in counts if name.startswith("K6")]
    decode = [name for name in counts if name.startswith(("K3", "K5"))]
    wgmma = [c for name, c in counts.items() if name not in decode]
    if len(wgmma) - len(k6) != 4 or len(k6) != len(INT4_WIDTHS) or not all(c["HGMMA"] for c in wgmma):
        raise AssertionError(f"a wgmma kernel is missing or runs no wgmma instruction: {counts}")
    if len(decode) != DECODE_INSTANTIATIONS or not all(counts[name]["HMMA"] for name in decode):
        raise AssertionError(f"a K3/K5 instantiation is missing or runs no mma instruction: {counts}")
    return counts


def ptxas_usage(log: str, kernel: str, name) -> dict[str, dict]:
    """ptxas's registers and spills for each entry function whose mangled
    name contains ``kernel``, from the build log, keyed by ``name(mangled)``."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"'(\S+)'", line.split("Compiling entry function", 1)[1])
            key = name(found.group(1)) if found and kernel in found.group(1) else None
            if key:
                out[key] = {}
        elif key and "spill stores" in line:
            out[key]["spill_store_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def k6_ptxas(log: str) -> dict[str, dict]:
    """ptxas's registers and spills for each K6 width, from the build log."""
    return ptxas_usage(log, "int4_matmul_kernel", lambda f: re.search(r"int4_matmul_kernelILi(\d+)E", f).group(1))


def decode_ptxas(log: str) -> dict[str, dict]:
    """ptxas's registers and spills for each K3/K5 instantiation."""
    return ptxas_usage(log, "decode_kernel", decode_name)


def k2_ptxas(log: str) -> dict[str, dict]:
    """ptxas's registers and spills for each K2 instantiation."""
    def name(function: str) -> str:
        found = re.search(r"write_rows_kernelI([at])Lb([01])E", function)
        rows = "int8" if found.group(1) == "a" else "bf16"
        return f"K2 write_rows_kernel<{rows} rows, {'quantize' if found.group(2) == '1' else 'copy'}>"

    return ptxas_usage(log, "write_rows_kernel", name)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time to enqueue one call of ``fn``, in microseconds: ``calls``
    calls back to back with no synchronize between them, after warm-up.
    Where the card takes longer per call than the host, the launch queue
    fills and this reads the card's rate instead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


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
                seq: int, causal: bool, d: int = 128) -> dict:
    """K1 at one attention shape of head_dim ``d`` (``flash_errors``); times and bound."""
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


def flash_ragged_reading(gen: torch.Generator, dev: torch.device, heads: int, kv_heads: int, d: int = 128) -> dict:
    """K1 at every ``FLASH_RAGGED_SHAPES`` entry, causal and not, batch 2,
    head_dim ``d``; the worst element-wise ratio and the smallest
    shifted-mask ratio."""
    readings = []
    for s_q, s_k in FLASH_RAGGED_SHAPES:
        for causal in (True, False):
            q = torch.randn(2, heads, s_q, d, generator=gen, device=dev).to(torch.bfloat16)
            k, v = (torch.randn(2, kv_heads, s_k, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            result = flash_errors(q, k, v, causal)
            result.pop("out")
            readings.append(result)
    return {"checks": readings, "worst_ratio": max(r["worst_ratio"] for r in readings),
            "min_shifted_mask_ratio": min(r["shifted_mask_ratio"] for r in readings if "shifted_mask_ratio" in r)}


def quantize_edge_rows(d: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Rows and per-head scales at which quantize_kv's arithmetic is decided
    at its edges, found in numpy f32: (x f32 [2, d] of bf16-exact values,
    scales f32 [2]). Head 0, scale 0.5: exact halves x / s = n + 0.5 (round
    half to even), +-127.5 and values past it (clamp), +-inf, +-0. Head 1:
    the scale in 0.0100, 0.0101, ..., 0.1000 with the most positive bf16 x
    where quantize_kv's int8 differs from the one that x * (1 / s) gives,
    and those x with both signs: a kernel that multiplied by the reciprocal
    fails there."""
    one = np.float32(1)
    grid = (np.arange(1, 0x4380, dtype=np.uint32) << 16).view(np.float32)  # positive finite bf16 < 256

    def reciprocal_misses(s: np.float32) -> np.ndarray:
        xs = grid[grid <= 128 * s]
        return xs[np.minimum(np.rint(xs / s), 127) != np.minimum(np.rint(xs * (one / s)), 127)]

    scales = (np.arange(100, 1001) / 10000).astype(np.float32)
    s1 = scales[int(np.argmax([len(reciprocal_misses(s)) for s in scales]))]
    misses = reciprocal_misses(s1)
    halves = (np.arange(-8, 8, dtype=np.float32) + 0.5) * np.float32(0.5)
    clamps = np.array([63.75, -63.75, 63.25, -63.25, 64, -64, 100, -1000, np.inf, -np.inf, 0, -0.0], np.float32)
    head0 = np.resize(np.concatenate([halves, clamps]), d)
    head1 = np.resize(np.concatenate([misses, -misses]), d)
    return np.stack([head0, head1]), np.array([0.5, s1], np.float32)


def edge_rows(batch: int, width: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_edge_rows`` as bf16 new rows [batch, 2, width, 128], each
    position's rows rolled by one lane more, and the scales on ``dev``."""
    rows, scales = quantize_edge_rows()
    new = np.stack([[np.roll(rows, b * width + j, axis=-1) for j in range(width)] for b in range(batch)])
    new = torch.from_numpy(np.ascontiguousarray(new.transpose(0, 2, 1, 3)))
    return new.to(dev, torch.bfloat16), torch.from_numpy(scales).to(dev)


def plain_write(k_cache, v_cache, k_new, v_new, index, rows=None, k_scale=None, v_scale=None) -> None:
    """K2's plain version on any device: quantize_kv under the scales where
    given, then update_cache_rows, k and v."""
    if k_scale is not None:
        k_new, v_new = quantize_kv(k_new, k_scale), quantize_kv(v_new, v_scale)
    update_cache_rows(k_cache, k_new, index, rows)
    update_cache_rows(v_cache, v_new, index, rows)


def parent_write(k_cache, v_cache, k_new, v_new, index, rows=None, k_scale=None, v_scale=None) -> None:
    """The route before K2 quantized: quantize_kv for k and v (about five
    elementwise kernels each), then K2 on the int8 rows."""
    if k_scale is not None:
        k_new, v_new = quantize_kv(k_new, k_scale), quantize_kv(v_new, v_scale)
    write_cache_rows(k_cache, v_cache, k_new, v_new, index, rows)


def check_write(k_cache, v_cache, k_new, v_new, index, rows=None, k_scale=None, v_scale=None,
                timed: bool = True) -> dict:
    """K2 (into ``k_cache``/``v_cache``, in place) against its plain version
    on copies of the same inputs on the card and on the CPU: both caches bit
    for bit. Raises otherwise. If ``timed``, the readings: one kernel a call
    (``one_kernel_readings``), the bound, the plain version's time and, for
    the quantizing route, the parent route's (``parent_write``), for the
    copy two index_put_ as the library call."""
    b, hkv, w, d = k_new.shape
    scaled = k_scale is not None
    on_card = [t.clone() for t in (k_cache, v_cache)]
    on_cpu = [t.cpu() for t in (k_cache, v_cache)]
    args = (k_new, v_new, index, rows, k_scale, v_scale)
    write_cache_rows(k_cache, v_cache, *args[:4], k_scale=k_scale, v_scale=v_scale)
    plain_write(*on_card, *args)
    cpu_args = [None if t is None else t.cpu() for t in args]
    write_cache_rows(*on_cpu, *cpu_args[:4], k_scale=cpu_args[4], v_scale=cpu_args[5])
    torch.cuda.synchronize()
    shape = (f"caches {str(k_cache.dtype).removeprefix('torch.')} {list(k_cache.shape)} new"
             f" {str(k_new.dtype).removeprefix('torch.')} {list(k_new.shape)} index {index.tolist()[:4]}"
             f" rows {None if rows is None else rows.tolist()[:4]}" + (" scaled" if scaled else ""))
    for got, card, cpu in zip((k_cache, v_cache), on_card, on_cpu):
        if not (torch.equal(got, card) and torch.equal(got.cpu(), cpu)):
            differ = max(int((got != card).sum()), int((got.cpu() != cpu).sum()))
            raise AssertionError(f"write_cache_rows ({shape}): {differ} elements differ from its plain version")
    reading = {"shape": shape, "bit_equal_card_and_cpu": True, "max_abs_err": 0, "tol": 0}
    if not timed:
        return reading
    call = functools.partial(write_cache_rows, k_cache, v_cache, *args[:4], k_scale=k_scale, v_scale=v_scale)
    written = 2 * b * hkv * w * d * k_cache.element_size()
    bound_ms, bound_by = bound(nbytes(k_new, v_new) + written + nbytes(*(t for t in args[2:] if t is not None)), 0)
    reading.update(one_kernel_readings(call), plain_ms=time_ms(lambda: plain_write(*on_card, *args)),
                   bound_ms=bound_ms, bound_by=bound_by)
    if scaled:
        parent = functools.partial(parent_write, *on_card, *args)
        parent_device_ms, parent_kernels = device_profile(parent)
        reading.update(parent_ms=time_ms(parent), parent_device_ms=parent_device_ms,
                       parent_kernels_per_call=parent_kernels, parent_host_us=host_us(parent),
                       library_ms=None, library="none: no PyTorch call quantizes and scatters")
    else:
        phys = (rows if rows is not None else torch.arange(b, device=index.device)).long()[:, None]
        pos = index.long()[:, None] + torch.arange(w, device=index.device)
        k_rows, v_rows = k_new.transpose(1, 2), v_new.transpose(1, 2)

        def library():
            on_card[0][phys, :, pos] = k_rows
            on_card[1][phys, :, pos] = v_rows

        reading.update(library_ms=time_ms(library),
                       library="two index_put_ (cache[rows[:, None], :, index[:, None] + j] = new), k and v")
    return reading


def write_readings(gen: torch.Generator, dev: torch.device, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   index: torch.Tensor, rows: torch.Tensor, prefill_seq: int, park_len: int | None) -> dict:
    """K2 at the main paths' shapes (``check_write``): the int8 decode step
    (bf16 rows quantized under per-head scales into ``k_cache``/``v_cache``
    at ``index`` through ``rows``, W = 3), int8 rows copied at the same
    shape, the int8 prefill block (``prefill_seq`` positions from 0), the
    batcher's bf16 stage (``BATCHER_STAGE`` rows of ``park_len`` positions)
    unless ``park_len`` is None, and ``quantize_edge_rows`` at decode and
    prefill widths. The decode step leads; every shape is in ``shapes``."""
    batch, width = index.shape[0], 3
    _, hkv, cache_len, d = k_cache.shape
    k_scale, v_scale = (torch.rand(hkv, generator=gen, device=dev) * 0.04 + 0.02 for _ in range(2))

    def rows_of(n: int, w: int, dtype=torch.bfloat16) -> torch.Tensor:
        if dtype == torch.int8:
            return torch.randint(-127, 128, (n, hkv, w, d), generator=gen, device=dev, dtype=torch.int8)
        return torch.randn(n, hkv, w, d, generator=gen, device=dev).to(dtype)

    def zero_caches(n: int, s: int, dtype) -> list[torch.Tensor]:
        return [torch.zeros(n, hkv, s, d, device=dev, dtype=dtype) for _ in range(2)]

    shapes = {}
    shapes["decode"] = check_write(k_cache, v_cache, rows_of(batch, width), rows_of(batch, width), index, rows,
                                   k_scale, v_scale)
    shapes["decode_int8_rows"] = check_write(k_cache, v_cache, rows_of(batch, width, torch.int8),
                                             rows_of(batch, width, torch.int8), index, rows)
    start = torch.zeros(batch, dtype=torch.int32, device=dev)
    shapes["prefill"] = check_write(*zero_caches(batch, cache_len, torch.int8), rows_of(batch, prefill_seq),
                                    rows_of(batch, prefill_seq), start, None, k_scale, v_scale)
    if park_len is not None:
        stage = torch.zeros(BATCHER_STAGE, dtype=torch.int32, device=dev)
        shapes["stage"] = check_write(*zero_caches(BATCHER_STAGE, park_len, torch.bfloat16),
                                      rows_of(BATCHER_STAGE, park_len), rows_of(BATCHER_STAGE, park_len), stage)
    for name, w, at in (("edge_decode", width, index), ("edge_prefill", prefill_seq, start)):
        edges, scales = edge_rows(batch, w, dev)
        caches = [torch.randint(-127, 128, (batch + 1, 2, cache_len, d), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2)]
        shapes[name] = check_write(*caches, edges, -edges, at, rows if name == "edge_decode" else None,
                                   scales, scales.clone(), timed=False)
    return dict(shapes["decode"], shapes=shapes)


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

    # K2 at every shape of the paths; its decode step writes the int8
    # caches that K3 reads next, at per-row offsets through a row table.
    hkv, d = dec.num_kv_heads, dec.head_dim
    phys_rows = batch + 1
    k_cache = torch.randint(-127, 128, (phys_rows, hkv, cache_len, d), generator=gen, device=dev, dtype=torch.int8)
    v_cache = torch.randint(-127, 128, (phys_rows, hkv, cache_len, d), generator=gen, device=dev, dtype=torch.int8)
    index = torch.tensor([prefill_seq + 47, prefill_seq + 198], dtype=torch.int32, device=dev)
    rows = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    results["write_cache_rows"] = write_readings(gen, dev, k_cache, v_cache, index, rows, prefill_seq, park_len)

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
    if not torch.equal(out, decode_attention(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)):
        raise AssertionError("decode_attention: two launches on the same inputs give different bits")
    group = dec.num_heads // hkv
    visible = sum(int(n) + width - 1 for n in lengths.tolist())  # positions read per kv head
    cache_bytes = 2 * hkv * visible * d  # int8 k and v
    flops = sum(4 * group * d * (int(n) + j) for n in lengths.tolist() for j in range(width)) * hkv
    bound_ms, bound_by = bound(cache_bytes + 2 * nbytes(q) + nbytes(lengths, rows, k_scale, v_scale), flops)
    results["decode_attention"] = {
        "max_abs_err": err, "tol": tol, "edge_max_abs_err": edge_err, "edge_tol": edge_tol,
        "bit_identical_runs": True, "splits": decode_splits(batch, hkv, cache_len),
        **one_kernel_readings(lambda: decode_attention(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)),
        "plain_ms": time_ms(lambda: _scaled_reference(q, k_cache, v_cache, lengths, rows, k_scale, v_scale)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none for an int8 cache: no PyTorch call attends over int8 k/v with per-head scales"
                   " (a bf16 pool beside SDPA: the bf16_ keys)",
        "shape": (f"q bf16 [{batch},{dec.num_heads},{width},{d}] caches int8 [{phys_rows},{hkv},{cache_len},{d}]"
                  f" lengths={lengths.tolist()} rows=[2,0]"),
    }
    return results


# (group, W): 20, 21, 28, 40 and 49 folded rows per kv head (49: speculative
# verify blocks of 7 at the 7b preset's group of 7), and 80, past the 64 rows
# a block keeps in registers (a second pass over its tiles).
DECODE_ROW_SHAPES = ((4, 5), (7, 3), (4, 7), (8, 5), (7, 7), (16, 5))


def split_edge_index(width: int, s_cache: int, splits: int, start: int = 0) -> int:
    """The first cache index at or after ``start`` whose ``width`` new
    positions (K5, which attends with lengths index + 1) fall in the tiles
    of two blocks of ``decode_plan``: one block writes the first of them,
    another the rest. The new positions end the valid extent, and the last
    block of a plan holds more than one tile once the extent has more tiles
    than the cluster has blocks, so such an index lies in the first
    ``splits`` tiles."""
    for index in range(start, s_cache - width + 1):
        plan = decode_plan(index + 1, width, s_cache, splits)
        owner = {tile: rank for rank, tiles in enumerate(plan) for tile in tiles}
        if owner[index // 64] != owner[(index + width - 1) // 64]:
            return index
    raise ValueError(f"no split edge for {width} positions after {start} in a cache of {s_cache}")


def decode_rows_reading(gen: torch.Generator, dev: torch.device, cache_len: int, group: int, width: int,
                        dtype: torch.dtype) -> dict:
    """K3 at ``group * width`` folded q rows per kv head (16-row groups: four
    warps a group up to 16 rows, two up to 32, one up to 64, a second pass
    past 64), against its plain version and at the causal edge; on a bf16
    cache also K5, bit for bit against K2 then K3, with row 0's new
    positions across the edge between two blocks of ``decode_plan`` (each
    block stores the positions in its own tiles). Raises past the tolerance
    or on any bit of difference."""
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
    edge = split_edge_index(width, cache_len, decode_splits(batch, hkv, cache_len))
    index = torch.tensor([edge, cache_len - width - 5], dtype=torch.int32, device=dev)
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
        "device_ms": device_ms(
            lambda: adopt_rows(pool_k, stage_src_k, stage_rows, count, park_len, pool_v, stage_src_v)),
        "plain_ms": time_ms(lambda: (adopt_rows_reference(ref_k, stage_src_k, stage_rows, count, park_len),
                                     adopt_rows_reference(ref_v, stage_src_v, stage_rows, count, park_len))),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library_adopt),
        "library": "two index_put_ (dst[rows[:count], :, :park_len] = src[:count]), k and v",
        "shape": (f"pools bf16 [{pool_rows},{hkv},{cache_len},{d}] x2, src [{count},{hkv},{park_len},{d}] x2,"
                  f" count {count} (checked with a pad lane on lane 0's row)"),
    }

    # K5: rows a permutation of pool rows; the index set of the earlier
    # smokes (slot 1's W new positions across a tile edge) is checked and
    # timed, then checked again with slot 0's across the edge between two
    # blocks of decode_plan.
    q = torch.randn(slots, dec.num_heads, width, d, generator=gen, device=dev).to(torch.bfloat16)
    k_new, v_new = (torch.randn(slots, hkv, width, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    splits = decode_splits(slots, hkv, cache_len)
    tile0 = 64 * (park_len // 64)
    index = torch.tensor([tile0 + 127, tile0 + 62] + [park_len - 128 + 37 * i for i in range(2, slots)],
                         dtype=torch.int32, device=dev)
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
    edge_index = index.clone()
    edge_index[0] = split_edge_index(width, cache_len, splits)
    repeated = k5_repeatable(q, pool_k, pool_v, k_new, v_new, edge_index, rows)
    if not all(repeated.values()):
        raise AssertionError(f"K5 with new positions across a split edge: {repeated}")
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
        "bit_equal_to_k2_k3": True, "bit_identical_runs": True, "splits": splits,
        "split_edge_index": edge_index.tolist(),
        **one_kernel_readings(lambda: decode_attention_update(q, fused_k, fused_v, k_new, v_new, index, rows)),
        "k2_k3_ms": time_ms(lambda: (write_cache_rows(split_k, split_v, k_new, v_new, index, rows),
                                     decode_attention(q, split_k, split_v, index + 1, rows))),
        "plain_ms": time_ms(plain_update),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call writes the cache rows and attends",
        "shape": (f"q bf16 [{slots},{dec.num_heads},{width},{d}] pools bf16 [{pool_rows},{hkv},{cache_len},{d}]"
                  f" index={index.tolist()} rows={perm[:slots]}"),
    }
    results["decode_attention_bf16"] = k3_bf16_reading(q, pool_k, pool_v, index + 1)
    results["decode_attention_rows"] = [decode_rows_reading(gen, dev, cache_len, group, width, dtype)
                                        for group, width in DECODE_ROW_SHAPES
                                        for dtype in (torch.bfloat16, torch.int8)]
    return results


def k5_repeatable(q, k_cache, v_cache, k_new, v_new, index, rows) -> dict[str, bool]:
    """K5 twice on copies of the same inputs, and K2 then K3 on a third:
    whether the outputs and caches of the two K5 launches are bit-identical,
    and the first equals K2 then K3 bit for bit."""
    copies = [(k_cache.clone(), v_cache.clone()) for _ in range(3)]
    runs = [decode_attention_update(q, k, v, k_new, v_new, index, rows) for k, v in copies[:2]]
    write_cache_rows(*copies[2], k_new, v_new, index, rows)
    want = decode_attention(q, *copies[2], index + 1, rows)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(copies[0], copies[1])]
    wrote = [torch.equal(a, b) for a, b in zip(copies[0], copies[2])]
    return {"bit_identical_runs": torch.equal(runs[0], runs[1]) and all(same),
            "bit_equal_to_k2_k3": torch.equal(runs[0], want) and all(wrote)}


def k3_bf16_reading(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor) -> dict:
    """K3 on a bf16 cache (the batcher's pool) with identity rows (row b of
    the batch is pool row b) at ``lengths``, held against its plain version
    and timed beside one PyTorch call of the same function:
    scaled_dot_product_attention over the same rows with a length mask
    (query column j sees positions < lengths + j) and GQA."""
    b, hq, width, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rows = torch.arange(b, dtype=torch.int32, device=q.device)
    k_rows, v_rows = k_cache[:b], v_cache[:b]
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            < lengths[:, None, None, None] + torch.arange(width, device=q.device)[None, None, :, None])

    def library():
        return F.scaled_dot_product_attention(q, k_rows, v_rows, attn_mask=mask, enable_gqa=True)

    out = decode_attention(q, k_cache, v_cache, lengths, rows)
    ref = _scaled_reference(q, k_cache, v_cache, lengths, rows, None, None)
    lib_err = (library().float() - ref.float()).abs().max().item()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    if err > tol or lib_err > tol:
        raise AssertionError(f"K3 on a bf16 pool: kernel {err}, SDPA {lib_err} > {tol}")
    visible = sum(int(n) + width - 1 for n in lengths.tolist())
    flops = sum(4 * hq // hkv * d * (int(n) + j) for n in lengths.tolist() for j in range(width)) * hkv
    bound_ms, bound_by = bound(2 * hkv * visible * d * 2 + 2 * nbytes(q) + nbytes(lengths, rows), flops)
    return {"max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
            **one_kernel_readings(lambda: decode_attention(q, k_cache, v_cache, lengths, rows)),
            "plain_ms": time_ms(lambda: _scaled_reference(q, k_cache, v_cache, lengths, rows, None, None)),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library),
            "library_device_ms": device_ms(library), "library_host_us": host_us(library),
            "library": "F.scaled_dot_product_attention(q, k, v, attn_mask=<length mask>, enable_gqa=True)",
            "shape": (f"q bf16 [{b},{hq},{width},{d}] pool bf16 [{k_cache.shape[0]},{hkv},{s},{d}] rows 0-{b - 1}"
                      f" lengths={lengths.tolist()}")}


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


@contextlib.contextmanager
def path_decode_inputs(found: dict):
    """Keep in ``found`` a copy of the inputs of the first decode step the
    model takes at each shape (``decode_attention_update``: K5 on a bf16
    cache, K2 then K3 on an int8 one), keyed by q's and the cache's shape
    and the cache's dtype, for ``path_decode_readings``."""
    update = lm_module.decode_attention_update

    def recorded(q, k_cache, v_cache, k_new, v_new, index, rows=None, k_scale=None, v_scale=None):
        key = (tuple(q.shape), tuple(k_cache.shape), k_cache.dtype, rows is None)
        if q.is_cuda and key not in found:
            found[key] = tuple(None if t is None else t.clone()
                               for t in (q, k_cache, v_cache, k_new, v_new, index, rows, k_scale, v_scale))
        return update(q, k_cache, v_cache, k_new, v_new, index, rows, k_scale, v_scale)

    with mock.patch.object(lm_module, "decode_attention_update", recorded):
        yield


def path_decode_reading(gen: torch.Generator, args: tuple) -> dict:
    """A main path's decode step at its own shape (``path_decode_inputs``),
    its kernel against the plain version (``plain_write``, then
    ``_scaled_reference``): on the path's own inputs (the first step of a
    call), on random caches with every row's new positions ending near the
    cache's end (row 0 at its last position), and at the causal edge
    (``mark_decode_edges``; rows alternate between a 64-position tile edge
    and the cache's end). A bf16 cache takes K5 (edge: its new rows are the
    marked positions), an int8 one K2 then K3 (edge: K3 on the marked
    cache). Raises past ``REL_TOL`` x max|plain| or where the kernel's cache
    writes differ from the plain version's by a bit."""
    q, k_cache, v_cache, k_new, v_new, index, rows, k_scale, v_scale = args
    b, hq, width, d = q.shape
    s, hkv, dev = k_cache.shape[2], k_cache.shape[1], q.device
    quantized = k_scale is not None
    phys = rows.tolist() if rows is not None else list(range(b))
    readings = {}

    def held(name, q, k_cache, v_cache, k_new, v_new, index):
        kk, vk, kp, vp = k_cache.clone(), v_cache.clone(), k_cache.clone(), v_cache.clone()
        out = decode_attention_update(q, kk, vk, k_new, v_new, index, rows, k_scale, v_scale)
        plain_write(kp, vp, k_new, v_new, index, rows, k_scale, v_scale)
        want = _scaled_reference(q, kp, vp, index + 1, rows, k_scale, v_scale)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = REL_TOL * want.float().abs().max().item()
        if not math.isfinite(err) or err > tol or not (torch.equal(kk, kp) and torch.equal(vk, vp)):
            raise AssertionError(f"path decode step {name} at q {list(q.shape)} cache {list(k_cache.shape)}"
                                 f" {k_cache.dtype}: {err} > {tol}, or the cache writes differ")
        readings[f"{name}_max_abs_err"], readings[f"{name}_tol"] = err, tol

    held("path_inputs", q, k_cache, v_cache, k_new, v_new, index)
    if quantized:
        caches = [torch.randint(-127, 128, k_cache.shape, generator=gen, device=dev, dtype=torch.int8)
                  for _ in range(2)]
    else:
        caches = [torch.randn(k_cache.shape, generator=gen, device=dev).to(k_cache.dtype) for _ in range(2)]
    new = [torch.randn(k_new.shape, generator=gen, device=dev).to(k_new.dtype) for _ in range(2)]
    q = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    end = torch.tensor([s - width - 70 * i for i in range(b)], dtype=torch.int32, device=dev)
    held("full_extent", q, *caches, *new, end)

    lengths = torch.tensor([min(64 * (2 + 5 * i), s - width) - 1 if i % 2 == 0 else s - width - 1 - 64 * i
                            for i in range(b)], dtype=torch.int32, device=dev)
    expected = mark_decode_edges(q, *caches, lengths, rows, v_scale)
    if quantized:
        out = decode_attention(q, *caches, lengths, rows, k_scale, v_scale)
    else:
        marked = [torch.stack([cache[row, :, n - 1: n - 1 + width] for row, n in zip(phys, lengths.tolist())])
                  for cache in caches]
        out = decode_attention_update(q, *caches, *marked, lengths - 1, rows)
    plain = _scaled_reference(q, *caches, lengths, rows, k_scale, v_scale)
    torch.cuda.synchronize()
    edge_err = (out.float() - expected).abs().max().item()
    plain_err = (plain.float() - expected).abs().max().item()
    edge_tol = REL_TOL * expected.abs().max().item()
    if max(edge_err, plain_err) > edge_tol:
        raise AssertionError(f"path decode step at the causal edge, q {list(q.shape)} {k_cache.dtype}:"
                             f" kernel {edge_err}, plain {plain_err} > {edge_tol}")
    return {"kernel": "K2 + K3" if quantized else "K5",
            "shape": f"q bf16 {list(q.shape)} caches {str(k_cache.dtype).removeprefix('torch.')} {list(k_cache.shape)}",
            "splits": decode_splits(b, hkv, s), "path_index": index.tolist(), "full_extent_index": end.tolist(),
            "edge_lengths": lengths.tolist(), **readings, "edge_max_abs_err": edge_err, "edge_tol": edge_tol,
            "cache_writes_bit_equal": True}


def path_decode_readings(seed: int, found: dict, path: str) -> dict:
    """``path_decode_reading`` at every decode shape a main path ran; the
    line, with the worst error over the tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    checks = []
    for args in found.values():
        check = path_decode_reading(gen, args)
        check["worst_ratio"] = max(check[f"{key}_max_abs_err"] / check[f"{key}_tol"]
                                   for key in ("path_inputs", "full_extent", "edge"))
        checks.append(check)
    if not checks:
        raise AssertionError(f"{path}: no decode step on the card to check")
    return {"phase": "path_decode", "path": path, "shapes": len(checks),
            "worst_ratio": max(c["worst_ratio"] for c in checks), "checks": checks}


def note_path_decode(kernels: dict, line: dict) -> None:
    """Each decode kernel's worst ratio over a path's shapes, in its entry
    of the ``kernels`` line (``{path}_path_worst_ratio``)."""
    for check in line["checks"]:
        name = "decode_attention_update" if check["kernel"] == "K5" else "decode_attention"
        key = f"{line['path']}_path_worst_ratio"
        kernels[name][key] = max(kernels[name].get(key, 0.0), check["worst_ratio"])


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
    normal x, where references with swapped or unsigned nibbles must fail;
    two launches on normal x give the same bits. Raises otherwise; returns
    the readings and, if ``timed``, the times: CUDA-event ms, the profiler's
    device ms, and the host's enqueue µs a call (``host_us``), each beside
    ``torch.matmul`` on the unpacked weight, both with the weight cold in L2."""
    packed = torch.randint(0, 256, (k2, n), generator=gen, device=dev, dtype=torch.uint8)
    x_int = torch.randint(-4, 5, (m, 2 * k2), generator=gen, device=dev).to(torch.bfloat16)
    got, want = int4_matmul(x_int, packed), int4_matmul_reference(x_int, packed)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        differ = (got != want).sum().item()
        raise AssertionError(f"int4_matmul at [{m},{2 * k2}] @ [{k2},{n}]: {differ} elements differ on integer x")
    x = torch.randn(m, 2 * k2, generator=gen, device=dev).to(torch.bfloat16)
    got, want = int4_matmul(x, packed), int4_matmul_reference(x, packed)
    if not torch.equal(got, int4_matmul(x, packed)):
        raise AssertionError(f"int4_matmul at [{m},{2 * k2}] @ [{k2},{n}]: two launches give different bits")
    check = closeness(got, want, *BF16_TOL)
    faults = {name: closeness(got, fault, *BF16_TOL)["ratio"] for name, fault in int4_faults(x, packed).items()}
    if not check["ratio"] <= 1:
        raise AssertionError(f"int4_matmul at [{m},{2 * k2}] @ [{k2},{n}] disagrees with its plain version: {check}")
    if not all(ratio > 1 for ratio in faults.values()):
        raise AssertionError(f"int4_matmul: a faulty plain version passes the check: {faults}")
    reading = {"shape": f"x bf16 [{m},{2 * k2}] @ packed uint8 [{k2},{n}]", "integer_x_bit_equal": True,
               "bit_identical_runs": True,
               "max_abs_err": check["max_abs_err"], "worst_ratio": check["ratio"],
               "tol": "|d| <= %g |want| + %g rms(want)" % BF16_TOL, "fault_ratios": faults}
    if not timed:
        return reading
    # A decode step reads each weight once, from HBM: K6 and the library call
    # are timed over copies of their weights that together exceed the 50 MB
    # L2 cache, one copy a call.
    packs = [packed] + [torch.randint(0, 256, (k2, n), generator=gen, device=dev, dtype=torch.uint8)
                        for _ in range(math.ceil(COLD_BYTES / nbytes(packed)) - 1)]
    unpacked = []
    for weight in packs[:math.ceil(COLD_BYTES / (4 * nbytes(packed)))]:
        w = torch.empty(2 * k2, n, dtype=torch.bfloat16, device=dev)  # the unpacked weight, for the library call
        w[0::2], w[1::2] = unpack_int4(weight)
        unpacked.append(w)
    k6 = rotating([functools.partial(int4_matmul, x, p) for p in packs])
    library = rotating([functools.partial(torch.matmul, x, w) for w in unpacked])
    bound_ms, bound_by = bound(nbytes(packed) + 2 * m * 2 * k2 + 2 * m * n, 2 * m * 2 * k2 * n)
    return dict(reading, ms=time_ms(k6), plain_ms=time_ms(lambda: int4_matmul_reference(x, packed)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(library),
                device_ms=device_ms(k6), library_device_ms=device_ms(library),
                host_us=host_us(k6), library_host_us=host_us(library), weight_copies=[len(packs), len(unpacked)])


def rotating(calls: list):
    """One callable that makes the next of ``calls`` each time, in turn."""
    turn = itertools.cycle(calls)
    return lambda: next(turn)()


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


# Calls of K2's plain versions, and of K1's (plain attention), on a CUDA
# tensor made by the port's modules (``watch_plain_writes``): the card's
# routes take K2 for every cache write and K1 for every attention.
PLAIN_ON_CARD = {"quantize_kv": 0, "update_cache_rows": 0, "mha_reference": 0}
PLAIN_MODULES = {"quantize_kv": decode_module, "update_cache_rows": decode_module, "mha_reference": attention_module}


@contextlib.contextmanager
def watch_plain_writes():
    """Count in ``PLAIN_ON_CARD`` each call of ``quantize_kv``,
    ``update_cache_rows`` or ``mha_reference`` on a CUDA tensor that goes
    through the port's modules' names (the port's own calls; the smoke's
    comparisons call the functions it imported)."""
    def watched(name, fn):
        def call(x, *args, **kwargs):
            PLAIN_ON_CARD[name] += x.device.type == "cuda"
            return fn(x, *args, **kwargs)
        return call

    with contextlib.ExitStack() as stack:
        for name, module in PLAIN_MODULES.items():
            stack.enter_context(mock.patch.object(module, name, watched(name, getattr(module, name))))
        yield


def reset_counts() -> None:
    for kernel in ALL_KERNELS:
        kernel.launches = 0
    flash_attention.reference_backwards = 0
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0


def counts() -> dict[str, int]:
    out = {kernel.__name__: kernel.launches for kernel in ALL_KERNELS}
    out["reference_backwards"] = flash_attention.reference_backwards
    out.update({f"{name}_on_card": n for name, n in PLAIN_ON_CARD.items()})
    return out


def check_write_routes(launched: dict[str, int], layers: int, prefills: int, decode_steps: int, path: str) -> None:
    """An int8-KV serving run's cache writes: K2 once a layer for each
    prefill call and each decode step, K3 once a layer a decode step, and
    no plain write or quantize on the card. Raises otherwise."""
    want = {"write_cache_rows": layers * (prefills + decode_steps), "decode_attention": layers * decode_steps,
            "quantize_kv_on_card": 0, "update_cache_rows_on_card": 0}
    got = {key: launched[key] for key in want}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


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
    expected = TRAIN_STEP_LAUNCHES
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
    transition (the EOS token's byte-DFA column: 258 for the BPE and HF
    vocabularies) is the accepting one."""
    state = grammar_walk(grammar, ids)
    eos_column = int(grammar.token_cols[grammar.tokenizer.EOS, 0])
    if int(grammar.dfa.next_state[state, eos_column]) != grammar.accept:
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
                    max_new: int = PROFILE_TOKENS) -> dict:
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


def profile_phase(engine: InferenceEngine, frames: np.ndarray, max_new: int = PROFILE_TOKENS) -> dict:
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


def parent_update(q, k_cache, v_cache, k_new, v_new, index, rows, k_scale, v_scale):
    """``decode_attention_update`` on an int8 cache as it was before K2
    quantized: ``parent_write``, then K3."""
    parent_write(k_cache, v_cache, k_new, v_new, index, rows, k_scale, v_scale)
    return decode_attention(q, k_cache, v_cache, index + 1, rows, k_scale, v_scale)


def decode_step_launches(engine: InferenceEngine, seed: int, cache_len: int, steps: int = 5) -> dict:
    """What one batch-2 int8-KV decode step (W = 3) of ``engine``'s decoder
    launches, through this route (K2 quantizes the new rows as it writes
    them) and through the parent's (``parent_update``: quantize_kv for k
    and v, then K2 on int8 rows, then K3), on the same weights and cache:
    K2 and K3 once a layer each (the wrappers' counts; raises otherwise), the device
    kernels and device ms a step (``device_profile`` over ``steps`` steps,
    each from the cache index after a 256-token prefill), and the ms a step
    (CUDA events; host-bound) in the order this, parent, parent, this."""
    model, dec = engine.model, engine.config.decoder
    dev = engine.device
    rng = np.random.default_rng(seed)
    cache = init_kv_cache(dec, 2, cache_len, model.compute_dtype, quant=True, device=dev)
    with torch.no_grad():
        tokens = torch.from_numpy(rng.integers(0, dec.vocab_size, (2, 256))).to(dev)
        _, cache = model.decoder(tokens, cache=cache, dtype=model.compute_dtype, prefill=True)
    start = cache["index"]
    block = torch.from_numpy(rng.integers(0, dec.vocab_size, (2, 3))).to(dev)
    pick = torch.tensor([2, 1], device=dev)

    def step():
        cache["index"] = start
        with torch.no_grad():
            model.decode_block_pick(block, cache, pick)

    before = (write_cache_rows.launches, decode_attention.launches)
    step()
    per_step = (write_cache_rows.launches - before[0], decode_attention.launches - before[1])
    if per_step != (dec.num_layers, dec.num_layers):
        raise AssertionError(f"an int8 decode step launched K2 and K3 {per_step} times, {dec.num_layers} layers")
    parent = mock.patch.object(lm_module, "decode_attention_update", parent_update)
    # A window of steps holds a fraction of a kernel more than a multiple of
    # ``steps`` (1,890.4 a step at base), so device_profile's test for dropped
    # records never passes here and every try would run: two tries keep the
    # retry for a window with no device time.
    device_ms, kernels = device_profile(step, calls=steps, tries=2)
    with parent:
        parent_device_ms, parent_kernels = device_profile(step, calls=steps, tries=2)
    step_ms = [time_ms(step, reps=5, rounds=5)]
    with parent:
        step_ms += [time_ms(step, reps=5, rounds=5), time_ms(step, reps=5, rounds=5)]
    step_ms.append(time_ms(step, reps=5, rounds=5))
    return {"layers": dec.num_layers, "k2_per_step": per_step[0], "k3_per_step": per_step[1],
            "device_launches_per_step": kernels, "parent_device_launches_per_step": parent_kernels,
            "launches_removed_per_step": parent_kernels - kernels,
            "device_ms_per_step": device_ms, "parent_device_ms_per_step": parent_device_ms,
            "step_ms": [step_ms[0], step_ms[3]], "parent_step_ms": step_ms[1:3]}


def int4_serving_phase(seed: int, dev: torch.device, tokenizer, grammar) -> tuple[dict, dict]:
    """Main path 4: int4 serving at the full ``7b`` width and
    ``INT4_SERVING_LAYERS`` of its decoder layers. Builds the engine
    (seeded random f32 weights, cast to bf16, decoder quantized to packed
    int4; int8 KV cache, the note grammar, greedy), holds K1-K3 at this
    path's shapes against their plain versions, then serves one batch of two
    16-frame clips with the launches counted from 0: K6 exactly 7 x layers
    x decode steps and never in prefill (M > 256 takes the unpacked route),
    K1-K3 at least once. Prints its lines; returns the kernel readings and
    the launches."""
    cfg = base_config(tokenizer.vocab_size, "7b")
    cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=INT4_SERVING_LAYERS))
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
              "decoder_layers": cfg.decoder.num_layers,
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
    check_write_routes(served, cfg.decoder.num_layers, 1, steps, "7b int4 serving")
    for line in requests:
        decode_s = line["call_seconds"] - line["prefill_ms"] / 1e3
        emit(dict(line, preset=cfg.name, quantize="int4", ms_per_step=decode_s * 1e3 / steps,
                  k6_launches=served["int4_matmul"], k6_prefill_launches=prefill_k6[0],
                  max_new_tokens_cap=MAX_NEW_TOKENS))
    emit(dict(profile_phase(engine, clips), preset=cfg.name))
    emit({"phase": "decode_step_launches", "preset": cfg.name, **decode_step_launches(engine, seed, cache_len)})
    return kernels, served


# -- the qwen2vl path (main path 11) ---------------------------------------------

QWEN_MAX_NEW = 128  # new tokens a request of the qwen2vl path
QWEN_CLIPS = 2  # 16-frame clips at 224 px in its one generate call
# The tiny Qwen geometry of the CPU reference (and of the CPU tests): the
# tower keeps head_dim 80 (160 / 2 heads); the decoder has q/k/v biases and
# an untied lm_head.
QWEN_TINY_VISION = dict(embed_dim=160, depth=2, num_heads=2, mlp_ratio=2.0, image_size=56, num_frames=4)
QWEN_TINY_DECODER = dict(hidden_dim=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128, mlp_dim=512,
                         max_seq_len=1024, qkv_bias=True, tied_embeddings=False)
HF_ROUND_TRIP_DEPTH = 2  # tower blocks and decoder layers of the HF checkpoint round trip


def qwen_tiny_config(vocab_size: int) -> VLMConfig:
    return VLMConfig(
        name="qwen-tiny",
        encoder=QwenVisionConfig(hidden_size=QWEN_TINY_DECODER["hidden_dim"], **QWEN_TINY_VISION),
        decoder=DecoderConfig(vocab_size=vocab_size, **QWEN_TINY_DECODER),
    )


def qwen_reference_phase(seed: int, dev: torch.device) -> dict:
    """The tiny Qwen geometry, bf16, int8 KV: prefill (the tower through K1
    at head_dim 80) and decode logits on the card against the plain
    versions on the CPU, same weights, with every bias and LayerNorm offset
    drawn at random (flax's init makes them zero)."""
    cfg = qwen_tiny_config(512)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cpu_model = random_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        for name, param in cpu_model.named_parameters():
            if name.endswith("bias"):
                param.copy_(torch.randn(param.shape, generator=gen) * 0.1)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(seed)
    side = cfg.encoder.image_size
    frames = torch.from_numpy(rng.integers(0, 256, (2, cfg.encoder.num_frames, side, side, 3), dtype=np.uint8))
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
            outs = [last.float().cpu()]
            for block in blocks:
                step, cache = model.decode_block_pick(block.to(device), cache, torch.tensor([2, 1], device=device))
                outs.append(step.float().cpu())
        logits[name] = torch.stack(outs)
    launched = counts()
    want_k1 = cfg.encoder.depth + cfg.decoder.num_layers
    if launched["flash_attention"] != want_k1 or launched["mha_reference_on_card"]:
        raise AssertionError(f"qwen reference: launches {launched}, expected K1 {want_k1} and no plain attention")
    err = (logits["cpu"] - logits["gpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    tol = GROUNDING_LOGIT_TOL * max(scale, 1.0)
    if not torch.isfinite(logits["gpu"]).all() or err > tol:
        raise AssertionError(f"tiny Qwen logits: card vs CPU max_abs_err {err} > {tol}")
    return {"phase": "qwen_reference", "preset": cfg.name, "vision": QWEN_TINY_VISION,
            "vision_head_dim": cfg.encoder.head_dim, "decoder": QWEN_TINY_DECODER, "max_abs_err": err,
            "tol": tol, "logit_scale": scale, "k1_launches": launched["flash_attention"]}


def hf_state_dict(cfg: VLMConfig, gen: torch.Generator, dev: torch.device) -> dict[str, torch.Tensor]:
    """A Qwen2-VL state dict of ``cfg``'s geometry under the hub's names,
    seeded (normal, std 0.02) on the card, then on the host: bf16 matrices
    and f32 vectors, as a checkpoint may mix them."""
    with torch.device("meta"):
        ported = VideoLM(cfg).state_dict()
    shapes = {}
    for hf_name, (path, transpose) in decoder_key_map(cfg.decoder.num_layers, cfg.decoder.qkv_bias,
                                                      cfg.decoder.tied_embeddings).items():
        shape = tuple(ported[".".join(path)].shape)
        shapes[hf_name] = shape[::-1] if transpose else shape
    for hf_name, (path, transpose) in vision_key_map(cfg.encoder.depth).items():
        shape = tuple(ported[".".join(("visual",) + path)].shape)
        shapes[f"visual.{hf_name}"] = shape[::-1] if transpose else shape
    enc = cfg.encoder
    shapes["visual.patch_embed.proj.weight"] = (enc.embed_dim, enc.in_channels, enc.temporal_patch_size,
                                                enc.patch_size, enc.patch_size)
    return {name: (torch.randn(shape, generator=gen, device=dev) * 0.02)
            .to(torch.float32 if len(shape) == 1 else torch.bfloat16).cpu()
            for name, shape in sorted(shapes.items())}


SAFETENSORS_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32"}


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """The safetensors format: an 8-byte little-endian header length, the
    JSON header (padded to 8 bytes), then each tensor's raw bytes."""
    header, offset = {}, 0
    for name, tensor in tensors.items():
        size = tensor.numel() * tensor.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[tensor.dtype], "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(len(raw).to_bytes(8, "little"))
        fh.write(raw)
        for tensor in tensors.values():
            fh.write(tensor.contiguous().reshape(-1).view(torch.uint8).numpy().data)


def write_hf_checkpoint(directory: Path, state: dict[str, torch.Tensor], shards: int = 2) -> int:
    """``state`` as ``shards`` safetensors files and the index that maps
    each name to its file, as the hub ships a sharded checkpoint; returns
    the bytes written."""
    names = list(state)
    weight_map, total = {}, 0
    for i in range(shards):
        part = names[i * len(names) // shards:(i + 1) * len(names) // shards]
        file = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        write_safetensors(directory / file, {name: state[name] for name in part})
        weight_map.update({name: file for name in part})
        total += (directory / file).stat().st_size
    (directory / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def hf_round_trip(seed: int, dev: torch.device, cfg: VLMConfig, tokenizer) -> dict:
    """An HF checkpoint at full ``qwen2vl-7b`` width and
    ``HF_ROUND_TRIP_DEPTH`` tower blocks and decoder layers, written as
    sharded safetensors with an index, loaded by ``engine.restore(dir)``;
    its weights and prefill logits must equal those of an engine built from
    the same state in memory through ``port_decoder_state`` /
    ``port_vision_state``."""
    cfg = replace(cfg, encoder=replace(cfg.encoder, depth=HF_ROUND_TRIP_DEPTH),
                  decoder=replace(cfg.decoder, num_layers=HF_ROUND_TRIP_DEPTH))
    settings = dict(tokenizer=tokenizer, max_new_tokens=8, temperature=0.0, param_dtype="bfloat16",
                    kv_quant="int8", device=dev)
    t0 = time.perf_counter()
    state = hf_state_dict(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    tree = port_decoder_state(state, cfg.decoder)
    tree["visual"] = port_vision_state(state, cfg.encoder)
    in_memory = InferenceEngine(cfg, params=from_jax_params({"params": tree}, cfg, device="cpu"), **settings)
    del tree
    with tempfile.TemporaryDirectory(prefix="vtx_hf_") as workdir:
        t1 = time.perf_counter()
        written = write_hf_checkpoint(Path(workdir), state)
        del state
        t2 = time.perf_counter()
        restored = InferenceEngine(cfg, **settings)
        restored.restore(workdir)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    want, got = in_memory.model.state_dict(), restored.model.state_dict()
    unequal = [name for name in want if not torch.equal(want[name], got[name])]
    if set(want) != set(got) or unequal:
        raise AssertionError(f"HF round trip: leaves differ from the in-memory port: {unequal[:4]}")
    rng = np.random.default_rng(seed)
    side = cfg.encoder.image_size
    frames = rng.integers(0, 256, (1, cfg.encoder.num_frames, side, side, 3), dtype=np.uint8)
    tokens = torch.from_numpy(rng.integers(0, 20000, (1, 128))).to(dev)
    logits = []
    for engine in (in_memory, restored):
        cache = init_kv_cache(cfg.decoder, 1, 1024, torch.bfloat16, quant=True, device=dev)
        with torch.no_grad():
            last, _ = engine.model.prefill(engine.preprocess(frames), tokens, cache,
                                           torch.tensor([128], dtype=torch.int32, device=dev))
        logits.append(last.float())
    err = (logits[0] - logits[1]).abs().max().item()
    if not torch.isfinite(logits[1]).all() or not torch.equal(logits[0], logits[1]):
        raise AssertionError(f"HF round trip: prefill logits differ from the in-memory port's ({err})")
    return {"phase": "qwen_hf_round_trip", "vision_depth": cfg.encoder.depth, "decoder_layers": cfg.decoder.num_layers,
            "leaves": len(want), "checkpoint_gib": written / 2**30, "shards": 2,
            "port_in_memory_seconds": t1 - t0, "write_seconds": t2 - t1, "restore_seconds": t3 - t2,
            "logits_equal": True, "max_abs_err": err, "logit_scale": logits[0].abs().max().item()}


def qwen_kernel_phase(seed: int, dev: torch.device, cfg: VLMConfig) -> dict:
    """K1 at the tower's shape, [clips x 8, 16, 256, 80] non-causal, timed
    beside SDPA; at head_dim 80 on the ragged shapes, causal and not (Sq !=
    Sk among them); head_dim 96 must raise on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = cfg.encoder
    groups, _, _ = enc.grid
    frame_tokens = enc.tokens_per_clip // groups
    k1 = check_flash(gen, dev, QWEN_CLIPS * groups, enc.num_heads, enc.num_heads, frame_tokens, causal=False,
                     d=enc.head_dim)
    q = torch.randn(QWEN_CLIPS * groups, enc.num_heads, frame_tokens, enc.head_dim, generator=gen,
                    device=dev).to(torch.bfloat16)
    k1["device_ms"] = device_ms(lambda: flash_attention(q, q, q, causal=False))
    ragged = flash_ragged_reading(gen, dev, enc.num_heads, enc.num_heads, d=enc.head_dim)
    emit({"phase": "flash_ragged", "preset": cfg.name, "head_dim": enc.head_dim, **ragged})
    k1["ragged_worst_ratio"] = ragged["worst_ratio"]
    k1["ragged_min_shifted_mask_ratio"] = ragged["min_shifted_mask_ratio"]
    wide = torch.zeros(2, 2, 128, 96, device=dev, dtype=torch.bfloat16)
    try:
        flash_attention(wide, wide, wide, causal=False)
    except ValueError as exc:
        k1["head_dim_96"] = str(exc)
    else:
        raise AssertionError("flash_attention took head_dim 96 on the card")
    return k1


def qwen2vl_phase(seed: int, dev: torch.device, smi: str) -> tuple[dict, dict[str, int]]:
    """Main path 11: ``qwen2vl-7b`` at its full width and depth (the
    32-block tower at head_dim 80, the 28-layer Qwen2 decoder with q/k/v
    biases and an untied 152,064-wide lm_head), seeded random weights made
    on the card, int4 decoder weights, int8 KV cache, greedy, under the
    validator grammar over the synthetic 152k HF vocabulary; two 16-frame
    224 px clips, 128 new tokens. Before it: K1 at the tower's shapes, the
    tiny Qwen reference and the HF checkpoint round trip. Launches are
    counted from 0 around the one generate call: K1 32 times in the tower
    and 28 in the decoder's prefill, K2 28 times a prefill and a decode
    step, K3 28 and K6 196 times a step, no plain attention or cache write
    on the card. Prints its lines; returns K1's readings and the launches."""
    cfg = get_preset("qwen2vl-7b")
    t0 = time.perf_counter()
    k1 = qwen_kernel_phase(seed + 11, dev, cfg)
    emit(dict(qwen_reference_phase(seed, dev), seconds=time.perf_counter() - t0))
    with tempfile.TemporaryDirectory(prefix="vtx_qwen_vocab_") as workdir:
        t0 = time.perf_counter()
        vocab_path = write_synth_qwen_vocab(Path(workdir) / "tokenizer.json", vocab_size=cfg.decoder.vocab_size)
        t1 = time.perf_counter()
        tokenizer = HfTokenizer(vocab_path, vocab_size=cfg.decoder.vocab_size)
        t2 = time.perf_counter()
    emit(dict(hf_round_trip(seed, dev, cfg, tokenizer), card=smi))
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    engine = InferenceEngine(
        cfg, max_new_tokens=QWEN_MAX_NEW, temperature=0.0, seed=seed, tokenizer=tokenizer,
        param_dtype="bfloat16", quantize="int4", kv_quant="int8", max_forced_run=2, device=dev,
    )
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    bits_seconds: list[float] = []
    with timed_grammar(bits_seconds):
        engine.dfa = engine.wrap_grammar(validator_dfa(engine.byte_vocab))
    weights = list(engine.model.parameters())
    packed = [w for w in weights if w.dtype == torch.uint8]
    emit({"phase": "qwen_setup", "preset": cfg.name, "vision_depth": cfg.encoder.depth,
          "vision_head_dim": cfg.encoder.head_dim, "decoder_layers": cfg.decoder.num_layers,
          "vocab_size": cfg.decoder.vocab_size, "video_tokens": cfg.video_tokens,
          "weights": "random, seeded", "quantize": "int4", "kv_quant": "int8",
          "params": sum(w.numel() for w in weights) + sum(w.numel() for w in packed),
          "int4_kernels": len(packed), "engine_seconds": t4 - t3,
          "init_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "resident_gib": torch.cuda.memory_allocated() / 2**30,
          "vocab_write_seconds": t1 - t0, "tokenizer_load_seconds": t2 - t1,
          "encode_branch": tokenizer.encode_branch, "grammar": "validator",
          "grammar_states": engine.dfa.num_states, "grammar_bits_seconds": bits_seconds[0],
          "card": smi})

    side = cfg.encoder.image_size
    clips = np.random.default_rng(seed + 12).integers(0, 256, (QWEN_CLIPS, cfg.encoder.num_frames, side, side, 3),
                                                      dtype=np.uint8)
    model = engine.model
    tower_k1, prefill_k6 = [], []
    encode_video, prefill = model.encode_video, model.prefill

    def counted_encode(*args):
        before = flash_attention.launches
        out = encode_video(*args)
        tower_k1.append(flash_attention.launches - before)
        return out

    def counted_prefill(*args):
        before = int4_matmul.launches
        out = prefill(*args)
        prefill_k6.append(int4_matmul.launches - before)
        return out

    model.encode_video, model.prefill = counted_encode, counted_prefill
    stats = engine.stats
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        texts, status, ids = engine.generate(clips, [PROMPT] * QWEN_CLIPS, return_status=True, return_tokens=True)
    finally:
        del model.encode_video, model.prefill
    launched = counts()
    steps, layers, depth = stats.decode_steps, cfg.decoder.num_layers, cfg.encoder.depth
    want = {"flash_attention": depth + layers, "write_cache_rows": layers * (1 + steps),
            "decode_attention": layers * steps, "int4_matmul": 7 * layers * steps, "decode_attention_update": 0,
            "reference_backwards": 0, "quantize_kv_on_card": 0, "update_cache_rows_on_card": 0,
            "mha_reference_on_card": 0}
    got = {key: launched[key] for key in want}
    if got != want or tower_k1 != [depth] or prefill_k6 != [0]:
        raise AssertionError(f"qwen2vl launches {got} (tower K1 {tower_k1}, prefill K6 {prefill_k6}), "
                             f"expected {want}")
    for row, (text, done, row_ids) in enumerate(zip(texts, status, ids)):
        if not 0 < len(row_ids) <= QWEN_MAX_NEW + 2:
            raise AssertionError(f"qwen2vl row {row}: {len(row_ids)} tokens")
        grammar_walk(engine.dfa, row_ids)
        if done:
            check_complete(engine.dfa, row, row_ids)
            json.loads(text)
    patches = engine.preprocess(clips)
    with torch.no_grad():
        tower_ms = time_ms(lambda: model.encode_video(patches), warmup=1, reps=2, rounds=3)
    decode_s = stats.generate_seconds - stats.prefill_seconds
    emit({
        "phase": "qwen2vl", "preset": cfg.name, "batch": QWEN_CLIPS, "frames": cfg.encoder.num_frames,
        "image_size": side, "max_new_tokens": QWEN_MAX_NEW, "tokens": [len(r) for r in ids],
        "complete": status, "decode_steps": steps, "tower_ms": tower_ms, "prefill_ms": stats.prefill_seconds * 1e3,
        "ms_per_step": decode_s * 1e3 / steps, "tokens_per_s": stats.tokens_per_second,
        "decode_tokens_per_s": stats.tokens_generated / decode_s, "peak_memory_gib":
        torch.cuda.max_memory_allocated() / 2**30, "launches": got, "tower_k1": tower_k1[0],
        "text_head": texts[0][:48], "card": smi,
    })
    k1["launches"] = got["flash_attention"]
    return k1, launched


# -- engine API phase (main path 5) ---------------------------------------------

API_PROMPTS = [
    render_prompt("validator", {"note_excerpt": '{"title": "梯度下降"}', "schema": "学习率 -> 梯度下降"}),
    render_prompt("validator", {"note_excerpt": '{"title": "注意力机制", "key_takeaways": ["聚合上下文"]}',
                                "schema": "查询 -> 键值"}),
]
API_CAP = 48  # the capped generate's and the batch bucket's budget
API_SESSION_CAP = 16  # a session round's budget
API_BUCKET = 4  # batch_bucket, for 3 real rows


def longest_accepted(dfa) -> int:
    """Bytes of the longest document an acyclic byte grammar accepts (the
    EOS that ends it not counted); raises on a grammar with a loop."""
    table = dfa.next_state
    states, depth, longest = {dfa.start}, 0, -1
    while states:
        if depth > table.shape[0]:
            raise AssertionError("grammar has a loop; no longest document")
        nxt = set()
        for state in states:
            row = table[state]
            for col in np.flatnonzero(row >= 0):
                if int(row[col]) == dfa.accept:  # only EOS enters the accepting state
                    longest = depth
                else:
                    nxt.add(int(row[col]))
        states, depth = nxt, depth + 1
    return longest


@contextlib.contextmanager
def decode_carries(engine: InferenceEngine, out: list):
    """Append each ``engine._decode`` call's entry logits (a prefill's
    last logits, or a session's carry) and its returned ``out_pos`` to
    ``out`` as CPU tensors."""
    decode = engine._decode

    def wrapped(logits, *args):
        result = decode(logits, *args)
        out.append((logits.float().cpu(), result[1].cpu()))
        return result

    with mock.patch.object(engine, "_decode", wrapped):
        yield


def walk_rows(grammar, status: list[bool], ids: list[list[int]], cap: int, where: str) -> None:
    for row, (done, row_ids) in enumerate(zip(status, ids)):
        if not 0 < len(row_ids) <= cap:
            raise AssertionError(f"{where} row {row}: {len(row_ids)} tokens, cap {cap}")
        grammar_walk(grammar, row_ids)
        if done:
            check_complete(grammar, row, row_ids)


def engine_api_phase(engine: InferenceEngine, clips: np.ndarray) -> tuple[list[dict], dict[str, int]]:
    """Main path 5: the engine API the analyzer calls, on the base-width
    int8 engine of path 1 (int8 weights, int8 KV cache; K1 in every prefill,
    K2 in every prefill and decode step, K3 in every decode step):

    - ``generate_text`` with the validator grammar on text-only prompts;
    - a capped ``generate`` of 3 clips under the note grammar, then one
      continuation by token-id ``prefixes`` of ragged lengths (row i drops
      its last i ids): every live row makes progress and its combined ids
      walk the grammar;
    - a session: ``generate(..., session_rounds=R, return_session=True)``
      under the validator grammar at ``API_SESSION_CAP`` tokens a round,
      then ``continue_session`` until every row completes. R is the least
      reserve in which the grammar's longest document fits, so the session
      completes; its combined ids must equal one call with the budget
      (1 + R) x cap + R x block_width, which sizes the same cache (K3's
      splits follow the cache length), and no round may prefill;
    - ``batch_bucket=4`` with 3 real rows: the real rows' ids equal the
      unbucketed call's, and the pad row generates nothing.

    Returns the lines and the launches, counted from 0 over the whole path."""
    stats = engine.stats
    layers = engine.config.decoder.num_layers
    note = engine.dfa
    validator = engine.wrap_grammar(validator_dfa(engine.byte_vocab))
    cap = engine.max_new_tokens
    prompts = [PROMPT, f"{PROMPT}（片段 2）", "请逐条展开每个要点。"]
    lines = []
    reset_counts()
    before = (stats.generate_calls, stats.session_resumes, stats.decode_steps)
    t0 = time.perf_counter()
    try:
        texts, status, ids = engine.generate_text(API_PROMPTS, dfa=validator, return_status=True, return_tokens=True)
        walk_rows(validator, status, ids, cap + 2, "generate_text")
        for done, text in zip(status, texts):
            if done:
                json.loads(text)
        lines.append({"phase": "api_generate_text", "grammar": "validator", "rows": len(ids),
                      "tokens": [len(r) for r in ids], "complete": status, "text_head": texts[0][:48]})

        engine.max_new_tokens = API_CAP
        _, status, ids = engine.generate(clips[:3], prompts, return_status=True, return_tokens=True)
        prefixes = [row[: len(row) - i] for i, row in enumerate(ids)]
        if len({len(p) for p in prefixes}) != len(prefixes):
            raise AssertionError(f"prefix lengths {[len(p) for p in prefixes]} are not ragged")
        _, more_status, more = engine.generate(clips[:3], prompts, prefixes=prefixes, return_status=True,
                                               return_tokens=True)
        combined = [p + m for p, m in zip(prefixes, more)]
        if not all(more):
            raise AssertionError(f"a continuation round made no progress: {[len(m) for m in more]}")
        walk_rows(note, more_status, combined, 3 * API_CAP, "prefix continuation")
        lines.append({"phase": "api_prefixes", "grammar": "note", "cap": API_CAP,
                      "prefix_lengths": [len(p) for p in prefixes], "tail_tokens": [len(m) for m in more],
                      "complete": more_status})

        engine.max_new_tokens = API_SESSION_CAP
        width = engine._block_width(validator)
        rounds = longest_accepted(validator.dfa) // API_SESSION_CAP + 1
        prefill_before = stats.prefill_tokens
        _, status, ids, session = engine.generate(
            clips[:2], API_PROMPTS, dfa=validator, session_rounds=rounds, return_session=True,
            return_status=True, return_tokens=True,
        )
        if session is None or session.rounds_left != rounds:
            raise AssertionError(f"session reserve: {session and session.rounds_left}, asked {rounds}")
        prefill_tokens = stats.prefill_tokens
        session_len = session.cache["k"][0].shape[2]
        combined, done, resumed = [list(r) for r in ids], list(status), 0
        while not all(done) and session.rounds_left > 0:
            _, now_done, more = engine.continue_session(session)
            for row in range(len(done)):
                if not done[row] and not more[row]:
                    raise AssertionError(f"session round {resumed + 1}: row {row} made no progress")
                combined[row] += more[row]
            done, resumed = now_done, resumed + 1
        if stats.prefill_tokens != prefill_tokens:
            raise AssertionError("a session round prefilled")
        if not all(done) or not resumed:
            raise AssertionError(f"session: complete {done} after {resumed} rounds of {rounds}")
        engine.max_new_tokens = (1 + rounds) * API_SESSION_CAP + rounds * width
        prompt_width = engine._prompt_bucket(API_PROMPTS, with_video=True)
        if engine._cache_len(prompt_width, True, validator, 0) != session_len:
            raise AssertionError("the long call's cache length differs from the session's")
        _, long_status, long_ids = engine.generate(clips[:2], API_PROMPTS, dfa=validator, return_status=True,
                                                   return_tokens=True)
        if long_ids != combined or long_status != done:
            raise AssertionError(f"session tokens {[len(r) for r in combined]} differ from the long call's "
                                 f"{[len(r) for r in long_ids]}")
        walk_rows(validator, done, combined, engine.max_new_tokens + 2, "session")
        lines.append({"phase": "api_session", "grammar": "validator", "round_cap": API_SESSION_CAP,
                      "reserve": rounds, "rounds_resumed": resumed, "cache_len": session_len,
                      "tokens": [len(r) for r in combined], "equals_long_call": True,
                      "long_max_new_tokens": engine.max_new_tokens,
                      "prefill_tokens_before_after": [prefill_before, prefill_tokens, stats.prefill_tokens]})

        engine.max_new_tokens = API_CAP
        plain = engine.generate(clips[:3], prompts, return_status=True, return_tokens=True)
        carries: list = []
        with decode_carries(engine, carries):
            bucketed = engine.generate(clips[:3], prompts, return_status=True, return_tokens=True,
                                       batch_bucket=API_BUCKET)
        out_pos = carries[0][1]
        if bucketed != plain or out_pos.shape[0] != API_BUCKET or int(out_pos[3]):
            raise AssertionError(f"batch bucket: real rows equal {bucketed == plain}, out_pos {out_pos.tolist()}")
        lines.append({"phase": "api_batch_bucket", "real_rows": 3, "bucket": API_BUCKET,
                      "tokens": [len(r) for r in plain[2]], "pad_row_tokens": int(out_pos[3]),
                      "real_rows_equal_unbucketed": True})
    finally:
        engine.max_new_tokens = cap
    launched = counts()
    calls, resumes, steps = (now - then for now, then in zip(
        (stats.generate_calls, stats.session_resumes, stats.decode_steps), before))
    prefills = calls - resumes
    check_write_routes(launched, layers, prefills, steps, "engine_api")
    if not launched["flash_attention"]:
        raise AssertionError(f"engine_api: K1 never launched: {launched}")
    lines.append({"phase": "engine_api", "preset": engine.config.name, "seconds": time.perf_counter() - t0,
                  "prefills": prefills, "session_rounds": resumes, "decode_steps": steps,
                  "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows",
                                                                 "decode_attention")}})
    return lines, launched


# -- grounding phase (main path 6) -----------------------------------------------

TINY_WEIGHTS = REPO / "data" / "torch_weights" / "tiny-zh-grounded-r5mix-params_4500.npz"
GROUNDING_TOPICS, GROUNDING_COMPOSITES, GROUNDING_BATCH, GROUNDING_SEED = 16, 8, 4, 99
GROUNDING_MAX_NEW = 1536  # the eval's default cap
GROUNDING_LOGIT_TOL = 2e-2  # first-token logits, card against CPU, x max|logit|
# The JAX package's eval of the checkpoint on the CPU, greedy, at the eval's
# own settings (bf16 weights, bf16 KV cache, compact prompt, seed 99): 10/16
# single topics, 0/8 composites.
JAX_GREEDY_TOPICS = {
    "梯度下降": True, "卷积神经网络": True, "批归一化": True, "过拟合": True, "层归一化": True, "数据增强": True,
    "模型量化": True, "混合精度": True, "激活函数": True, "交叉验证": False, "早停策略": False, "支持向量机": False,
    "强化学习": False, "对比学习": True, "图神经网络": False, "稀疏专家": False,
}
JAX_GREEDY_COMPOSITES = {
    "迁移学习+聚类分析": "neither", "词向量+混合精度": "primary", "优化器+降维方法": "primary",
    "混合精度+学习率调度": "primary", "注意力机制+梯度下降": "primary", "序列到序列+位置编码": "secondary",
    "特征工程+循环神经网络": "neither", "残差连接+优化器": "primary",
}
# The setting at temperature 0.7 scores 8 single topics and no composites
# (to keep the smoke within its 5 minutes: 16 + 8 took 26 s).
SAMPLED_TOPICS, SAMPLED_COMPOSITES = 8, 0


def grounding_engine(cfg: VLMConfig, tokenizer, device, grammar=None, **kwargs) -> InferenceEngine:
    """The eval's engine (bf16 weights, seed 1, 1,536 new tokens) with the
    trained tiny weights restored from the committed ``.npz``."""
    kwargs = {"param_dtype": "bfloat16", "max_new_tokens": GROUNDING_MAX_NEW, **kwargs}
    engine = InferenceEngine(cfg, tokenizer=tokenizer, seed=1, device=device, **kwargs)
    engine.dfa = grammar or engine.wrap_grammar(note_dfa(engine.byte_vocab))
    engine.restore(TINY_WEIGHTS)
    return engine


def grounding_run(engine: InferenceEngine, setting: str, topics: int = GROUNDING_TOPICS,
                  composites: int = GROUNDING_COMPOSITES) -> tuple[dict, dict[str, int], list]:
    """One scorecard run through ``run_eval`` with the launches counted from
    0: every row walks the grammar (``check_complete`` where complete); K2
    writes once a layer a prefill, and each decode step runs K5 once a layer
    (bf16 cache) or K2 and K3 once a layer each (int8 cache); nothing plain
    writes on the card. Returns the line, the launches and each call's
    (clips, prompts, entry logits)."""
    stats = engine.stats
    layers = engine.config.decoder.num_layers
    calls: list = []
    carries: list = []
    generate = engine.generate

    def recorded(frames, prompts, **kwargs):
        texts, status, ids = generate(frames, prompts, return_status=True, return_tokens=True, **kwargs)
        walk_rows(engine.dfa, status, ids, GROUNDING_MAX_NEW + 2, setting)
        calls.append((frames, prompts))
        return texts

    topic_ids, pairs = eval_inputs(topics, composites)
    before = (stats.generate_calls, stats.decode_steps, stats.tokens_generated, stats.generate_seconds,
              stats.prefill_seconds)
    reset_counts()
    with mock.patch.object(engine, "generate", recorded), decode_carries(engine, carries):
        report = run_eval(engine, topic_ids, GROUNDING_BATCH, seed=GROUNDING_SEED, composite_pairs=pairs or None)
    launched = counts()
    prefills, steps, tokens, seconds, prefill_seconds = (
        now - then for now, then in zip((stats.generate_calls, stats.decode_steps, stats.tokens_generated,
                                         stats.generate_seconds, stats.prefill_seconds), before))
    if engine.kv_quant == "int8":
        check_write_routes(launched, layers, prefills, steps, f"grounding {setting}")
    elif (launched["write_cache_rows"], launched["decode_attention_update"], launched["decode_attention"],
          launched["update_cache_rows_on_card"]) != (layers * prefills, layers * steps, 0, 0):
        raise AssertionError(f"grounding {setting}: launches {launched} for {prefills} prefills, {steps} steps")
    if not launched["flash_attention"]:
        raise AssertionError(f"grounding {setting}: K1 never launched")
    decode_s = seconds - prefill_seconds
    line = {
        "phase": "grounding", "setting": setting, "temperature": engine.temperature,
        "weights": engine.quantize or "bfloat16", "kv_cache": engine.kv_quant or "bfloat16",
        "hits": report["hits"], "total": report["total"], "composite_hits": report.get("composite_hits", 0),
        "composite_total": report.get("composite_total", 0), "per_topic": report["per_topic"],
        "per_composite": report.get("per_composite", {}),
        "per_topic_diff_vs_jax_greedy": {name: [JAX_GREEDY_TOPICS[name], hit]
                                         for name, hit in report["per_topic"].items()
                                         if hit != JAX_GREEDY_TOPICS[name]},
        "per_composite_diff_vs_jax_greedy": {label: [JAX_GREEDY_COMPOSITES[label], got]
                                             for label, got in report.get("per_composite", {}).items()
                                             if got != JAX_GREEDY_COMPOSITES[label]},
        "prefills": prefills, "decode_steps": steps, "tokens": tokens, "wall_seconds": report["wall_seconds"],
        "decode_tokens_per_s": tokens / decode_s if decode_s else 0.0,
        "ms_per_step": decode_s / steps * 1e3 if steps else 0.0,
        "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows", "decode_attention",
                                                       "decode_attention_update")},
    }
    return line, launched, [(frames, prompts, logits) for (frames, prompts), (logits, _) in zip(calls, carries)]


def grounding_phase(dev: torch.device, tokenizer, smi: str) -> tuple[list[dict], dict[str, int]]:
    """Main path 6: the grounding scorecard of the trained tiny checkpoint
    (``tiny-zh-grounded-r5mix/params_4500``, full trained width) in three
    settings: the eval's own (bf16 weights and KV cache, greedy: K1, K2 in
    prefill, K5), the shipped serving one (int8 weights and KV cache, greedy:
    K1, K2, K3) and the shipped temperature (0.7, at the eval's settings, on
    ``SAMPLED_TOPICS`` topics and no composites).
    The first is held to the CPU's plain path (every row's first-token
    logits within ``GROUNDING_LOGIT_TOL`` x max|logit|) and to the JAX
    eval's score (single topics and composites each within 1 of 10/16 and
    0/8). Returns the lines and the launches summed over the settings."""
    cfg = base_config(tokenizer.vocab_size, "tiny")
    greedy = grounding_engine(cfg, tokenizer, dev, temperature=0.0)
    settings = (
        ("eval_greedy", greedy),
        ("serving_int8_greedy", grounding_engine(cfg, tokenizer, dev, greedy.dfa, temperature=0.0,
                                                 quantize="int8", kv_quant="int8")),
        ("eval_temperature_0.7", grounding_engine(cfg, tokenizer, dev, greedy.dfa, temperature=0.7)),
    )
    lines, total = [], dict.fromkeys(counts(), 0)
    for setting, engine in settings:
        sampled = setting == "eval_temperature_0.7"
        line, launched, calls = grounding_run(engine, setting, *((SAMPLED_TOPICS, SAMPLED_COMPOSITES) if sampled
                                                                 else (GROUNDING_TOPICS, GROUNDING_COMPOSITES)))
        total = {name: total[name] + launched[name] for name in total}
        if setting == "eval_greedy":
            cpu = grounding_engine(cfg, tokenizer, "cpu", greedy.dfa, temperature=0.0, max_new_tokens=0)
            worst = 0.0
            for frames, prompts, logits in calls:
                want: list = []
                with decode_carries(cpu, want):
                    cpu.generate(frames, prompts)
                ref = want[0][0]
                err = (logits - ref).abs().max().item()
                worst = max(worst, err / (GROUNDING_LOGIT_TOL * max(ref.abs().max().item(), 1.0)))
            if not math.isfinite(worst) or worst > 1:
                raise AssertionError(f"grounding: first-token logits off the CPU's by {worst} x the tolerance")
            line.update(first_logits_worst_ratio=worst, first_logits_tol=GROUNDING_LOGIT_TOL)
            jax_hits = sum(JAX_GREEDY_TOPICS.values())
            jax_composites = sum(v == "both" for v in JAX_GREEDY_COMPOSITES.values())
            if abs(line["hits"] - jax_hits) > 1 or abs(line["composite_hits"] - jax_composites) > 1:
                raise AssertionError(f"grounding: {line['hits']}/16 and {line['composite_hits']}/8 against JAX's "
                                     f"{jax_hits}/16 and {jax_composites}/8")
            line.update(jax_hits=jax_hits, jax_composite_hits=jax_composites)
        lines.append(dict(line, card=smi))
    return lines, total


# Main path 7, the analyzer: ``ContentAnalyzer.analyze_video`` from a clip on
# disk to the rendered note, on the port's own config
# (``utils/config.json``). (a) The trained tiny checkpoint restored from the
# committed ``.npz`` at the shipped serving settings (BPE, compact prompts,
# int8 weights and KV), greedy, at the scorecard's 1,536 tokens, on a
# single-pass clip of one grounded topic. (b) ``base`` at its full width
# and depth with seeded random weights at the shipped settings and
# temperature 0.7: a single-pass clip (the engine route) and a 25-minute
# clip that the shipped planner cuts into 4 segments, swept by ``auto``
# through the continuous batcher (2 slots, batches of 2).
ANALYZER_TOPIC = 0  # the grounded topic of (a)'s clip
ANALYZER_CLIP_FRAMES, ANALYZER_CLIP_FPS = 16, 4.0  # (a) and (b)'s single-pass clips: 4 s
ANALYZER_LONG_SECONDS, ANALYZER_LONG_FPS = 1500, 1.0  # (b)'s long clip: 4 segments of 480 s, overlap 20
ANALYZER_FRAME_SIZE = 64  # clips' frames on disk; preprocess resizes them to the preset's 256
# Random weights decode a free field to its budget and a list's loop at
# will, so (b) takes the JAX tests' random-weight setting: note fields at a
# quarter of their budgets and a 2.5 logit bias toward the JSON closers
# (the shipped 0.0 is for trained weights). Its notes then close in 100-200
# tokens (a one-layer model of base width on the CPU); the cap leaves room.
ANALYZER_BASE_SCALE, ANALYZER_BASE_BIAS, ANALYZER_BASE_MAX_NEW = 0.25, 2.5, 512
ANALYZER_BASE_BATCH, ANALYZER_BASE_SLOTS = 2, 2  # segment_batch_per_chip, serving_slots_per_chip


def shortest_accepted(dfa) -> int:
    """Bytes of the shortest document a byte grammar accepts (the EOS that
    ends it not counted)."""
    table = dfa.next_state
    seen, frontier, depth = {dfa.start}, {dfa.start}, 0
    while frontier:
        nxt = set()
        for state in frontier:
            row = table[state]
            for col in np.flatnonzero(row >= 0):
                if int(row[col]) == dfa.accept:
                    return depth
                if int(row[col]) not in seen:
                    seen.add(int(row[col]))
                    nxt.add(int(row[col]))
        frontier, depth = nxt, depth + 1
    raise AssertionError("grammar accepts nothing")


class LogLines(logging.Handler):
    """Keeps the analyzer's log messages."""

    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def analyzer_config(workdir: Path, **engine) -> dict:
    """The port's shipped config (``utils/config.json``) with the run's
    directories under ``workdir``, the tokenizer path made absolute and
    ``engine`` overrides."""
    config = copy.deepcopy(load_config())
    for key in ("temp_dir", "output_dir", "log_dir"):
        config["system"][key] = str(workdir / key)
    config["engine"]["tokenizer"] = dict(config["engine"]["tokenizer"], path=str(TOKENIZER))
    config["engine"].update(engine)
    return config


@contextlib.contextmanager
def analyzer_tally(engine: InferenceEngine, tally: dict):
    """Count in ``tally`` the engine's prefill calls (``_execute``) and
    decode steps (``_decode``, sessions' too) and the batcher's stages."""
    execute, decode, stage = engine._execute, engine._decode, ContinuousBatcher._stage

    def counted_execute(*args):
        tally["prefills"] += 1
        return execute(*args)

    def counted_decode(*args):
        out = decode(*args)
        tally["engine_steps"] += out[3]
        return out

    def counted_stage(batcher):
        before = batcher._staged_total
        stage(batcher)
        tally["stages"] += batcher._staged_total > before

    with mock.patch.object(engine, "_execute", counted_execute), \
            mock.patch.object(engine, "_decode", counted_decode), \
            mock.patch.object(ContinuousBatcher, "_stage", counted_stage):
        yield


def analyzer_run(analyzer: ContentAnalyzer, log: LogLines, clip: Path, label: str, smi: str) -> tuple[dict, dict]:
    """One ``analyze_video`` call with the launches counted from 0: K1 in
    every prefill; K2 once a layer for each engine prefill, int8 decode step
    and batcher stage; K3 once a layer an engine decode step; K4 once a
    layer a stage; K5 once a layer a batcher decode step; nothing plain on
    the card. The note renders (``generate_report``, the shipped
    ``self_check_mode``) under its title, and the report and the note's
    default-mode layout (the one with hard structural rules) pass
    ``validate_markdown_structure``. Returns the line and the launches."""
    engine = analyzer.engine
    layers = engine.config.decoder.num_layers
    stats = engine.stats
    before = (stats.decode_steps, stats.tokens_generated, stats.session_resumes, stats.frames_preprocessed)
    logged = len(log.messages)
    tally = dict.fromkeys(("prefills", "engine_steps", "stages"), 0)
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with analyzer_tally(engine, tally):
        result = analyzer.analyze_video(clip)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts()
    steps, tokens, resumes, frames = (now - then for now, then in zip(
        (stats.decode_steps, stats.tokens_generated, stats.session_resumes, stats.frames_preprocessed), before))
    batcher_steps = steps - tally["engine_steps"]
    events = log.messages[logged:]
    route = ("batcher" if any(m.startswith("event=segment_serving") for m in events)
             else "engine" if result.metadata.get("segments", 1) == 1 else "engine_segments")
    want = {"write_cache_rows": layers * (tally["prefills"] + tally["engine_steps"] + tally["stages"]),
            "decode_attention": layers * tally["engine_steps"], "adopt_rows": layers * tally["stages"],
            "decode_attention_update": layers * batcher_steps, "quantize_kv_on_card": 0,
            "update_cache_rows_on_card": 0}
    got = {key: launched[key] for key in want}
    if got != want or not launched["flash_attention"]:
        raise AssertionError(f"analyzer {label}: launches {launched}, expected {want} and K1")
    mode = analyzer.config["system"]["self_check_mode"]
    report = analyzer.generate_report(result, "images/blueprint.png", self_check_mode=mode)
    layout = result.knowledge_doc.to_markdown(self_check_mode="default")
    ok, errors = validate_markdown_structure(layout, "default")
    if not ok or not validate_markdown_structure(report, mode)[0]:
        raise AssertionError(f"analyzer {label}: the note does not validate: {errors}")
    if not report.startswith(f"# {result.title}"):
        raise AssertionError(f"analyzer {label}: the report does not open with the note's title")
    line = {"phase": "analyzer", "run": label, "route": route, "wall_seconds": wall,
            "segments": result.metadata.get("segments", 1),
            "segments_analyzed": result.metadata.get("segments_analyzed", 1),
            "segment_gaps": len(result.metadata.get("segment_gaps", [])), "engine_prefills": tally["prefills"],
            "engine_decode_steps": tally["engine_steps"], "batcher_stages": tally["stages"],
            "batcher_decode_steps": batcher_steps, "decode_steps": steps, "tokens": tokens,
            "session_resumes": resumes, "frames_preprocessed": frames,
            "tokens_per_s": tokens / wall, "ms_per_step": wall * 1e3 / steps if steps else 0.0,
            "model_calls": analyzer.api_counter.current_count, "report_bytes": len(report.encode("utf-8")),
            "title": result.title, "summary": result.knowledge_doc.one_sentence_summary,
            "chapters": len(result.knowledge_doc.deep_dive),
            "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows",
                                                           "decode_attention", "adopt_rows",
                                                           "decode_attention_update")},
            "engine_stats": stats.as_dict(), "events": sorted({m.split()[0] for m in events}), "card": smi}
    return line, launched


def analyzer_phase(seed: int, smi: str) -> tuple[list[dict], dict[str, int]]:
    """Main path 7 (see the constants above): (a) then (b), each through
    ``ContentAnalyzer(config, APICounter(...), logger)`` on the port's
    config. (a) must log ``event=engine_restored``; (b)'s single pass must
    take the engine route and its long clip the batcher. Returns the lines
    and the launches summed over the runs."""
    lines, total = [], dict.fromkeys(counts(), 0)
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="vtx_analyzer_") as tmp:
        workdir = Path(tmp)
        log = LogLines()
        logger = logging.getLogger("vtx.chip_smoke.analyzer")
        logger.handlers, logger.propagate = [log], False
        logger.setLevel(logging.INFO)

        # (a) The trained tiny checkpoint.
        config = analyzer_config(workdir / "tiny", model_preset="tiny", checkpoint_dir=str(TINY_WEIGHTS),
                                 temperature=0.0, max_new_tokens=GROUNDING_MAX_NEW)
        t0 = time.perf_counter()
        analyzer = ContentAnalyzer(config, APICounter(config["system"]["max_api_calls"]), logger)
        engine = analyzer.engine
        if f"event=engine_restored checkpoint={TINY_WEIGHTS}" not in log.messages:
            raise AssertionError(f"analyzer (a): the checkpoint was not restored: {log.messages}")
        setup = time.perf_counter() - t0
        clip = workdir / "topic.npzv"
        cfg = engine.config.encoder
        write_npzv(clip, render_topic_clip(ANALYZER_TOPIC, ANALYZER_CLIP_FRAMES, cfg.image_size, rng),
                   ANALYZER_CLIP_FPS)
        line, launched = analyzer_run(analyzer, log, clip, "tiny_trained_single", smi)
        lines.append(dict(line, setup_seconds=setup, checkpoint=str(TINY_WEIGHTS.relative_to(REPO)),
                          weights=engine.quantize, kv_cache=engine.kv_quant, temperature=engine.temperature,
                          max_new_tokens=engine.max_new_tokens))
        total = {name: total[name] + launched[name] for name in total}
        if line["route"] != "engine":
            raise AssertionError(f"analyzer (a): route {line['route']}")
        del analyzer, engine

        # (b) base at full width and depth, random weights, temperature 0.7.
        config = analyzer_config(workdir / "base", checkpoint_dir=None, grammar_scale=ANALYZER_BASE_SCALE,
                                 structure_bias=ANALYZER_BASE_BIAS, max_new_tokens=ANALYZER_BASE_MAX_NEW)
        config["analyzer"]["long_video"].update(segment_batch_per_chip=ANALYZER_BASE_BATCH,
                                                serving_slots_per_chip=ANALYZER_BASE_SLOTS)
        t0 = time.perf_counter()
        analyzer = ContentAnalyzer(config, APICounter(config["system"]["max_api_calls"]), logger)
        engine = analyzer.engine
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        shortest = shortest_accepted(note_dfa(engine.byte_vocab, scale=ANALYZER_BASE_SCALE))
        settings = {"preset": engine.config.name, "decoder_layers": engine.config.decoder.num_layers,
                    "encoder_layers": engine.config.encoder.num_layers, "weights": "random, seeded",
                    "quantize": engine.quantize, "kv_cache": engine.kv_quant, "temperature": engine.temperature,
                    "max_forced_run": engine.max_forced_run, "grammar_scale": ANALYZER_BASE_SCALE,
                    "structure_bias": engine.structure_bias, "max_new_tokens": engine.max_new_tokens,
                    "shortest_accepted_note_bytes": shortest, "longest_accepted_note_bytes": None,
                    "setup_seconds": setup}
        if shortest >= engine.max_new_tokens:
            raise AssertionError(f"analyzer (b): the shortest note ({shortest} bytes) exceeds the cap")
        frames = rng.integers(0, 256, (ANALYZER_CLIP_FRAMES, ANALYZER_FRAME_SIZE, ANALYZER_FRAME_SIZE, 3),
                              dtype=np.uint8)
        short = workdir / "short.npzv"
        write_npzv(short, frames, ANALYZER_CLIP_FPS)
        n_long = int(ANALYZER_LONG_SECONDS * ANALYZER_LONG_FPS)
        long = workdir / "lecture.npzv"
        write_npzv(long, rng.integers(0, 256, (n_long, ANALYZER_FRAME_SIZE, ANALYZER_FRAME_SIZE, 3),
                                      dtype=np.uint8), ANALYZER_LONG_FPS)
        for clip, label, route in ((short, "base_single", "engine"), (long, "base_segments", "batcher")):
            line, launched = analyzer_run(analyzer, log, clip, label, smi)
            lines.append(dict(line, **settings))
            total = {name: total[name] + launched[name] for name in total}
            if line["route"] != route:
                raise AssertionError(f"analyzer {label}: route {line['route']}, expected {route}")
        if lines[-1]["segments"] < 3 or lines[-1]["segments_analyzed"] != lines[-1]["segments"]:
            raise AssertionError(f"analyzer base_segments: {lines[-1]['segments_analyzed']} of "
                                 f"{lines[-1]['segments']} segments analyzed")
        del analyzer, engine
    torch.cuda.empty_cache()
    return lines, total


# Main path 8, the system's own entry point (``pipeline``): the CLI from a
# clip on disk to the saved note, blueprint and audit. (a) ``base`` at full
# width and depth through ``cli.main([...])`` in-process on the port's
# config, random weights as in the analyzer's (b), with the validator and
# the auditor scoring through the engine (``use_engine``, 2 rounds). The
# auditor's threshold is 0: random weights judge at random, and the image
# must be kept for its PNG to be checked (the audit still runs and its
# score is printed). (b) The trained tiny checkpoint through ``python -m
# video_transformer_tpu_torch --batch LIST --sharded`` in a fresh process,
# twice (the second run skips both clips through the progress file), then
# a ``WatchService`` scan over one clip in this process.
PIPELINE_AUDIT_THRESHOLD = 0.0
PIPELINE_ROUNDS = 2
PIPELINE_TOPICS = (0, 3)  # (b)'s grounded topics
PIPELINE_CLI_TIMEOUT = 300
STEPS = ((VideoDownloader, "download_video", "download"), (ContentAnalyzer, "analyze_video", "analyze"),
         (VideoPipeline, "_validation_loop", "validate"), (ImageGenerator, "generate_blueprint", "render"),
         (QualityAuditor, "audit_image", "audit"), (VideoPipeline, "_save_outputs", "save"))
CALLS = ((ConsistencyValidator, "_model_score", "validator"), (ContentAnalyzer, "rewrite_visual_schema", "rewrite"),
         (QualityAuditor, "_model_score", "audit"))


@contextlib.contextmanager
def engine_calls(record: list, label=None):
    """One entry per engine call in ``record``: ``label()``'s name for it
    where given, with video or text-only, rows, decode steps, tokens,
    seconds, tok/s, ms a step and K1 launches."""
    execute = InferenceEngine._execute

    def counted(engine, frames, *args):
        stats = engine.stats
        before = (stats.decode_steps, stats.tokens_generated, flash_attention.launches)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = execute(engine, frames, *args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        steps, tokens = stats.decode_steps - before[0], stats.tokens_generated - before[1]
        record.append({**({"call": label()} if label else {}), "video": frames is not None, "rows": args[3],
                       "decode_steps": steps, "tokens": tokens, "seconds": seconds, "tokens_per_s": tokens / seconds,
                       "ms_per_step": seconds * 1e3 / steps if steps else 0.0,
                       "k1_launches": flash_attention.launches - before[2]})
        return out

    with mock.patch.object(InferenceEngine, "_execute", counted):
        yield


@contextlib.contextmanager
def pipeline_probes(record: dict):
    """Class-level wrappers that fill ``record``: the seconds of each of the
    pipeline's steps (``steps``, summed over videos); one entry per engine
    call (``calls``: prefill with or without video, decode steps, tokens,
    seconds, K1 launches), labelled note, validator, rewrite or audit by
    the component that made it; each validation's verdict (``verdicts``);
    and each ``ProcessResult`` (``results``)."""
    record.update(steps=dict.fromkeys([label for _, _, label in STEPS], 0.0), calls=[], verdicts=[], results=[])
    labels = ["note"]

    def timed(fn, label):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                record["steps"][label] += time.perf_counter() - start
        return inner

    def labelled(fn, label):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            labels.append(label)
            try:
                return fn(*args, **kwargs)
            finally:
                labels.pop()
        return inner

    validate, process = ConsistencyValidator.validate, VideoPipeline.process_single_video

    def counted_validate(validator, *args, **kwargs):
        out = validate(validator, *args, **kwargs)
        record["verdicts"].append({"score": out.total_score, "passed": out.passed})
        return out

    def kept_result(pipeline, *args, **kwargs):
        out = process(pipeline, *args, **kwargs)
        record["results"].append(out)
        return out

    with contextlib.ExitStack() as stack:
        for cls, name, label in STEPS:
            stack.enter_context(mock.patch.object(cls, name, timed(getattr(cls, name), label)))
        for cls, name, label in CALLS:
            stack.enter_context(mock.patch.object(cls, name, labelled(getattr(cls, name), label)))
        stack.enter_context(engine_calls(record["calls"], lambda: labels[-1]))
        stack.enter_context(mock.patch.object(ConsistencyValidator, "validate", counted_validate))
        stack.enter_context(mock.patch.object(VideoPipeline, "process_single_video", kept_result))
        yield


def pipeline_launch_check(launched: dict, calls: list[dict], layers: int, label: str) -> None:
    """K1 in every engine call's prefill (video or text); K2 once a layer
    for each prefill and int8 decode step; K3 once a layer a step; no
    batcher kernel and nothing plain on the card."""
    steps = sum(c["decode_steps"] for c in calls)
    want = {"write_cache_rows": layers * (len(calls) + steps), "decode_attention": layers * steps,
            "adopt_rows": 0, "decode_attention_update": 0, "quantize_kv_on_card": 0, "update_cache_rows_on_card": 0}
    got = {key: launched[key] for key in want}
    if got != want or not all(c["k1_launches"] for c in calls):
        raise AssertionError(f"pipeline {label}: launches {launched} for {len(calls)} engine calls and {steps} "
                             f"decode steps, expected {want} and K1 in every call: {calls}")


def pipeline_outputs(config: dict, video_id: str, label: str, progress_name: str = "progress.json") -> dict:
    """The files one processed video leaves: the note, the quality report,
    the 1280x720 blueprint the port's reader decodes, the progress file
    (the CLI's, or the watch service's ``service_progress.json``)."""
    output = Path(config["system"]["output_dir"])
    note = output / "documents" / f"{video_id}_knowledge_note.md"
    report = output / "documents" / f"{video_id}_quality_report.json"
    png = output / "blueprints" / f"{video_id}_mind_map.png"
    progress = Path(config["system"]["temp_dir"]) / progress_name
    missing = [str(path) for path in (note, report, png, progress) if not path.exists()]
    if missing:
        raise AssertionError(f"pipeline {label}: missing outputs {missing}")
    pixels = decode_png(png.read_bytes())
    if pixels.shape != (720, 1280, 3):
        raise AssertionError(f"pipeline {label}: blueprint {pixels.shape}, expected (720, 1280, 3)")
    processed = json.loads(progress.read_text(encoding="utf-8"))["processed"]
    if video_id not in processed:
        raise AssertionError(f"pipeline {label}: {video_id} not in progress.json {processed}")
    text = note.read_text(encoding="utf-8")
    return {"note_bytes": len(text.encode("utf-8")), "note_lines": len(text.splitlines()),
            "note_title": text.splitlines()[0] if text else "", "png_bytes": png.stat().st_size,
            "quality_gates_triggered": json.loads(report.read_text(encoding="utf-8"))["gates_triggered"]}


@contextlib.contextmanager
def framework_log(log: LogLines):
    """``log`` as the only handler of the framework logger (``setup_logging``
    then adds none of its own)."""
    logger = logging.getLogger(LOGGER_NAME)
    saved = logger.handlers[:], logger.propagate
    logger.handlers, logger.propagate = [log], False
    try:
        yield logger
    finally:
        logger.handlers, logger.propagate = saved


def pipeline_cli_base(workdir: Path, rng: np.random.Generator, smi: str) -> tuple[dict, dict[str, int]]:
    """(a): ``cli.main(["--url", clip, "--config", config.json])`` at full
    base width and depth; the line and the launches."""
    config = analyzer_config(workdir, checkpoint_dir=None, grammar_scale=ANALYZER_BASE_SCALE,
                             structure_bias=ANALYZER_BASE_BIAS, max_new_tokens=ANALYZER_BASE_MAX_NEW)
    config["validator"].update(use_engine=True, max_rounds=PIPELINE_ROUNDS)
    config["auditor"].update(use_engine=True, threshold=PIPELINE_AUDIT_THRESHOLD)
    workdir.mkdir(parents=True)
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(config, ensure_ascii=False, indent=1), encoding="utf-8")
    clip = workdir / "lecture.npzv"
    write_npzv(clip, rng.integers(0, 256, (ANALYZER_CLIP_FRAMES, ANALYZER_FRAME_SIZE, ANALYZER_FRAME_SIZE, 3),
                                  dtype=np.uint8), ANALYZER_CLIP_FPS)
    log, record = LogLines(), {}
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with framework_log(log), pipeline_probes(record):
        code = port_cli.main(["--url", str(clip), "--config", str(config_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts()
    (result,) = record["results"]
    if code != 0 or not result.success:
        raise AssertionError(f"pipeline (a): exit {code}, {result}")
    calls = record["calls"]
    kinds = [c["call"] for c in calls]
    if kinds.count("note") != 1 or "validator" not in kinds or "audit" not in kinds:
        raise AssertionError(f"pipeline (a): engine calls {kinds}")
    flags = [v["passed"] for v in record["verdicts"]]
    rewrites = sum(1 for i, ok in enumerate(flags) if not ok and i < PIPELINE_ROUNDS - 1)
    if kinds.count("rewrite") != rewrites or kinds.count("validator") != len(flags):
        raise AssertionError(f"pipeline (a): verdicts {flags}, engine calls {kinds}")
    if not any(m.startswith(f"event=note_lint video_id={result.video_id} ") for m in log.messages):
        raise AssertionError("pipeline (a): the saved note was not linted")
    outputs = pipeline_outputs(config, result.video_id, "(a)")
    engine_layers = get_preset("base").decoder.num_layers
    pipeline_launch_check(launched, calls, engine_layers, "(a)")
    line = {"phase": "pipeline", "run": "base_cli_url", "wall_seconds": wall, "exit_code": code,
            "step_seconds": record["steps"], "engine_calls": calls, "validation_rounds": record["verdicts"],
            "rewrites": rewrites, "validation_score": result.validation_score, "audit_score": result.audit_score,
            "api_calls_used": result.api_calls_used, "processing_seconds": result.processing_time, **outputs,
            "lint": [m for m in log.messages if m.startswith("event=note_lint")],
            "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows",
                                                           "decode_attention")},
            "settings": {"preset": "base", "decoder_layers": engine_layers, "weights": "random, seeded",
                         "quantize": config["engine"]["quantize"], "kv_cache": config["engine"]["kv_quant"],
                         "temperature": config["engine"]["temperature"], "grammar_scale": ANALYZER_BASE_SCALE,
                         "structure_bias": ANALYZER_BASE_BIAS, "max_new_tokens": ANALYZER_BASE_MAX_NEW,
                         "validator_use_engine": True, "auditor_use_engine": True, "max_rounds": PIPELINE_ROUNDS,
                         "auditor_threshold": PIPELINE_AUDIT_THRESHOLD},
            "card": smi}
    return line, launched


def pipeline_cli_tiny(workdir: Path, rng: np.random.Generator, smi: str) -> dict:
    """(b): the trained tiny checkpoint through ``python -m
    video_transformer_tpu_torch --batch LIST --sharded`` in a fresh process,
    twice; the second run must skip both clips."""
    config = analyzer_config(workdir, model_preset="tiny", checkpoint_dir=str(TINY_WEIGHTS), temperature=0.0,
                             max_new_tokens=GROUNDING_MAX_NEW)
    workdir.mkdir(parents=True)
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(config, ensure_ascii=False, indent=1), encoding="utf-8")
    size = get_preset("tiny").encoder.image_size
    clips = []
    for topic in PIPELINE_TOPICS:
        clip = workdir / f"topic{topic}.npzv"
        write_npzv(clip, render_topic_clip(topic, ANALYZER_CLIP_FRAMES, size, rng), ANALYZER_CLIP_FPS)
        clips.append(clip)
    listing = workdir / "urls.txt"
    listing.write_text("# grounded topics\n" + "\n".join(map(str, clips)) + "\n", encoding="utf-8")
    argv = [sys.executable, "-m", "video_transformer_tpu_torch", "--batch", str(listing), "--sharded",
            "--config", str(config_path)]
    runs = []
    for attempt in ("first", "again"):
        start = time.perf_counter()
        done = subprocess.run(argv, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                              text=True, timeout=PIPELINE_CLI_TIMEOUT)
        seconds = time.perf_counter() - start
        if done.returncode != 0:
            raise AssertionError(f"pipeline (b) {attempt}: exit {done.returncode}\n{done.stdout[-2000:]}\n"
                                 f"{done.stderr[-4000:]}")
        runs.append({"run": attempt, "seconds": seconds, "exit_code": done.returncode,
                     "stdout": [line for line in done.stdout.splitlines() if line.strip("= ")]})
    outputs = {clip.stem: pipeline_outputs(config, clip.stem, f"(b) {clip.stem}") for clip in clips}
    notes = sorted(p.name for p in (Path(config["system"]["output_dir"]) / "documents").glob("*.md"))
    if len(notes) != 2 or "2/2" not in " ".join(runs[0]["stdout"]):
        raise AssertionError(f"pipeline (b): notes {notes}, stdout {runs[0]['stdout']}")
    log_text = (Path(config["system"]["log_dir"]) / "run.log").read_text(encoding="utf-8")
    if "所有视频均已处理" not in log_text or runs[1]["stdout"]:
        raise AssertionError(f"pipeline (b): the second run did not skip both clips: {runs[1]}")
    return {"phase": "pipeline", "run": "tiny_cli_batch_sharded", "checkpoint": str(TINY_WEIGHTS.relative_to(REPO)),
            "runs": runs, "outputs": outputs, "card": smi}


def pipeline_watch(workdir: Path, rng: np.random.Generator, smi: str) -> tuple[dict, dict[str, int]]:
    """(b), last: one ``WatchService`` scan (``--once``) over one clip, in
    this process, on the trained tiny checkpoint; launches as in (a)."""
    config = analyzer_config(workdir, model_preset="tiny", checkpoint_dir=str(TINY_WEIGHTS), temperature=0.0,
                             max_new_tokens=GROUNDING_MAX_NEW)
    inbox = workdir / "inbox"
    inbox.mkdir(parents=True)
    clip = inbox / "watched.npzv"
    write_npzv(clip, render_topic_clip(PIPELINE_TOPICS[0], ANALYZER_CLIP_FRAMES, get_preset("tiny").encoder.image_size,
                                       rng), ANALYZER_CLIP_FPS)
    log, record = LogLines(), {}
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with framework_log(log) as logger, pipeline_probes(record):
        processed = WatchService(config, logger, inbox, poll_interval=0.0).run(once=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts()
    if processed != 1 or not any(m.startswith("event=service_pickup video=watched.npzv") for m in log.messages):
        raise AssertionError(f"pipeline watch: processed {processed}: {log.messages[-5:]}")
    pipeline_launch_check(launched, record["calls"], get_preset("tiny").decoder.num_layers, "watch")
    outputs = pipeline_outputs(config, "watched", "watch", "service_progress.json")
    return {"phase": "pipeline", "run": "tiny_watch_once", "wall_seconds": wall, "processed": processed,
            "step_seconds": record["steps"], "engine_calls": record["calls"], **outputs,
            "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows",
                                                           "decode_attention")}, "card": smi}, launched


def pipeline_phase(seed: int, smi: str) -> tuple[list[dict], dict[str, int]]:
    """Main path 8 (see the constants above): (a), (b) and the watch scan.
    Returns the lines and the launches of (a) and the scan."""
    rng = np.random.default_rng(seed)
    lines = []
    with tempfile.TemporaryDirectory(prefix="vtx_pipeline_") as tmp:
        workdir = Path(tmp)
        line, launched = pipeline_cli_base(workdir / "base", rng, smi)
        lines.append(line)
        gc.collect()
        torch.cuda.empty_cache()
        lines.append(pipeline_cli_tiny(workdir / "cli", rng, smi))
        line, watched = pipeline_watch(workdir / "watch", rng, smi)
        lines.append(line)
    gc.collect()
    torch.cuda.empty_cache()
    return lines, {name: launched[name] + watched[name] for name in launched}


# Main path 9, training on grounded and staged data: the training CLI's
# ``--grounded`` (a pool of 16 host-rendered samples, every branch of the
# sampler: composite with near-hue and uniform partners, band-only, stated
# frame attributes, plain) and ``--data`` (4 grounded pairs staged on disk by
# ``stage_grounded_corpus``) at the full base width and depth, BPE notes
# tokenized by the note grammar's ``encode_aligned``. A pool of 8 (the first
# plan) draws no attribute sample at seed 0.
TRAIN_DATA_ARGS = ["--preset", "base", "--tokenizer", str(TOKENIZER), "--batch", "2", "--text-len", "2048"]
GROUNDED_ARGS = [
    "--grounded", "--grounded-composite", "0.5", "--grounded-band", "0.2", "--grounded-attrs", "0.5",
    "--grounded-hard-pairs", "0.5", "--grounded-cache", "16",
]
GROUNDED_STEPS, STAGED_STEPS, STAGED_PAIRS = 3, 2, 4


@contextlib.contextmanager
def sample_branches(record: dict):
    """Count the grounded sampler's branches in ``record`` while the pool
    renders: composite clips (and the near-hue partner searches among
    them), band-only clips, single-topic clips with stated attributes, and
    plain ones."""
    record.update(composite=0, near_hue_partner=0, band=0, attrs=0, topic=0)
    renders = {name: getattr(grounded_module, name)
               for name in ("render_composite_clip", "render_band_clip", "render_topic_clip")}
    argsort = np.argsort
    depth = [0]

    def counted(name, key):
        def call(*args, **kwargs):
            if depth[0] == 0:  # the composite and band renderers draw topic clips themselves
                record["attrs" if kwargs.get("orient") is not None else key] += 1
            depth[0] += 1
            try:
                return renders[name](*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    def near_hue(*args, **kwargs):
        record["near_hue_partner"] += 1
        return argsort(*args, **kwargs)

    with contextlib.ExitStack() as stack:
        for name, key in (("render_composite_clip", "composite"), ("render_band_clip", "band"),
                          ("render_topic_clip", "topic")):
            stack.enter_context(mock.patch.object(grounded_module, name, counted(name, key)))
        stack.enter_context(mock.patch.object(np, "argsort", near_hue))
        yield


def train_data_steps(trainer, batches, steps: int, label: str) -> tuple[list[dict], list[float], list]:
    """``steps`` steps of the CLI's loop on ``batches``: each batch's patches
    preprocessed on the card in float32, each step with a finite loss and
    gradient norm and exactly ``TRAIN_STEP_LAUNCHES``. Returns the step
    lines, the step ms and each batch's (tokens, prompt blocks)."""
    lines, step_ms, rows = [], [], []
    for step in range(1, steps + 1):
        start = time.perf_counter()
        patches, tokens, prompt_lens = next(batches)
        batch_s = time.perf_counter() - start
        if patches.device != trainer.device or patches.dtype != torch.float32:
            raise AssertionError(f"{label}: patches {patches.dtype} on {patches.device}, want float32 on the card")
        rows.append((tokens, prompt_lens))
        before = counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainer.step(patches, tokens, prompt_lens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        launched = {key: n - before[key] for key, n in counts().items()}
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])):
            raise AssertionError(f"{label} step {step}: non-finite loss or gradient {metrics}")
        if any(launched[key] != n for key, n in TRAIN_STEP_LAUNCHES.items()):
            raise AssertionError(f"{label} step {step}: launches {launched}, expected {TRAIN_STEP_LAUNCHES}")
        step_ms.append(ms)
        lines.append({"phase": f"{label}_step", "step": step, "loss": metrics["loss"],
                      "grad_norm": metrics["grad_norm"], "loss_tokens": metrics["tokens"], "step_ms": ms,
                      "batch_seconds": batch_s, "launches": {k: launched[k] for k in TRAIN_STEP_LAUNCHES}})
    return lines, step_ms, rows


def timed_grammar(record: list):
    """Append the seconds of each grammar bitset (built or loaded) to ``record``."""
    compute = TokenGrammar._compute_allowed_bits

    def timed(self, cache_dir):
        start = time.perf_counter()
        try:
            return compute(self, cache_dir)
        finally:
            record.append(time.perf_counter() - start)

    return mock.patch.object(TokenGrammar, "_compute_allowed_bits", timed)


def train_grounded_phase(dev: torch.device, workdir: Path, smi: str) -> tuple[list[dict], dict[str, int]]:
    """``train.run --grounded`` at base for ``GROUNDED_STEPS`` steps (see
    ``GROUNDED_ARGS``): set-up (trainer, grammar from its cache), the pool's
    render (the first batch), every sampler branch drawn, each step through
    K7a-c only. Returns the lines and the launches."""
    args = build_parser().parse_args(TRAIN_DATA_ARGS + GROUNDED_ARGS + [
        "--steps", str(GROUNDED_STEPS), "--device", str(dev), "--out", str(workdir / "ckpt"),
        "--log-dir", str(workdir)])
    grammar_s: list[float] = []
    start = time.perf_counter()
    with timed_grammar(grammar_s):
        config, trainer, batches = prepare(args, setup_logging(args.log_dir))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    branches: dict = {}
    start = time.perf_counter()
    with sample_branches(branches):
        first = next(batches)
    first_s = time.perf_counter() - start
    if not all(branches.values()) or branches["near_hue_partner"] == branches["composite"]:
        raise AssertionError(f"train_grounded: a sampler branch was not drawn: {branches}")
    reset_counts()
    lines, step_ms, _ = train_data_steps(trainer, itertools.chain([first], batches), GROUNDED_STEPS,
                                         "train_grounded")
    launched = counts()
    lines.append({"phase": "train_grounded", "preset": config.name, "steps": GROUNDED_STEPS, "batch": args.batch,
                  "seq": config.video_tokens + args.text_len, "setup_seconds": setup_s,
                  "grammar_seconds": grammar_s, "pool": args.grounded_cache,
                  "first_batch_seconds_with_pool_render": first_s, "branches": branches,
                  "step_ms": step_ms, "steady_step_ms": statistics.median(step_ms[1:]), "launches": launched,
                  "card": smi})
    del trainer, batches, first
    gc.collect()
    torch.cuda.empty_cache()
    return lines, launched


def train_staged_phase(dev: torch.device, workdir: Path, tokenizer, smi: str) -> tuple[list[dict], dict[str, int]]:
    """``stage_grounded_corpus`` writes ``STAGED_PAIRS`` pairs at base's
    frame size, ``distillation_records`` finds them, and ``train.run --data``
    trains ``STAGED_STEPS`` base steps on them. Every row's note body is the
    note's ``encode_aligned`` ids (as far as the row holds them), ends in EOS
    and walks the note grammar, to its end where the row holds the whole
    note. Returns the lines and the launches."""
    stage = workdir / "staged"
    start = time.perf_counter()
    paths = stage_grounded_corpus(stage, STAGED_PAIRS, get_preset(TRAIN_DATA_ARGS[1]).encoder)
    stage_s = time.perf_counter() - start
    records = list(distillation_records(stage))
    if [p for p, _ in records] != paths:
        raise AssertionError(f"train_staged: distillation_records found {[p.name for p, _ in records]}")
    args = build_parser().parse_args(TRAIN_DATA_ARGS + [
        "--data", str(stage), "--steps", str(STAGED_STEPS), "--device", str(dev), "--out", str(workdir / "ckpt"),
        "--log-dir", str(workdir)])
    start = time.perf_counter()
    config, trainer, batches = prepare(args, setup_logging(args.log_dir))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    reset_counts()
    lines, step_ms, rows = train_data_steps(trainer, batches, STAGED_STEPS, "train_staged")
    launched = counts()
    grammar = TokenGrammar(note_dfa(512), tokenizer)
    bodies = []
    for k, (tokens, blocks) in enumerate(rows):
        for r, (row, block) in enumerate(zip(tokens, blocks)):
            text = json.dumps(records[(k * args.batch + r) % len(records)][1], ensure_ascii=False)
            want = grammar.encode_aligned(text)
            kept = want[: args.text_len - int(block) - 1]  # the CLI's truncation (_pack_row)
            body = row[int(block):].tolist()
            if body[: len(kept) + 1] != kept + [tokenizer.EOS] or want == tokenizer.encode(text):
                raise AssertionError(f"train_staged batch {k} row {r}: the body is not the note's encode_aligned ids")
            if kept == want:
                check_complete(grammar, r, want)
            else:
                grammar_walk(grammar, kept)
            bodies.append([len(kept), len(want)])
    lines.append({"phase": "train_staged", "preset": config.name, "pairs": len(records), "stage_seconds": stage_s,
                  "setup_seconds": setup_s, "steps": STAGED_STEPS, "step_ms": step_ms,
                  "aligned_body_tokens_kept_of": bodies, "launches": launched, "card": smi})
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return lines, launched


def bf16_eval_launch_check(launched: dict, calls: list[dict], layers: int, label: str) -> None:
    """An eval engine's launches (bf16 KV cache): K1 in every call's
    prefill, K2 once a layer a prefill, K5 once a layer a decode step, no
    K3 and nothing plain on the card."""
    steps = sum(c["decode_steps"] for c in calls)
    want = {"write_cache_rows": layers * len(calls), "decode_attention_update": layers * steps,
            "decode_attention": 0, "adopt_rows": 0, "quantize_kv_on_card": 0, "update_cache_rows_on_card": 0}
    got = {key: launched[key] for key in want}
    if got != want or not calls or not all(c["k1_launches"] for c in calls):
        raise AssertionError(f"{label}: launches {launched} for {len(calls)} engine calls and {steps} decode "
                             f"steps, expected {want} and K1 in every call: {calls}")


EVAL_CONTENT_ARGS = ["--preset", "tiny", "--checkpoint", str(TINY_WEIGHTS), "--tokenizer", str(TOKENIZER),
                     "--topics", "4", "--batch", "4", "--temperature", "0"]
EVAL_REAL_CLIPS, EVAL_REAL_SEED = 3, 36  # seed 36 draws topics of the range the checkpoint was trained on


def eval_content_phase(dev: torch.device, smi: str) -> tuple[dict, dict[str, int]]:
    """``python -m video_transformer_tpu_torch.train.eval_content`` 's main
    on the trained tiny checkpoint (``EVAL_CONTENT_ARGS``: 4 topics, batch
    4, greedy, the model judge on): one JSON line, every parsed note's
    checks booleans, K1 in every prefill (the notes' and each judgment's),
    K2 + K5 on the bf16 cache. Returns the line and the launches."""
    calls: list = []
    out = io.StringIO()
    reset_counts()
    start = time.perf_counter()
    with engine_calls(calls), contextlib.redirect_stdout(out):
        rc = eval_content.main(EVAL_CONTENT_ARGS + ["--device", str(dev)])
    seconds = time.perf_counter() - start
    launched = counts()
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    parsed = [row for row in report["per_topic"].values() if row["parse"]]
    if len(report["per_topic"]) != 4 or not parsed:
        raise AssertionError(f"eval_content: {report['per_topic']}")
    for row in parsed:
        if not all(isinstance(v, bool) for v in row["checks"].values()) or "error" in row["rubric"]:
            raise AssertionError(f"eval_content: a parsed note's checks or rubric: {row}")
    judged = [c for c in calls if not c["video"]]  # a note with no visual schema is not judged
    if not 1 <= len(judged) <= len(parsed) or len(calls) - len(judged) != 1:
        raise AssertionError(f"eval_content: {len(calls)} engine calls for {len(parsed)} parsed notes")
    bf16_eval_launch_check(launched, calls, get_preset("tiny").decoder.num_layers, "eval_content")
    steps = sum(c["decode_steps"] for c in calls)
    line = {"phase": "eval_content", "exit_code": rc, "content_coverage": report["content_coverage"],
            "rubric_mean": report["rubric_mean"], "rubric_pass_rate": report["rubric_pass_rate"],
            "parse_rate": report["parse_rate"], "contamination_mean": report["contamination_mean"],
            "per_check": report["per_check"],
            "per_topic": {name: [row.get("coverage"), row.get("rubric", {}).get("total")]
                          for name, row in report["per_topic"].items()},
            "seconds": seconds, "wall_seconds": report["wall_seconds"], "engine_calls": calls,
            "ms_per_step": sum(c["seconds"] for c in calls) / steps * 1e3, "launches": launched, "card": smi}
    return line, launched


def eval_real_phase(dev: torch.device, workdir: Path, tokenizer, smi: str) -> tuple[dict, dict[str, int]]:
    """``stage_out_of_bank`` writes ``EVAL_REAL_CLIPS`` held-out clips with
    their truths, and ``run_real_eval`` scores the trained tiny checkpoint
    on them greedily (the eval's 1,024 new tokens, bf16): every note parses,
    K1 in the prefill, K2 + K5 on the bf16 cache. Returns the line and the
    launches."""
    cfg = base_config(tokenizer.vocab_size, "tiny")
    paths = stage_out_of_bank(workdir, EVAL_REAL_CLIPS, cfg.encoder.num_frames, cfg.encoder.image_size,
                              seed=EVAL_REAL_SEED)
    engine = grounding_engine(cfg, tokenizer, dev, temperature=0.0, max_new_tokens=1024)
    calls: list = []
    reset_counts()
    with engine_calls(calls):
        report = run_real_eval(engine, workdir, batch=4)
    launched = counts()
    if report["clips"] != len(paths) or report["parse_rate"] != 1.0:
        raise AssertionError(f"eval_real: {report}")
    bf16_eval_launch_check(launched, calls, cfg.decoder.num_layers, "eval_real")
    steps = sum(c["decode_steps"] for c in calls)
    line = {"phase": "eval_real", "clips": report["clips"], "parse_rate": report["parse_rate"],
            "headline_hits": report["headline_hits"], "must_coverage": report["must_coverage"],
            "should_coverage": report["should_coverage"], "violation_clips": report["violation_clips"],
            "per_clip": {stem: [s["headline_hit"], s["must_coverage"]] for stem, s in report["per_clip"].items()},
            "wall_seconds": report["wall_seconds"], "decode_steps": steps,
            "ms_per_step": sum(c["seconds"] for c in calls) / steps * 1e3, "launches": launched, "card": smi}
    return line, launched


TRACED_SPANS = ("engine.preprocess", "engine.generate", "engine.generate_text", "engine.continue_session")


def tracing_phase(dev: torch.device, tokenizer, workdir: Path, smi: str) -> dict:
    """The tracer's summary over every engine call of the smoke so far
    (each of ``TRACED_SPANS`` must be there: the engine API phase resumes a
    session), then one ``device_trace`` around a 16-token greedy decode of
    the trained tiny checkpoint: the exported trace must name the spans
    (``engine.preprocess``, ``engine.generate``) beside device kernels."""
    summary = tracer.summary()
    missing = [name for name in TRACED_SPANS if name not in summary]
    if missing:
        raise AssertionError(f"tracing: no {missing} span in {sorted(summary)}")
    cfg = base_config(tokenizer.vocab_size, "tiny")
    engine = grounding_engine(cfg, tokenizer, dev, temperature=0.0, max_new_tokens=PROFILE_TOKENS)
    clip = render_topic_clip(0, cfg.encoder.num_frames, cfg.encoder.image_size, np.random.default_rng(1))[None]
    engine.generate(clip, [PROMPT])  # warm
    nvtx_ranges: list = []
    push = torch.cuda.nvtx.range_push

    def pushed(name):
        nvtx_ranges.append(name)
        return push(name)

    start = time.perf_counter()
    with mock.patch.object(torch.cuda.nvtx, "range_push", pushed), device_trace(workdir) as prof:
        engine.generate(clip, [PROMPT])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    trace_path = workdir / "trace.json"
    events = json.loads(trace_path.read_text(encoding="utf-8"))["traceEvents"]
    named = {}
    for event in events:
        if event.get("name") in TRACED_SPANS:
            named.setdefault(event["name"], set()).add(event.get("cat", ""))
    kernels = sum(1 for event in events if event.get("cat") == "kernel")
    if not {"engine.preprocess", "engine.generate"} <= set(named) or not kernels:
        raise AssertionError(f"tracing: the trace names {sorted(named)} and holds {kernels} device kernels")
    if nvtx_ranges != ["engine.generate", "engine.preprocess"]:
        raise AssertionError(f"tracing: NVTX ranges pushed {nvtx_ranges}")
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return {"phase": "tracing", "summary": summary, "trace_bytes": trace_path.stat().st_size,
            "trace_events": len(events), "trace_device_kernels": kernels,
            "span_categories": {name: sorted(cats) for name, cats in named.items()},
            "nvtx_ranges_pushed": nvtx_ranges, "traced_seconds": seconds, "traced_device_ms": device_ms,
            "card": smi}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    with watch_plain_writes():
        run(args.seed)


def run(seed: int) -> None:
    """The smoke's phases in order (``main``)."""
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "find_spec": {name: importlib.util.find_spec(name) is not None for name in ("PIL", "requests", "yt_dlp")},
          "dejavu_sans": Path("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf").exists()})

    t0 = time.perf_counter()
    _lib.library()
    emit({"phase": "build", "nvcc_seconds": _lib.build_seconds, "load_seconds": time.perf_counter() - t0,
          "k6_ptxas": k6_ptxas(_lib.build_log), "k3_k5_ptxas": decode_ptxas(_lib.build_log),
          "k2_ptxas": k2_ptxas(_lib.build_log)})
    ptxas = [line for line in _lib.build_log.splitlines()
             if any(word in line for word in ("Function properties", "registers", "spill", "setmaxnreg", "wgmma"))]
    emit({"phase": "ptxas", "lines": ptxas})
    emit({"phase": "sass", "kernels": kernel_sass()})

    t0 = time.perf_counter()
    tokenizer = BpeTokenizer.load(TOKENIZER)
    cfg = base_config(tokenizer.vocab_size)
    serve_cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=SERVING_LAYERS))
    layers = serve_cfg.decoder.num_layers
    serving = dict(max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
                   param_dtype="bfloat16", quantize="int8", kv_quant="int8", max_forced_run=2, device=dev)
    engine = InferenceEngine(serve_cfg, **serving)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # The note grammar's bitset: built and written to the checkout's cache
    # (build/grammar_cache/) on a fresh checkout, then loaded from it.
    cache_dir = REPO / "build" / "grammar_cache"
    cached_before = set(cache_dir.glob("bits_*.npz"))
    bits_seconds: list[float] = []
    with timed_grammar(bits_seconds):
        engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
        t2 = time.perf_counter()
        loaded = TokenGrammar(note_dfa(engine.byte_vocab), tokenizer)
    if not np.array_equal(loaded.allowed_bits, engine.dfa.allowed_bits):
        raise AssertionError("setup: the grammar's cached bitset differs from the one built")
    emit({"phase": "setup", "engine_seconds": t1 - t0, "grammar_seconds": t2 - t1,
          "grammar_cached_seconds": time.perf_counter() - t2,
          "grammar_bits_seconds": {"first": bits_seconds[0], "from_cache": bits_seconds[1],
                                   "first_was": "built" if set(cache_dir.glob("bits_*.npz")) - cached_before
                                   else "loaded (cache already there)"},
          "preset": cfg.name, "decoder_layers": layers, "weights": "random, seeded", "quantize": "int8",
          "kv_quant": "int8"})
    prompt_bucket = engine._prompt_bucket([PROMPT], with_video=True)
    width = 1 + engine.max_forced_run
    # The engine's cache sizing: live positions plus tail slack.
    cache_len = 128 * math.ceil((cfg.video_tokens + prompt_bucket + MAX_NEW_TOKENS + 2 * width + 17) / 128)
    # The batcher's (default prompt_len 256): park region and pool rows.
    park_len = cfg.video_tokens + 256
    pool_len = 128 * math.ceil((park_len + MAX_NEW_TOKENS + 2 * width + 17) / 128)
    t0 = time.perf_counter()
    kernels = kernel_phase(seed, dev, cfg, prompt_bucket, cache_len, park_len)
    kernels.update(batcher_kernel_phase(seed, dev, cfg, park_len, pool_len, BATCHER_SLOTS, 3 * BATCHER_SLOTS))
    emit({"phase": "decode_rows", "checks": kernels.pop("decode_attention_rows")})
    bf16_k3 = kernels.pop("decode_attention_bf16")  # K3 on the batcher's bf16 pool, beside SDPA
    kernels["decode_attention"].update({f"bf16_{key}": value for key, value in bf16_k3.items()})
    kernels.update(train_kernel_phase(seed, dev, cfg))
    kernels["int4_matmul"] = int4_kernel_phase(seed, dev)
    emit({"phase": "kernels_checked", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit(dict(reference_phase(seed, dev, tokenizer.vocab_size), seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(reference_phase(seed, dev, tokenizer.vocab_size, int4=True), seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(train_reference_phase(seed, dev, tokenizer.vocab_size), seconds=time.perf_counter() - t0))

    # Main path 1, serving: three requests through K1-K3.
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (3, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)
    reset_counts()
    requests = serve(engine, clips[:2]) + serve(engine, clips[2:])
    served = counts()
    for line in requests:
        emit(dict(line, max_new_tokens_cap=MAX_NEW_TOKENS))
    if not all(served[kernel.__name__] for kernel in KERNELS):
        raise AssertionError(f"a kernel was not launched by the requests: {served}")
    check_write_routes(served, layers, 2, requests[0]["decode_steps"] + requests[2]["decode_steps"], "serving")
    emit(profile_phase(engine, clips[:2]))
    emit({"phase": "decode_step_launches", "preset": cfg.name, **decode_step_launches(engine, seed, cache_len)})

    # Main path 2, the continuous batcher: 12 requests through 8 slots on the
    # same int8 weights with a bf16 KV pool (K1, K2 and K4 in the stage, K5
    # at every decode step; no K3).
    batch_engine = InferenceEngine(serve_cfg, params=engine.model, tokenizer=tokenizer,
                                   max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, max_forced_run=2, device=dev)
    batch_engine.dfa = engine.dfa
    batch_clips = rng.integers(0, 256, (BATCHER_REQUESTS, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)
    batch_prompts = [f"{PROMPT}（片段 {i + 1}）" + ("请逐条展开每个要点，并给出例子。" * 5 if i % 4 == 3 else "")
                     for i in range(BATCHER_REQUESTS)]
    batched = batcher_phase(batch_engine, batch_clips, batch_prompts, BATCHER_SLOTS)
    line, batch_launched = batched["line"], batched["line"]["launches"]
    emit(line)
    if line["stages"] != [BATCHER_STAGE]:  # the shape K4 and K1 were held at above
        raise AssertionError(f"batcher stages {line['stages']}, the kernel checks assumed [{BATCHER_STAGE}]")
    if batch_launched["adopt_rows"] != layers or not batch_launched["flash_attention"] \
            or batch_launched["decode_attention_update"] != layers * line["decode_steps"] \
            or batch_launched["write_cache_rows"] != layers * len(line["stages"]) \
            or batch_launched["decode_attention"] or batch_launched["update_cache_rows_on_card"]:
        raise AssertionError(f"batcher launches {batch_launched} for {line['decode_steps']} decode steps")
    emit(batched["check"])
    emit(batcher_profile(batch_engine, batch_clips, batch_prompts, BATCHER_SLOTS))

    # Main path 5, the engine API on path 1's int8 engine: generate_text, id
    # prefixes, a session and a batch bucket through K1-K3; then K2 + K3 at
    # each decode shape the path ran, against the plain versions.
    found: dict = {}
    with path_decode_inputs(found):
        api_lines, api_launched = engine_api_phase(engine, clips)
    for line in api_lines:
        emit(line)
    line = path_decode_readings(seed, found, "engine_api")
    emit(line)
    note_path_decode(kernels, line)
    grammar = engine.dfa
    del engine, batch_engine, found
    torch.cuda.empty_cache()

    # Main path 3, training: five base-width steps through K7a-c.
    with tempfile.TemporaryDirectory(prefix="vtx_train_") as workdir:
        train_lines, trained = train_phase(dev, Path(workdir))
    for line in train_lines:
        emit(line)

    # Main path 9, training on grounded and staged data through K7a-c.
    with tempfile.TemporaryDirectory(prefix="vtx_train_data_") as workdir:
        t0 = time.perf_counter()
        data_lines, trained_grounded = train_grounded_phase(dev, Path(workdir) / "grounded", smi)
        lines, trained_staged = train_staged_phase(dev, Path(workdir) / "staged", tokenizer, smi)
        data_lines += lines
    for line in data_lines:
        emit(line)
    emit({"phase": "train_data_done", "seconds": time.perf_counter() - t0})

    # Main path 4, int4 serving at 7b width: K6 at every decode step, K1-K3.
    torch.cuda.empty_cache()
    int4_kernels, int4_served = int4_serving_phase(seed, dev, tokenizer, grammar)
    for name, result in int4_kernels.items():  # K1-K3 at the 7b shapes, beside the base ones
        for key in ("max_abs_err", "tol", "worst_ratio", "shifted_mask_ratio", "ms", "device_ms", "host_us",
                    "kernels_per_call", "unwarmed_kernels_per_call", "bit_identical_runs", "splits", "plain_ms",
                    "parent_ms", "parent_device_ms",
                    "parent_kernels_per_call", "parent_host_us", "shapes",
                    "bound_ms", "library_ms", "shape", "encoder_max_abs_err", "encoder_worst_ratio", "encoder_ms",
                    "encoder_plain_ms", "encoder_bound_ms", "encoder_library_ms", "encoder_shape",
                    "ragged_worst_ratio"):
            if key in result:
                kernels[name][f"7b_{key}"] = result[key]
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 11, qwen2vl-7b at full width and depth: the ported tower
    # (K1 at head_dim 80), the Qwen2 decoder with biases (K1, K2, K3, K6),
    # the 152k HF vocabulary under the validator grammar; before it the
    # tiny Qwen reference and the HF checkpoint round trip.
    t0 = time.perf_counter()
    qwen_k1, qwen_launched = qwen2vl_phase(seed, dev, smi)
    for key in ("max_abs_err", "tol", "worst_ratio", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "ragged_worst_ratio", "ragged_min_shifted_mask_ratio", "launches",
                "head_dim_96"):
        kernels["flash_attention"][f"qwen_vit_{key}"] = qwen_k1[key]
    emit({"phase": "qwen2vl_done", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 6, the grounding scorecard of the trained tiny checkpoint.
    t0 = time.perf_counter()
    found = {}
    with path_decode_inputs(found):
        grounding_lines, grounded = grounding_phase(dev, tokenizer, smi)
    for line in grounding_lines:
        emit(line)
    line = path_decode_readings(seed, found, "grounding")  # K5 (bf16 cache), K2 + K3 (int8)
    emit(line)
    note_path_decode(kernels, line)
    emit({"phase": "grounding_done", "seconds": time.perf_counter() - t0})

    # Main path 7, the analyzer: a clip on disk to the rendered note, (a) on
    # the trained tiny checkpoint, (b) at full base width; then K2 + K3 and
    # K5 at each decode shape it ran.
    t0 = time.perf_counter()
    found = {}
    with path_decode_inputs(found):
        analyzer_lines, analyzed = analyzer_phase(seed, smi)
    for line in analyzer_lines:
        emit(line)
    line = path_decode_readings(seed, found, "analyzer")
    emit(line)
    note_path_decode(kernels, line)
    emit({"phase": "analyzer_done", "seconds": time.perf_counter() - t0})

    # Main path 8, the system's own entry point: the CLI from a clip on disk
    # to the saved note, blueprint and audit, (a) base through cli.main, (b)
    # the trained tiny checkpoint through python -m ... --batch --sharded
    # twice and a WatchService scan; then K2 + K3 at its decode shapes.
    t0 = time.perf_counter()
    found = {}
    with path_decode_inputs(found):
        pipeline_lines, piped = pipeline_phase(seed, smi)
    for line in pipeline_lines:
        emit(line)
    line = path_decode_readings(seed, found, "pipeline")
    emit(line)
    note_path_decode(kernels, line)
    emit({"phase": "pipeline_done", "seconds": time.perf_counter() - t0})

    # Main path 10, the content and real-footage evals of the trained tiny
    # checkpoint (K1, K2, K5), then K5 at their decode shapes; then the
    # tracer's spans over the whole run and one device trace.
    t0 = time.perf_counter()
    found = {}
    with tempfile.TemporaryDirectory(prefix="vtx_evals_") as workdir, path_decode_inputs(found):
        content_line, content_launched = eval_content_phase(dev, smi)
        real_line, real_launched = eval_real_phase(dev, Path(workdir) / "oob", tokenizer, smi)
    emit(content_line)
    emit(real_line)
    line = path_decode_readings(seed, found, "evals")
    emit(line)
    note_path_decode(kernels, line)
    emit({"phase": "evals_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vtx_trace_") as workdir:
        emit(dict(tracing_phase(dev, tokenizer, Path(workdir), smi), seconds=time.perf_counter() - t0))
    # Each kernel's launches summed over the main paths' runs.
    launches = {name: served[name] + batch_launched[name] + trained[name] + int4_served[name] + api_launched[name]
                + grounded[name] + analyzed[name] + piped[name] + trained_grounded[name] + trained_staged[name]
                + content_launched[name] + real_launched[name] + qwen_launched[name] for name in served}
    if launches["mha_reference_on_card"]:
        raise AssertionError(f"plain attention ran {launches['mha_reference_on_card']} times on a CUDA tensor")

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
