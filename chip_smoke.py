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
matmul, at the 7b decoder's four product shapes, at the two fused widths of
a fused 7b engine and at 1-256 rows, bit for
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
  ``base`` width and 4 of its 24 decoder layers (``SERVING_LAYERS``; int8
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
- runs the decode loop on both of its routes (``decode_graph``): the
  engine's and the batcher's decode steps replayed as CUDA graphs (the
  route every entry point takes on one card, ``parallel/graphs.py``)
  against the plain per-step loop (``engine._plain_decode``), on base at
  full width and 4 decoder layers (the serving engine; then at 0.7 from one
  seed) and all 24 (int8, the note grammar, three requests of 64 tokens),
  on the batcher above (eager, graph, graph) and on the 7b int4 engine
  below: tokens, completion flags and steps bit for bit equal,
  each kernel's counter moving by its launches a step x the steps launched
  (a graph's steps past the loop's end, ``idle_steps``, launch too; every
  launch check of the smoke counts them), and each route's ms a step, busy
  share, capture seconds, graphs, replays, idle steps and peak GiB;
- trains three steps of ``python -m video_transformer_tpu_torch.train.run``'s
  code path at the full ``base`` width (seeded random f32 weights, bf16
  compute, BPE vocabulary, batch 2, 1,024 video + 2,048 text positions)
  on the graph route (``Trainer.step`` on one card: one CUDA graph of the
  whole step) beside the same steps on the eager route (``_eager_step``)
  from a clone of the same seeded start, every metric of every step and
  every parameter, moment and count after the last bit for bit, shows that
  every step of both ran 36 launches each of K7a, K7b and K7c and no
  reference backward, profiles one step a route (ms a step, busy share,
  capture seconds, graphs, replays, peak GiB), and saves and restores a
  checkpoint in a temporary directory, after which a replay must train the
  restored weights as the eager route does;
- serves one batch of two 16-frame clips through ``InferenceEngine.generate``
  at the full ``7b`` width and 4 of its 28 decoder layers
  (``INT4_SERVING_LAYERS``; seeded random weights, bf16, int4 weights, int8
  KV cache, the same vocabulary and grammar, greedy), after holding K1-K3
  at its shapes, shows
  that every decode step ran K6 for each of the 7 projections of each layer
  and prefill none, and K2 and K3 as
  on the base path, profiles a 16-token call, and counts a decode step's
  device kernels beside the parent route's; then serves the clips again
  with ``fuse_projections=True`` (``fusion_7b``: one q/k/v carrier of N =
  4,608 and one gate/up carrier of N = 37,888 a layer; the logits within
  2e-2 x max|logit| of the unfused engine's, K6 4 times a layer a step);
- serves ``qwen2vl-7b`` at its full width and depth (``qwen2vl``): first K1
  at the vision tower's head_dim 80 ([clips x 8, 16, 256, 80] non-causal,
  timed beside SDPA, and at the ragged shapes causal and not; head_dim 96
  must raise), the tiny Qwen geometry's logits on the card against the
  CPU's (random biases; K1 in every tower block), a training step's
  gradients through 2 tower blocks at full width into the tiny decoder
  against the CPU's f32 ones (``qwen_train``: every leaf within 4e-2 x its
  max; K1 once a block forward, one ``mha_reference`` recompute a block in
  the backward, none in the forward), and an HF checkpoint
  round trip at full width and 2 tower blocks and decoder layers (HF-named
  state written as two safetensors shards and an index by the smoke's own
  writer, ``engine.restore(dir)``: weights and prefill logits equal to an
  engine built from the same state in memory); then the 32-block tower,
  the 28-layer Qwen2 decoder with q/k/v biases and the untied 152,064-wide
  head (seeded random weights made on the card, int4 decoder weights, int8
  KV cache) serve two 16-frame 224 px clips, 64 new tokens, greedy, under
  the validator grammar over the synthetic 152k vocabulary
  (``write_synth_qwen_vocab``, ``HfTokenizer``; the encode branch printed),
  with K1 32 times in the tower and 28 in the prefill, K2 28 times a
  prefill and a step, K3 28 and K6 196 a step, and no plain attention or
  cache write on a CUDA tensor;
- decodes speculatively (``speculative``) on the serving path's int8
  weights (base width, 4 layers, 64 new tokens, the note grammar, bf16
  caches) with the trained tiny checkpoint as the draft
  (``attach_draft(tiny, checkpoint=...npz, spec_tokens=6)``): greedy on two
  clips against the plain loop one token a step (``SPEC_PLAIN_FORCED_RUN``:
  tokens equal, or parting only where the plain model's top-two gap is
  under 2e-2 x max|logit|, each such row printed), with accepted tokens a
  cycle, target forwards against the shipped plain loop's steps, ms a
  cycle and tok/s; a self-draft (``share_target_params``, 64 tokens: fewer
  than half as many target forwards as the one-token loop's steps);
  temperature 0.7 (64 tokens; every row walks the grammar); a session whose
  round and reserve come from one greedy call's longer document (so that a
  continuation is needed) resumed until it completes (equal to the call with
  the same cache length by the same rule); the continuous batcher (8 slots,
  twelve requests of 64 tokens; its first wave against the speculative
  ``generate`` at batch 8); the analyzer's (a) run with
  ``engine.draft`` in its config (``event=engine_draft_attached``; its
  engine calls against the plain (a) run's). Every run but the analyzer's
  runs on both routes of the speculative loop: the per-cycle loop
  (``engine._plain_decode``), then replayed CUDA graphs of ``SPEC_CHUNK``
  cycles (the batcher: of a refill period), whose tokens, completion flags
  and cycles must equal the per-cycle loop's bit for bit, with each
  route's ms a cycle, busy share, capture seconds, graphs, replays, idle
  cycles and peak GiB. Launches are counted from 0
  a run: K1 in every encoder and prefill layer of both models, K2 once a
  layer of both a prefill or stage, K4 once a layer of each pool a stage,
  K5 once a target layer a cycle launched (W = 6; idle cycles past a
  loop's end included) and once a draft layer a draft
  step (W = 1), no K3 and nothing plain on the card; then K5 is timed at
  the verify's and a draft step's shapes and held at every decode shape
  the phase ran (``path_decode``). Before it, ``grammar_advance`` times
  the note grammar's ``advance`` through its ``next_token`` table and
  through the byte walk in the same call (equal successors required);
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
  (int8 weights and KV cache: K1, K2, K3; 4 topics, no composites), with every
  row walking the note grammar and decode tok/s and ms a step beside the
  card's name and power limit, then holds K5 and K2 + K3 at the eval's
  decode shapes as on the engine API's;
- runs the analyzer (``analyzer``): ``ContentAnalyzer.analyze_video`` on the
  port's shipped config (``utils/config.json``), from a clip written to
  disk to the rendered note. (a) The trained tiny checkpoint, restored from
  the committed ``.npz`` (``event=engine_restored`` must be logged), at the
  shipped serving settings (BPE, compact prompts, int8 weights and KV
  cache), greedy, 1,536 new tokens, on a single-pass clip of one grounded
  topic. (b) ``base`` at its full width (12-layer ViT, 4 of its 24 decoder
  layers: ``ANALYZER_BASE_LAYERS``) with seeded random weights, int8
  weights and KV, temperature 0.7, the note grammar's fields at a quarter
  of their budgets and a 2.5 closer bias: a single-pass clip through the
  engine, then a 25-minute clip that the shipped planner cuts into 4
  segments, which ``auto`` sends through the continuous batcher (2 slots,
  batches of 2). Each call's launches are counted from 0 (K2 once a layer
  an engine prefill, int8 decode step and batcher stage; K3 once a layer an
  engine step; K4 once a layer a stage; K5 once a layer a batcher step),
  its note renders through ``generate_report`` and passes
  ``validate_markdown_structure``; then K5
  and K2 + K3 are held at every decode shape the analyzer ran;
- runs the system's own entry point (``pipeline``), from a clip on disk to
  the saved note, blueprint and audit. (a) ``cli.main(["--url", clip,
  "--config", config.json])`` in this process at ``base`` full width and
  ``ANALYZER_BASE_LAYERS`` layers (the analyzer's (b) settings) with the
  validator and the auditor scoring through the engine (2 rounds): exit 0, the note saved and linted
  (``event=note_lint``), a quality report, ``progress.json``, a 1280x720
  PNG that the port's own reader decodes, a validator call each round, a
  rewrite after each failed round but the last, an audit call; launches
  counted from 0 (K1 in every engine call's prefill, video and text-only;
  K2 once a layer a prefill and a decode step; K3 once a layer a step;
  nothing plain on the card); the seconds of each step (download, analyze,
  validate, render, audit, save) and each engine call's steps and tok/s.
  (b) the trained tiny checkpoint through ``python -m
  video_transformer_tpu_torch --batch LIST --sharded`` in a fresh process
  on two grounded clips (exit 0, two notes and two PNGs), then again
  through ``cli.main`` in this process (exit 0, both skipped through the
  progress file, nothing printed), then a ``WatchService`` scan
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
- serves over a mesh of two ranks that share this card (``mesh``; gloo,
  whose collectives on CUDA tensors go through the host): ``base`` at full
  width and ``MESH_LAYERS`` of its 24 decoder layers (int8 weights and KV
  cache, the note grammar, greedy, ``MESH_NEW_TOKENS``) on ``{"data": 1,
  "model": 2}``,
  two clips through ``InferenceEngine.generate`` against the 1-rank engine
  on the same seeded weights (tokens equal, or parting only where the
  1-rank model's top-two constrained logits lie within 2e-2 x
  max|logit|, each such row printed; the logits at the first and the last
  decode step within ``MESH_LOGIT_TOL`` x max|logit| of 1 rank's, each gap
  printed), then ``ContentAnalyzer.analyze_video``
  on the same mesh engine; ``7b`` at full width and ``MESH_INT4_LAYERS``
  layers, int4, on the same two ranks (K6 7 times a layer a step on each
  rank), held to the 1-rank engine in the same way, with K6 held at its
  five per-rank shapes; two decoders whose heads the axis does not divide
  (the plan of heads of ``parallel/sharding.py``): the trained tiny
  checkpoint, bf16 (rank 0 attends with the one q head, rank 1 holds the
  kv head and launches no decoder attention kernel; tokens against 1
  rank's), and base's width over one kv head, 4 layers, int8 (4 q heads a
  rank over the replicated kv head; logits as above); then ``{"data": 2,
  "model": 1}`` through ``ContinuousBatcher`` (4 slots, 6 requests, two
  data groups), whose tokens must equal a 1-rank batcher's over each
  group's requests. Every rank's launches are counted from 0 a run (none
  plain on a CUDA tensor); K1 is held at a rank's prefill shape (4 q heads
  over 1 kv head), K4 at a group's pool, and K2 + K3 and K5 at every
  decode shape the ranks ran. The backend, ranks, devices, collectives a
  step, ms a step and each rank's peak GiB are printed, and every rank's
  decode route is asserted: "eager" (gloo's collectives run on the host and
  cannot be captured; an NCCL mesh, one card a rank, replays graphs:
  ``tools/mesh_cards.py``). The ``native_reader``
  line: a ``.y4m`` read takes the C++ shim's route (the route counter) and
  its frames are within 2 of the numpy decode's (the two conversions'
  largest difference over every (y, u, v));
- trains over the same two ranks before their world closes (``train_mesh``):
  ``base`` at full width, ``TRAIN_MESH_LAYERS`` decoder layers and the
  12-layer encoder, batch 2 of 1,024 video and 2,048 text positions, on
  ``{"model": 2}``, ``{"data": 2}`` and a 2-stage pipe under GPipe and
  1F1B (2 microbatches), and the ``tiny`` preset on ``{"model": 2}`` (its
  one q head on rank 0, its kv head on both: k/v gradients summed over the
  two, the k/v leaves bit-equal after the step), ``TRAIN_MESH_STEPS``
  steps each through ``Trainer.step``: the first step's loss and every
  gradient leaf that it applies against the 1-rank trainer's on the same
  seeded weights and batch, K7a-c (and 1F1B's K1; the tiny encoder's K1
  and recompute) launches per rank as the design predicts, nothing plain on the card, the replicated leaves
  bit-equal on every rank after the steps, ms a step, collectives a step
  and each rank's peak GiB, the step route asserted ("eager" on gloo:
  the ``(data, model)`` and the GPipe and 1F1B runs take the body of one
  card's step eagerly);
  GPipe against 1F1B at batch 4 and 4
  microbatches (1F1B's peak below GPipe's on every rank); ``ring_attention``
  on a 2-rank ``cp`` mesh against ``mha_reference`` and ``moe_swiglu`` on a
  2-rank ``expert`` mesh against the dense evaluation, with gradients; then
  K7a-c at a mesh rank's shapes (4 q heads over 1 kv head; batch 1) and
  K1 at a 1F1B microbatch's;
- prints the tracer's summary of every engine call of the run (the spans
  ``engine.preprocess``, ``engine.generate``, ``engine.generate_text`` and
  ``engine.continue_session``) and runs one ``device_trace`` around a short
  greedy decode, whose exported trace must name the spans beside the
  device kernels, each span an NVTX range; then 8 ``device_trace``
  sessions of 20 one-kernel calls must each record 20 kernels (beside 8
  each with no warm-up step, with no pad, and bare, printed).

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
import threading
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
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
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
from video_transformer_tpu_torch.ops.token_grammar import TokenGrammar, token_transition_table
from video_transformer_tpu_torch.parallel.engine import InferenceEngine, _copy_cache
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
from video_transformer_tpu_torch.train.trainer import TrainConfig, Trainer, distillation_loss
from video_transformer_tpu_torch.utils.config import load_config
from video_transformer_tpu_torch.utils.logger import LOGGER_NAME
from video_transformer_tpu_torch.utils.counter import APICounter
from video_transformer_tpu_torch.utils import tracing as tracing_module
from video_transformer_tpu_torch.utils.tracing import WINDOW_PAD_S, device_trace, tracer
from video_transformer_tpu_torch.parallel.context_parallel import build_cp_mesh, ring_attention
from video_transformer_tpu_torch.parallel.expert_parallel import EXPERT_AXIS, build_expert_mesh, init_moe_params, moe_swiglu
from video_transformer_tpu_torch.parallel.mesh import MODEL_AXIS, build_mesh
from video_transformer_tpu_torch.parallel.pipeline_parallel import build_pipe_mesh
from video_transformer_tpu_torch.parallel.sharding import shard_tensor, spec_for_path
from video_transformer_tpu_torch.video import native_reader
from video_transformer_tpu_torch.video.containers import Y4M_ROUTES, read_frames, write_npzv, write_y4m
from video_transformer_tpu_torch.weights import from_jax_params, random_params

REPO = Path(__file__).resolve().parent
TOKENIZER = REPO / "data" / "tokenizers" / "bpe-zh-2048.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
# Capped for the smoke; the shipped config says 4096. 256 until the mesh
# phase (main path 13) needed its room in the smoke's time (PR 19).
MAX_NEW_TOKENS = 128  # the kernel checks' write positions (prefill_seq + 198) need the cache it sizes
# Tokens a request in the profiled windows (``profile_phase``,
# ``batcher_profile``): 32 until the smoke outgrew its 5-minute limit; the
# profiler's post-processing takes ~0.2 ms an event, a 32-token base window
# 65 k events (12 s) and the batcher's 117 k (25 s).
PROFILE_TOKENS = 16
# Decoder depth of the earlier serving paths (main paths 1, 2 and 4), cut to
# keep the smoke within its 5-minute limit: every width stays the preset's,
# each per-layer launch check counts these layers, and the kernel checks run
# at the full presets' shapes. 8 since PR 13, 4 since PR 19 (the mesh
# phase's room in the smoke's time; the mesh phase serves base at its full
# depth).
SERVING_LAYERS = 4  # of base's 24
# The 7b int4 path's decoder depth (main path 4) since the qwen2vl path
# (main path 11) serves the same decoder geometry at its full 28 layers:
# K6, K2 and K3 keep the 7b shapes, each layer-count check counts these.
# 8 since PR 17, 4 since PR 19 (the mesh phase's room).
INT4_SERVING_LAYERS = 4  # of 7b's 28
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
# The fused products of a 7b engine with ``fuse_projections`` (models/fuse.py):
# q/k/v as one [K/2, 3,584 + 2 x 512] carrier and gate/up as one [K/2, 2 x 18,944].
INT4_FUSED_SHAPES = {"qkv_fused": (1792, 4608), "gate_up_fused": (1792, 37888)}
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
TRAIN_STEPS = 3  # 5 until PR 19 (the mesh phase's room)
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


def in_background(fn, *args, **kwargs):
    """Start ``fn(*args, **kwargs)`` in a thread of this process. Returns a
    function that waits for it and gives back ``(value, seconds it ran)``,
    or raises what it raised."""
    out: dict = {}

    def body() -> None:
        t0 = time.perf_counter()
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as exc:  # handed to the waiter
            out["error"] = exc
        out["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=body, name=f"smoke-{fn.__name__}", daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"], out["seconds"]
    return wait


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
    The profiler drops the device records that CUPTI places before the
    window's start, and CUPTI can place a kernel up to a millisecond or more
    before its launch (``utils/tracing.WINDOW_PAD_S``; a 7b K2 window read
    16 kernels for 20 calls in each of 10 sessions), so each session first
    runs the calls in a traced warm-up window whose records are discarded,
    then waits ``WINDOW_PAD_S`` inside the counted window before the calls
    it counts. A profile that records no device
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
            for window in range(2):  # the warm-up window, then the counted one
                if window:
                    time.sleep(WINDOW_PAD_S)
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
    calls of ``fn`` in a bare session of its own (no warm-up window, no
    pad: the calls start as the window opens)."""
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


BACKGROUND: list[subprocess.Popen] = []  # stopped by ``main`` if still running


def start_sass(out: Path) -> subprocess.Popen:
    """``cuobjdump -sass`` of the built library into the file ``out``, in
    the background (it took 9 s, which the kernel checks now overlap)."""
    cuobjdump = Path(_lib._nvcc()).parent / "cuobjdump"
    with open(out, "w", encoding="utf-8") as sink:
        proc = subprocess.Popen([str(cuobjdump), "-sass", _lib.library()._name], stdout=sink,
                                stderr=subprocess.STDOUT)
    BACKGROUND.append(proc)
    return proc


def kernel_sass(proc: subprocess.Popen, out: Path) -> dict[str, dict[str, int]]:
    """Tensor-core instructions in each wgmma kernel of the built library
    (K1 is flash_fwd_kernel<false>, K7a <true>; K7b flash_bwd_dq_kernel, K7c
    flash_bwd_dkv_kernel; K6 int4_matmul_kernel<width> for each wgmma width)
    and in each instantiation of K3 and K5 (decode_kernel<cache, fused,
    warps a group>), counted in ``cuobjdump -sass`` (``start_sass``'s
    process and file): HGMMA (wgmma) and HMMA (mma.sync). Raises if
    cuobjdump failed, a kernel is missing, a wgmma kernel has no HGMMA or a
    K3/K5 instantiation no HMMA."""
    code = proc.wait(timeout=120)
    sass = out.read_text(encoding="utf-8")
    if code != 0:
        raise AssertionError(f"cuobjdump -sass exited {code}: {sass[-2000:]}")
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
    # Ends 70 positions apart down from the cache's end, wrapped into the
    # cache where the batch outruns it (8 rows of a 384-position pool).
    end = torch.tensor([(s - width - 70 * i) % (s - width + 1) for i in range(b)], dtype=torch.int32, device=dev)
    held("full_extent", q, *caches, *new, end)

    tiles = (s - width - 2) // 64 + 1  # odd rows: whole tiles below the end, at least one position in
    lengths = torch.tensor([min(64 * (2 + 5 * i), s - width) - 1 if i % 2 == 0
                            else s - width - 1 - 64 * (i % tiles) for i in range(b)], dtype=torch.int32, device=dev)
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
    """K6 at the 7b decoder's four product shapes at decode M, at the
    gate shape at the batcher's M and the dispatch's top, and at the two
    fused widths (``INT4_FUSED_SHAPES``) at decode M. The gate shape at
    decode M leads; every shape's readings are in ``shapes``."""
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    shapes = {f"{name}_m{INT4_DECODE_ROWS}": check_int4(gen, dev, INT4_DECODE_ROWS, k2, n)
              for name, (k2, n) in INT4_SHAPES.items()}
    for m in INT4_WIDE_ROWS:
        shapes[f"gate_up_m{m}"] = check_int4(gen, dev, m, *INT4_SHAPES["gate_up"])
    for name, (k2, n) in INT4_FUSED_SHAPES.items():
        shapes[f"{name}_m{INT4_DECODE_ROWS}"] = check_int4(gen, dev, INT4_DECODE_ROWS, k2, n)
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
    comparisons call the functions it imported). The flash attention's
    recompute backward (``reference_backwards``) is such a call, so on the
    card ``mha_reference`` may run exactly as often as that count, and in
    no forward."""
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


def launched_steps(stats) -> int:
    """The decode steps an engine's loops launched kernels for: the live
    ones (``decode_steps``, the JAX engine's count) and the idle ones that
    a decode graph ran past a loop's end (``idle_steps``), which launch the
    same kernels and change nothing."""
    return stats.decode_steps + stats.idle_steps


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


def optimizer_state(trainer: Trainer) -> dict[str, torch.Tensor]:
    """Every tensor a training step changes: each parameter and its two
    moments (and accumulated mean), the update and micro-step counts."""
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    opt = trainer.optimizer
    out = {}
    for label, tensors in (("param", opt.params), ("mu", opt.mu), ("nu", opt.nu), ("acc", opt.acc)):
        out.update({f"{label}:{name}": t for name, t in zip(names, tensors)})
    out.update({"count": opt.count, "mini": opt.mini})
    return out


def differing(a: dict[str, torch.Tensor], b: dict[str, torch.Tensor]) -> dict[str, float]:
    """The tensors of two ``optimizer_state``s that differ in a bit, with
    their largest difference."""
    return {k: (a[k].double() - b[k].double()).abs().max().item() for k in a if not torch.equal(a[k], b[k])}


def train_route_steps(trainer: Trainer, batches: list, label: str) -> dict:
    """``Trainer.step`` on ``batches`` on the trainer's route, each step
    with a finite loss and gradient norm and exactly
    ``TRAIN_STEP_LAUNCHES``: the metrics, ms a step, the launches, the
    route's stats and the peak device memory (allocated and reserved)
    over the memory resident before the steps."""
    stats = trainer.stats
    before_stats = (stats.graphs_captured, stats.capture_seconds, stats.replays)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    metrics, step_ms, lines = [], [], []
    start_counts = counts()
    for step, (patches, tokens, prompt_lens) in enumerate(batches, 1):
        before = counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        got = trainer.step(patches, tokens, prompt_lens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        launched = {key: n - before[key] for key, n in counts().items()}
        if not (math.isfinite(got["loss"]) and math.isfinite(got["grad_norm"])):
            raise AssertionError(f"{label} step {step}: non-finite loss or gradient {got}")
        if any(launched[key] != n for key, n in TRAIN_STEP_LAUNCHES.items()):
            raise AssertionError(f"{label} step {step}: launches {launched}, expected {TRAIN_STEP_LAUNCHES}")
        metrics.append(got)
        step_ms.append(ms)
        lines.append({"phase": "train_step", "route": stats.step_route, "step": step, "loss": got["loss"],
                      "accuracy": got["accuracy"], "grad_norm": got["grad_norm"], "loss_tokens": got["tokens"],
                      "step_ms": ms, "launches": launched})
    return {"route": stats.step_route, "metrics": metrics, "step_ms": step_ms, "lines": lines,
            "launches": {key: n - start_counts[key] for key, n in counts().items()},
            "graphs_captured": stats.graphs_captured - before_stats[0],
            "capture_s": stats.capture_seconds - before_stats[1], "replays": stats.replays - before_stats[2],
            "resident_gib": resident, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def train_profile(trainer: Trainer, batch: tuple) -> dict:
    """One step on the trainer's route timed alone, then one under
    torch.profiler (device activity only): wall ms, device busy ms and
    share, kernels, and the device ms by kind. A replayed graph's kernels
    are recorded as an eager step's are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.step(*batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(*batch)
        torch.cuda.synchronize()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    ops = sorted((op for op in ops if op[1] > 0), key=lambda op: -op[1])
    if not ops:
        raise AssertionError(f"train profile ({trainer.stats.step_route}): no device ops")
    device_ms = sum(op[1] for op in ops)
    kinds = {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0, "flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in ops:
        kind = next((k for k in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd") if k in name), None)
        kind = kind or ("matmul" if any(m in name for m in ("nvjet", "gemm", "cutlass")) else "other")
        kinds[kind] += ms
    return {"phase": "train_profile", "route": trainer.stats.step_route, "wall_ms": wall_ms,
            "device_busy_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "device_launches": sum(op[2] for op in ops), "device_ms_by_kind": kinds,
            "top_device_ops_ms": [[name[:60], ms, count] for name, ms, count in ops[:12]]}


def train_phase(dev: torch.device, workdir: Path, smi: str) -> tuple[list[dict], dict[str, int]]:
    """``TRAIN_STEPS`` steps of the training CLI's code path at base width
    on the graph route (a replayed CUDA graph of the whole step), beside the
    same steps from a clone of the same seeded start on the eager route
    (``_eager_step``): every metric of every step, and every parameter,
    moment and count after the last step, bit for bit; a difference raises,
    with a second eager run's differences from the first beside it (whether
    some op of the step is not deterministic). Then one profiled step a
    route and a checkpoint round trip, followed by a replay that must train
    the restored weights as the eager route does. Returns the lines to
    print and the graph route's launches."""
    args = build_parser().parse_args(TRAIN_ARGS + ["--out", str(workdir / "ckpt"), "--log-dir", str(workdir)])
    t0 = time.perf_counter()
    config, trainer, batches = prepare(args, setup_logging(args.log_dir))
    torch.cuda.synchronize()
    lines = [{"phase": "train_setup", "seconds": time.perf_counter() - t0, "preset": config.name,
              "seq": config.video_tokens + args.text_len, "batch": args.batch, "vocab": config.decoder.vocab_size,
              "params": sum(p.numel() for p in trainer.optimizer.params), "weights": "random f32, seeded",
              "compute_dtype": config.dtype}]
    steps = [next(batches) for _ in range(TRAIN_STEPS)]
    start = copy.deepcopy(trainer.model)  # the seeded start, for the eager route's runs

    def eager_twin() -> Trainer:
        twin = Trainer(config, trainer.train_config, device=dev, model=copy.deepcopy(start))
        twin._eager_step = True
        return twin

    # The main path first: the CLI's trainer on its own route. (The eager
    # route's steps after it find their activations' blocks cached: a
    # capture empties the allocator's cache, and a warm-up on the graphs'
    # stream cannot take blocks cached for another stream.)
    reset_counts()
    graph = train_route_steps(trainer, steps, "train")
    total = counts()
    twin = eager_twin()
    eager = train_route_steps(twin, steps, "train eager")
    if (graph["route"], eager["route"]) != ("graph", "eager") or graph["graphs_captured"] != 1 \
            or graph["replays"] != TRAIN_STEPS - 1:
        raise AssertionError(f"train routes {graph['route']} / {eager['route']}, captures "
                             f"{graph['graphs_captured']}, replays {graph['replays']}")
    diff = differing(optimizer_state(trainer), optimizer_state(twin))
    parted = [i for i, (a, b) in enumerate(zip(graph["metrics"], eager["metrics"])) if a != b]
    if diff or parted:
        # A second eager run from the same start: does the eager route part from itself?
        second = eager_twin()
        again = train_route_steps(second, steps, "train eager (second run)")
        spread = differing(optimizer_state(second), optimizer_state(twin))
        raise AssertionError(
            f"train: the graph route parts from the eager route at steps {parted}, in {len(diff)} tensors "
            f"({dict(sorted(diff.items(), key=lambda kv: -kv[1])[:6])}); a second eager run parts from the first "
            f"at steps {[i for i, (a, b) in enumerate(zip(again['metrics'], eager['metrics'])) if a != b]}, in "
            f"{len(spread)} tensors ({dict(sorted(spread.items(), key=lambda kv: -kv[1])[:6])})")
    lines += graph["lines"] + eager["lines"]
    peak = graph["peak_gib"]
    steady = statistics.median(graph["step_ms"][1:])
    routes = {}
    for timed, trained in ((graph, trainer), (eager, twin)):
        profiled = train_profile(trained, steps[0])
        lines.append(dict(profiled, card=smi))
        routes[timed["route"]] = {
            "steady_step_ms": statistics.median(timed["step_ms"][1:]), "first_step_ms": timed["step_ms"][0],
            "step_ms": timed["step_ms"], "busy_share": profiled["device_busy_share"],
            "profiled_wall_ms": profiled["wall_ms"], "device_busy_ms": profiled["device_busy_ms"],
            "capture_s": timed["capture_s"], "graphs_captured": timed["graphs_captured"],
            "replays": trained.stats.replays, "resident_gib": timed["resident_gib"],
            "peak_gib": timed["peak_gib"], "peak_reserved_gib": timed["peak_reserved_gib"]}
    lines.append({"phase": "train", "steps": TRAIN_STEPS, "route": graph["route"], "steady_step_ms": steady,
                  "first_step_ms": graph["step_ms"][0],
                  "loss_tokens_per_s": statistics.median([m["tokens"] for m in graph["metrics"][1:]]) / steady * 1e3,
                  "positions_per_s": args.batch * (config.video_tokens + args.text_len) / steady * 1e3,
                  "peak_memory_gib": peak, "launches": total, "routes": routes,
                  "bit_equal": {"metrics_steps": TRAIN_STEPS, "tensors": len(optimizer_state(trainer))},
                  "card": smi})

    # Checkpoint round trip: save, disturb a weight, restore; then one more
    # step on each route, bit for bit: the replay trains the restored
    # weights (the eager twin holds the saved ones, undisturbed).
    t0 = time.perf_counter()
    saved = trainer.save_checkpoint(args.out)
    state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    with torch.no_grad():
        trainer.model.decoder.embed.embedding.add_(1.0)
    trainer.restore_checkpoint(saved)
    mismatched = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, state[k])]
    if mismatched or trainer.step_count != TRAIN_STEPS + 2:
        raise AssertionError(f"checkpoint round trip: {mismatched[:4]}, step {trainer.step_count}")
    replays = trainer.stats.replays
    if trainer.step(*steps[1]) != twin.step(*steps[1]) or trainer.stats.replays != replays + 1 \
            or differing(optimizer_state(trainer), optimizer_state(twin)):
        raise AssertionError("checkpoint round trip: the replay after the restore parts from the eager route")
    lines.append({"phase": "train_checkpoint", "path": saved.name, "tensors": len(state),
                  "replay_after_restore_bit_equal": True, "seconds": time.perf_counter() - t0})
    del trainer, twin, start
    gc.collect()
    torch.cuda.empty_cache()
    return lines, total


# -- serving phase ---------------------------------------------------------------


def grammar_walk(grammar, ids: list[int], start: int | None = None) -> int:
    """The byte-DFA state after ``ids`` from ``start`` (the grammar's start
    by default); raises if a byte leaves the grammar."""
    table = grammar.dfa.next_state
    state = grammar.start if start is None else start
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
    before = (stats.prefill_seconds, stats.generate_seconds, stats.decode_steps, stats.tokens_generated,
              stats.idle_steps)
    torch.cuda.reset_peak_memory_stats()
    texts, status, ids = engine.generate(
        frames, [PROMPT] * len(frames), return_status=True, return_tokens=True
    )
    prefill_s = stats.prefill_seconds - before[0]
    total_s = stats.generate_seconds - before[1]
    steps = stats.decode_steps - before[2]
    tokens = stats.tokens_generated - before[3]
    idle = stats.idle_steps - before[4]
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
            "complete": done, "prefill_ms": prefill_s * 1e3, "decode_steps": steps, "idle_steps": idle,
            "decode_route": stats.decode_route, "call_tokens": tokens, "call_seconds": total_s,
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
            "decode_route": batcher.stats.decode_route, "graphs_captured": batcher.stats.graphs_captured,
            "replays": batcher.stats.replays, "launches": launched}

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


# -- the decode graphs against the plain loop (decode_graph) ----------------------

DECODE_GRAPH_LAYERS = 24  # base's full decoder depth for the decode graphs' base run
DECODE_GRAPH_DEEP_TOKENS = 64  # its budget: four chunks, a capture and replays (the eager loop ~50 ms a step)
DECODE_GRAPH_TEMPERATURE = 0.7  # the shipped engine.temperature: one seed, both routes
DECODE_GRAPH_SAMPLED_TOKENS = 48  # the sampled pair's budget (three chunks)
DECODE_GRAPH_SEED = 7
DECODE_GRAPH_PROFILED_STEPS = 2  # eager steps under the profiler for a step's kernel ms (~3,800 kernels at 24 layers)
ROUTE_STATS = ("decode_steps", "idle_steps", "generate_seconds", "prefill_seconds", "graphs_captured",
               "capture_seconds", "replays")


def step_launches(engine: InferenceEngine) -> dict[str, int]:
    """Each kernel's launches in one decode step of ``engine`` (K5 on a bf16
    cache, K2 + K3 on an int8 one; K6 in each int4 projection)."""
    layers = engine.config.decoder.num_layers
    out = ({"decode_attention_update": layers} if engine.kv_quant is None
           else {"write_cache_rows": layers, "decode_attention": layers})
    if engine.quantize == "int4":
        out["int4_matmul"] = (4 if engine.fuse_projections else 7) * layers
    return out


def route_call(engine: InferenceEngine, clips: np.ndarray, prompts: list[str], plain: bool) -> dict:
    """One ``generate`` on the plain per-step loop or on the decode graphs,
    with the launches counted from 0: each kernel's counter must move by its
    launches a step x the steps launched (live and idle), plus the
    prefill's K2."""
    engine._plain_decode = plain
    stats = engine.stats
    before = {key: getattr(stats, key) for key in ROUTE_STATS}
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        start = time.perf_counter()
        _, status, ids = engine.generate(clips, prompts, return_status=True, return_tokens=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    finally:
        engine._plain_decode = False
    launched = counts()
    moved = {key: getattr(stats, key) - before[key] for key in ROUTE_STATS}
    ran = moved["decode_steps"] + moved["idle_steps"]
    want = {name: n * ran for name, n in step_launches(engine).items()}
    want["write_cache_rows"] = want.get("write_cache_rows", 0) + engine.config.decoder.num_layers
    got = {name: launched[name] for name in want}
    route = "eager" if plain else "graph"
    if got != want or stats.decode_route != route or (plain and moved["idle_steps"]):
        raise AssertionError(f"decode_graph {route}: launches {got} for {ran} steps launched, expected {want} "
                             f"(route {stats.decode_route})")
    decode_s = moved["generate_seconds"] - moved["prefill_seconds"]
    return {"route": route, "ids": ids, "status": status, "steps": moved["decode_steps"],
            "idle_steps": moved["idle_steps"], "wall_s": wall, "ms_per_step": decode_s * 1e3 / moved["decode_steps"],
            "ms_per_launched_step": decode_s * 1e3 / ran, "graphs_captured": moved["graphs_captured"],
            "capture_s": moved["capture_seconds"], "replays": moved["replays"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def step_kernel_ms(fn, steps: int) -> float:
    """Kernel ms a decode step: the kernels' time that torch.profiler
    (device activity only) records over ``fn``, which launches ``steps``
    steps eagerly, divided by them. A graph replays the same kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.no_grad():
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / 1e3 for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / steps


def decode_graph_line(engine: InferenceEngine, clips: np.ndarray, label: str, smi: str,
                      sampled: bool = False) -> dict:
    """Main path 14 on one engine: the plain loop, then the decode graphs
    (a first call that warms up and captures, then a call of replays only).
    Greedy tokens, completion flags and live steps must be equal bit for
    bit on every call. Each route's busy share is the kernel ms of a step
    (``step_kernel_ms`` over ``DECODE_GRAPH_PROFILED_STEPS`` steps launched
    eagerly on the key's carry after the call, past the loop's end: the
    kernels a replay runs, at the call's last extent) over the route's ms a
    launched step; the graph's replay ms a step (CUDA events around its
    replays, the kernels and the gaps between them) is given beside it.
    With ``sampled`` the same engine then decodes at 0.7
    from one seed on each route (``DECODE_GRAPH_SAMPLED_TOKENS`` a row),
    whose tokens and steps must be equal too."""
    prompts = [PROMPT] * len(clips)
    eager = route_call(engine, clips, prompts, plain=True)
    first = route_call(engine, clips, prompts, plain=False)
    graph = route_call(engine, clips, prompts, plain=False)
    calls = (eager, first, graph)
    if any((c["ids"], c["status"], c["steps"]) != (eager["ids"], eager["status"], eager["steps"]) for c in calls):
        raise AssertionError(f"decode_graph {label}: the graph route's tokens differ from the plain loop's: "
                             f"{[[len(r) for r in c['ids']] for c in calls]}, steps {[c['steps'] for c in calls]}")
    if not first["graphs_captured"] or graph["graphs_captured"] or not graph["replays"]:
        raise AssertionError(f"decode_graph {label}: captures {first['graphs_captured']} then "
                             f"{graph['graphs_captured']}, replays {graph['replays']}")
    entry = engine._graphs[next(reversed(engine._graphs))]  # the key the calls replayed
    kernel_ms = step_kernel_ms(lambda: [engine._decode_step(entry.carry) for _ in range(DECODE_GRAPH_PROFILED_STEPS)],
                               DECODE_GRAPH_PROFILED_STEPS)
    replay_ms = time_ms(entry.graph.replay, warmup=1, reps=2, rounds=3) / entry.graph.n
    line = {"phase": "decode_graph", "run": label, "preset": engine.config.name,
            "decoder_layers": engine.config.decoder.num_layers, "weights": engine.quantize,
            "kv_cache": engine.kv_quant or "bfloat16", "batch": len(clips), "max_new_tokens": engine.max_new_tokens,
            "decode_steps": eager["steps"], "tokens": [len(r) for r in eager["ids"]], "complete": eager["status"],
            "tokens_equal": True, "launches_per_step": step_launches(engine), "card": smi}
    for name, timed in (("eager", eager), ("graph", graph)):
        line[name] = {key: timed[key] for key in ("ms_per_step", "ms_per_launched_step", "wall_s", "idle_steps",
                                                  "replays", "peak_gib")}
        line[name]["busy_share"] = kernel_ms / timed["ms_per_launched_step"]
    line["kernel_ms_per_step"] = kernel_ms
    line["graph"]["replay_ms_per_step"] = replay_ms
    line["graph"]["first_call"] = {key: first[key] for key in ("ms_per_step", "wall_s", "graphs_captured",
                                                                "capture_s", "replays", "idle_steps", "peak_gib")}
    # What a session round adds on the graph route: its own cache copied
    # into the key's before the loop and back after it (k/v, scales, index).
    static = entry.carry.cache
    own = {name: [t.clone() for t in static[name]] for name in ("k", "v", "k_scale", "v_scale") if name in static}
    own["index"] = static["index"].clone()
    copied = sum(t.numel() * t.element_size() for name in ("k", "v", "k_scale", "v_scale") for t in own.get(name, ()))
    line["session_copy"] = {"bytes": copied + own["index"].numel() * 4,
                            "ms": time_ms(lambda: _copy_cache(static, own), warmup=1, reps=5, rounds=5),
                            "copies_a_round": 2}
    del own
    if sampled:
        cap, temperature = engine.max_new_tokens, engine.temperature
        engine.max_new_tokens, engine.temperature = DECODE_GRAPH_SAMPLED_TOKENS, DECODE_GRAPH_TEMPERATURE
        try:
            draws = []
            for plain in (True, False, False):
                engine._generator.manual_seed(DECODE_GRAPH_SEED)
                draws.append(route_call(engine, clips, prompts, plain=plain))
        finally:
            engine.max_new_tokens, engine.temperature = cap, temperature
        if any((d["ids"], d["steps"]) != (draws[0]["ids"], draws[0]["steps"]) for d in draws):
            raise AssertionError(f"decode_graph {label}: at {DECODE_GRAPH_TEMPERATURE} the routes drew "
                                 f"{[[len(r) for r in d['ids']] for d in draws]}")
        line["sampled"] = {"temperature": DECODE_GRAPH_TEMPERATURE, "seed": DECODE_GRAPH_SEED,
                           "max_new_tokens": DECODE_GRAPH_SAMPLED_TOKENS, "tokens": [len(r) for r in draws[0]["ids"]],
                           "decode_steps": draws[0]["steps"], "graph_replays": draws[2]["replays"],
                           "tokens_equal": True}
    return line


def decode_graph_batcher_line(engine: InferenceEngine, clips: np.ndarray, prompts: list[str], slots: int,
                              smi: str) -> dict:
    """Main path 14 on the batcher: the same sweep through ``slots`` slots
    on the plain loop and on the decode graphs (the refill periods
    replayed), eager, graph (its first period eager, then a capture), graph;
    every request's tokens must be equal, and K5's counter must move by a
    launch a layer for every step."""
    layers = engine.config.decoder.num_layers
    runs = []
    for plain in (True, False, False):
        engine._plain_decode = plain
        try:
            batcher = ContinuousBatcher(engine, slots=slots)
            for i, clip in enumerate(clips):
                batcher.submit(Request(i, clip, prompts[i]))
            steps0 = engine.stats.decode_steps
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            done = {c.request_id: c.token_ids for c in batcher.run()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            engine._plain_decode = False
        steps = engine.stats.decode_steps - steps0
        launched = counts()["decode_attention_update"]
        if launched != layers * steps or batcher.stats.idle_steps:
            raise AssertionError(f"decode_graph batcher: K5 {launched} for {steps} steps")
        runs.append({"route": batcher.stats.decode_route, "tokens": done, "steps": steps, "wall_s": wall,
                     "ms_per_step": wall * 1e3 / steps, "graphs_captured": batcher.stats.graphs_captured,
                     "capture_s": batcher.stats.capture_seconds, "replays": batcher.stats.replays,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    if any((r["tokens"], r["steps"]) != (runs[0]["tokens"], runs[0]["steps"]) for r in runs) \
            or [r["route"] for r in runs] != ["eager", "graph", "graph"]:
        raise AssertionError(f"decode_graph batcher: routes {[r['route'] for r in runs]} disagree")
    keys = ("ms_per_step", "wall_s", "graphs_captured", "capture_s", "replays", "peak_gib")
    return {"phase": "decode_graph", "run": "batcher", "decoder_layers": layers, "slots": slots,
            "requests": len(clips), "decode_steps": runs[0]["steps"], "tokens_equal": True,
            "eager": [{key: r[key] for key in keys} for r in runs if r["route"] == "eager"],
            "graph": [{key: r[key] for key in keys} for r in runs if r["route"] == "graph"], "card": smi}


def int4_serving_phase(seed: int, dev: torch.device, tokenizer, grammar, smi: str) -> tuple[dict, dict]:
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
    ran = steps + requests[0]["idle_steps"]
    want = 7 * cfg.decoder.num_layers * ran
    if served["int4_matmul"] != want or prefill_k6 != [0] or not all(served[k.__name__] for k in KERNELS):
        raise AssertionError(f"7b int4 launches {served} (prefill K6 {prefill_k6}), expected K6 {want}")
    check_write_routes(served, cfg.decoder.num_layers, 1, ran, "7b int4 serving")
    for line in requests:
        decode_s = line["call_seconds"] - line["prefill_ms"] / 1e3
        emit(dict(line, preset=cfg.name, quantize="int4", ms_per_step=decode_s * 1e3 / steps,
                  k6_launches=served["int4_matmul"], k6_prefill_launches=prefill_k6[0],
                  max_new_tokens_cap=MAX_NEW_TOKENS))
    emit(dict(profile_phase(engine, clips), preset=cfg.name))
    emit({"phase": "decode_step_launches", "preset": cfg.name, **decode_step_launches(engine, seed, cache_len)})
    line, fused = fused_7b_check(engine, clips)
    emit(line)
    emit(decode_graph_line(engine, clips, "7b_int4", smi))
    return kernels, {name: served[name] + fused[name] for name in served}


def fused_7b_check(engine: InferenceEngine, clips: np.ndarray) -> tuple[dict, dict[str, int]]:
    """The 7b int4 path with ``fuse_projections=True``: a second engine on
    the same packed weights whose blocks carry one q/k/v carrier [1,792,
    4,608] and one gate/up carrier [1,792, 37,888] (``models/fuse.py``)
    serves the same clips for ``PROFILE_TOKENS`` tokens, greedy, beside
    the unfused engine. Its prefill logits, and every decode step's whose
    input blocks so far equal the unfused run's, lie within
    ``GROUNDING_LOGIT_TOL`` x max|logit| of the unfused engine's; K6 runs
    4 times a layer a decode step (qkv, out, gate/up, down; 7 unfused) and
    never in prefill.
    Returns the line and the fused call's launches."""
    cfg = engine.config
    layers = cfg.decoder.num_layers
    fused = InferenceEngine(cfg, params=engine.model, tokenizer=engine.tokenizer, max_new_tokens=PROFILE_TOKENS,
                            temperature=0.0, kv_quant="int8", max_forced_run=2, fuse_projections=True,
                            device=engine.device)
    fused.dfa = engine.dfa
    blocks = [getattr(fused.model.decoder, f"layer_{i}") for i in range(layers)]
    widths = {(tuple(b.attn.qkv.kernel.shape), tuple(b.mlp.gateup.kernel.shape), b.attn.qkv.kernel.dtype)
              for b in blocks}
    want_widths = {(INT4_FUSED_SHAPES["qkv_fused"], INT4_FUSED_SHAPES["gate_up_fused"], torch.uint8)}
    if widths != want_widths or any("q" in b.attn._modules or "gate" in b.mlp._modules for b in blocks):
        raise AssertionError(f"fused 7b engine: carriers {widths}, expected {want_widths}")

    def run(target: InferenceEngine) -> tuple[list, list, list[list[int]], int]:
        """One greedy call; the prefill logits with the prefill's K6
        launches, and each step's (block, logits)."""
        prefills, steps = [], []
        prefill, pick = target.model.prefill, target.model.decode_block_pick

        def recorded_prefill(*args):
            before = int4_matmul.launches
            logits, cache = prefill(*args)
            prefills.append((logits.float().cpu(), int4_matmul.launches - before))
            return logits, cache

        def recorded_pick(block, cache, run_len):
            logits, cache = pick(block, cache, run_len)
            steps.append((block.cpu(), logits.float().cpu()))
            return logits, cache

        cap, target.max_new_tokens = target.max_new_tokens, PROFILE_TOKENS
        steps0 = launched_steps(target.stats)
        try:
            with mock.patch.object(target.model, "prefill", recorded_prefill), \
                    mock.patch.object(target.model, "decode_block_pick", recorded_pick):
                _, _, ids = target.generate(clips, [PROMPT] * len(clips), return_status=True, return_tokens=True)
        finally:
            target.max_new_tokens = cap
        return prefills, steps, ids, launched_steps(target.stats) - steps0

    want_prefill, want_steps, want_ids, _ = run(engine)
    reset_counts()
    got_prefill, got_steps, got_ids, steps = run(fused)
    launched = counts()

    def ratio(got: torch.Tensor, want: torch.Tensor) -> float:
        return (got - want).abs().max().item() / (GROUNDING_LOGIT_TOL * want.abs().max().item())

    worst = ratio(got_prefill[0][0], want_prefill[0][0])
    compared = 0
    for (got_block, got_logits), (want_block, want_logits) in zip(got_steps, want_steps):
        if not torch.equal(got_block, want_block):
            break
        worst, compared = max(worst, ratio(got_logits, want_logits)), compared + 1
    if not math.isfinite(worst) or worst > 1:
        raise AssertionError(f"fused 7b engine: logits off the unfused engine's by {worst} x the tolerance")
    if launched["int4_matmul"] != 4 * layers * steps or got_prefill[0][1]:
        raise AssertionError(f"fused 7b engine: K6 {launched['int4_matmul']} launches for {steps} steps "
                             f"({got_prefill[0][1]} in prefill), expected {4 * layers * steps} and none")
    return {"phase": "fusion_7b", "preset": cfg.name, "decoder_layers": layers, "weights": "int4, fused",
            "qkv_carrier": list(INT4_FUSED_SHAPES["qkv_fused"]),
            "gate_up_carrier": list(INT4_FUSED_SHAPES["gate_up_fused"]),
            "logits_worst_ratio": worst, "logits_tol": GROUNDING_LOGIT_TOL, "steps_compared": compared,
            "decode_steps": steps, "k6_launches": launched["int4_matmul"], "k6_prefill_launches": got_prefill[0][1],
            "tokens_equal_unfused": got_ids == want_ids}, launched


# -- the qwen2vl path (main path 11) ---------------------------------------------

QWEN_MAX_NEW = 64  # new tokens a request of the qwen2vl path (128 until PR 19)
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


QWEN_TRAIN_DEPTH = 2  # tower blocks of the training check (of 32), at full width
QWEN_TRAIN_TEXT = 256  # text tokens: 512 merged video tokens + 256 = 768 decoder positions (K7a-c)


def qwen_train_check(seed: int, dev: torch.device, smi: str) -> tuple[dict, dict[str, int]]:
    """One training step's gradients through the Qwen2-VL tower at full
    width (embed 1280, 16 heads at head_dim 80, two 16-frame 224 px clips:
    K1 at [16, 16, 256, 80]) and ``QWEN_TRAIN_DEPTH`` blocks, into the tiny
    preset's decoder (its width is the merger's output): seeded f32
    weights, the distillation loss, bf16 compute on the card against f32 on
    the CPU. Every gradient leaf within ``GRAD_REL_TOL`` x its max of the
    CPU's. The tower's attention takes JAX's route at head_dim 80: K1 once a
    block forward, one recompute through ``mha_reference`` a block in the
    backward (``reference_backwards``), none in the forward; the decoder's
    K7a-c once a layer. Returns the line and the launches."""
    full, dec = get_preset("qwen2vl-7b"), get_preset("tiny").decoder
    cfg = VLMConfig(name="qwen2vl-7b-tower-train", encoder=replace(full.encoder, depth=QWEN_TRAIN_DEPTH,
                                                                     hidden_size=dec.hidden_dim), decoder=dec)
    enc = cfg.encoder
    cpu_model = random_params(cfg, torch.Generator(device="cpu").manual_seed(seed), device="cpu")
    cpu_model.config = replace(cfg, dtype="float32")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gpu_model.config = cfg
    rng = np.random.default_rng(seed)
    patches = torch.from_numpy(rng.standard_normal((QWEN_CLIPS, enc.tokens_per_clip, enc.patch_dim),
                                                   dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(3, dec.vocab_size, (QWEN_CLIPS, QWEN_TRAIN_TEXT)).astype(np.int32))
    results = {}
    for name, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        device = next(model.parameters()).device
        params = dict(model.named_parameters())
        reset_counts()
        t0 = time.perf_counter()
        loss, _ = distillation_loss(model, patches.to(device), tokens.to(device))
        forward = counts()
        grads = torch.autograd.grad(loss, list(params.values()))
        if device.type == "cuda":
            torch.cuda.synchronize()
        results[name] = (loss.item(), {n: g.float().cpu() for n, g in zip(params, grads)}, forward, counts(),
                         time.perf_counter() - t0)
    cpu_loss, cpu_grads, _, _, cpu_s = results["cpu"]
    gpu_loss, gpu_grads, forward, launched, gpu_s = results["gpu"]
    depth, layers = enc.depth, dec.num_layers
    want_forward = {"flash_attention": depth, "flash_fwd_lse": layers, "mha_reference_on_card": 0}
    want = {"flash_attention": depth, "reference_backwards": depth, "mha_reference_on_card": depth,
            "flash_fwd_lse": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if any(forward[k] != n for k, n in want_forward.items()) or any(launched[k] != n for k, n in want.items()):
        raise AssertionError(f"qwen_train: forward {forward}, step {launched}; expected {want_forward}, {want}")
    worst, worst_name = 0.0, ""
    for n, w in cpu_grads.items():
        ratio = ((gpu_grads[n] - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
        if not ratio <= worst:
            worst, worst_name = ratio, n
    if not math.isfinite(gpu_loss) or not worst <= GRAD_REL_TOL:
        raise AssertionError(f"qwen_train: leaf {worst_name} off the CPU's by {worst} x its max (tolerance "
                             f"{GRAD_REL_TOL}), loss {gpu_loss} against {cpu_loss}")
    groups = enc.grid[0]
    line = {"phase": "qwen_train", "preset": cfg.name, "vision_depth": depth, "embed_dim": enc.embed_dim,
            "vision_heads": enc.num_heads, "vision_head_dim": enc.head_dim,
            "k1_shape": [QWEN_CLIPS * groups, enc.num_heads, enc.tokens_per_clip // groups, enc.head_dim],
            "decoder": "tiny", "text_tokens": QWEN_TRAIN_TEXT, "loss_card": gpu_loss, "loss_cpu_f32": cpu_loss,
            "leaves": len(cpu_grads), "worst_leaf_ratio": worst, "worst_leaf": worst_name, "tol": GRAD_REL_TOL,
            "metric": "max|g_card - g_cpu| / max|g_cpu| a leaf", "launches": {k: launched[k] for k in want},
            "card_seconds": gpu_s, "cpu_seconds": cpu_s, "card": smi}
    return line, launched


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
    224 px clips, 64 new tokens. Before it: K1 at the tower's shapes, the
    tiny Qwen reference and the HF checkpoint round trip. Launches are
    counted from 0 around the one generate call: K1 32 times in the tower
    and 28 in the decoder's prefill, K2 28 times a prefill and a decode
    step, K3 28 and K6 196 times a step, no plain attention or cache write
    on the card. Prints its lines; returns K1's readings and the launches."""
    cfg = get_preset("qwen2vl-7b")
    t0 = time.perf_counter()
    k1 = qwen_kernel_phase(seed + 11, dev, cfg)
    emit(dict(qwen_reference_phase(seed, dev), seconds=time.perf_counter() - t0))
    train_line, trained = qwen_train_check(seed + 14, dev, smi)
    emit(train_line)
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
    ran = launched_steps(stats)
    want = {"flash_attention": depth + layers, "write_cache_rows": layers * (1 + ran),
            "decode_attention": layers * ran, "int4_matmul": 7 * layers * ran, "decode_attention_update": 0,
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
    k1["train_launches"] = trained["flash_attention"]
    return k1, {name: launched[name] + trained[name] for name in launched}


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
        entry = logits.to("cpu", torch.float32, copy=True)  # the loop advances the carry in place
        result = decode(logits, *args)
        out.append((entry, result[1].cpu()))
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
    before = (stats.generate_calls, stats.session_resumes, stats.decode_steps, stats.idle_steps)
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
    calls, resumes, steps, idle = (now - then for now, then in zip(
        (stats.generate_calls, stats.session_resumes, stats.decode_steps, stats.idle_steps), before))
    prefills = calls - resumes
    check_write_routes(launched, layers, prefills, steps + idle, "engine_api")
    if not launched["flash_attention"]:
        raise AssertionError(f"engine_api: K1 never launched: {launched}")
    lines.append({"phase": "engine_api", "preset": engine.config.name, "seconds": time.perf_counter() - t0,
                  "prefills": prefills, "session_rounds": resumes, "decode_steps": steps, "idle_steps": idle,
                  "decode_route": stats.decode_route, "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows",
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
# The int8 serving setting scores 4 single topics and no composites (to
# keep the smoke within its 5 minutes with the speculative path added:
# 16 + 8 took 15 s there, 8 topics 4.7 s; the setting at temperature 0.7,
# 4 s, went, the speculative path sampling at 0.7 in its place).
SERVING_INT8_TOPICS, SERVING_INT8_COMPOSITES = 4, 0


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
              stats.prefill_seconds, stats.idle_steps)
    reset_counts()
    with mock.patch.object(engine, "generate", recorded), decode_carries(engine, carries):
        report = run_eval(engine, topic_ids, GROUNDING_BATCH, seed=GROUNDING_SEED, composite_pairs=pairs or None)
    launched = counts()
    prefills, steps, tokens, seconds, prefill_seconds, idle = (
        now - then for now, then in zip((stats.generate_calls, stats.decode_steps, stats.tokens_generated,
                                         stats.generate_seconds, stats.prefill_seconds, stats.idle_steps), before))
    if engine.kv_quant == "int8":
        check_write_routes(launched, layers, prefills, steps + idle, f"grounding {setting}")
    elif (launched["write_cache_rows"], launched["decode_attention_update"], launched["decode_attention"],
          launched["update_cache_rows_on_card"]) != (layers * prefills, layers * (steps + idle), 0, 0):
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
        "prefills": prefills, "decode_steps": steps, "idle_steps": idle, "decode_route": stats.decode_route,
        "tokens": tokens, "wall_seconds": report["wall_seconds"],
        "decode_tokens_per_s": tokens / decode_s if decode_s else 0.0,
        "ms_per_step": decode_s / steps * 1e3 if steps else 0.0,
        "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows", "decode_attention",
                                                       "decode_attention_update")},
    }
    return line, launched, [(frames, prompts, logits) for (frames, prompts), (logits, _) in zip(calls, carries)]


def grounding_phase(dev: torch.device, tokenizer, smi: str) -> tuple[list[dict], dict[str, int]]:
    """Main path 6: the grounding scorecard of the trained tiny checkpoint
    (``tiny-zh-grounded-r5mix/params_4500``, full trained width) in two
    settings: the eval's own (bf16 weights and KV cache, greedy: K1, K2 in
    prefill, K5) and the shipped serving one (int8 weights and KV cache,
    greedy: K1, K2, K3, on ``SERVING_INT8_TOPICS`` topics and no
    composites).
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
    )
    lines, total = [], dict.fromkeys(counts(), 0)
    for setting, engine in settings:
        scope = {"serving_int8_greedy": (SERVING_INT8_TOPICS, SERVING_INT8_COMPOSITES)}
        line, launched, calls = grounding_run(engine, setting, *scope.get(setting, (GROUNDING_TOPICS,
                                                                                     GROUNDING_COMPOSITES)))
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
# (b) and the pipeline's (a) build base at full width with this many of its
# 24 decoder layers (``base_depth``; since the speculative path: at 24 they
# took 20.7 and 13.9 s of a smoke that had to fit in 5 minutes).
ANALYZER_BASE_LAYERS = SERVING_LAYERS


@contextlib.contextmanager
def base_depth(layers: int = ANALYZER_BASE_LAYERS):
    """``get_preset("base")`` with ``layers`` decoder layers while the block
    runs: the analyzer and the CLI build their engine from the preset's name
    in ``engine.model_preset``."""
    from video_transformer_tpu_torch.models import config as config_module

    preset = config_module.get_preset

    def cut(name, *args, **kwargs):
        cfg = preset(name, *args, **kwargs)
        return replace(cfg, decoder=replace(cfg.decoder, num_layers=layers)) if name == "base" else cfg

    with mock.patch.object(config_module, "get_preset", cut):
        yield


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
    before = (stats.decode_steps, stats.tokens_generated, stats.session_resumes, stats.frames_preprocessed,
              stats.idle_steps)
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
    steps, tokens, resumes, frames, idle = (now - then for now, then in zip(
        (stats.decode_steps, stats.tokens_generated, stats.session_resumes, stats.frames_preprocessed,
         stats.idle_steps), before))
    batcher_steps = steps - tally["engine_steps"]
    engine_ran = tally["engine_steps"] + idle  # the batcher's refill periods run no idle step
    events = log.messages[logged:]
    route = ("batcher" if any(m.startswith("event=segment_serving") for m in events)
             else "engine" if result.metadata.get("segments", 1) == 1 else "engine_segments")
    want = {"write_cache_rows": layers * (tally["prefills"] + engine_ran + tally["stages"]),
            "decode_attention": layers * engine_ran, "adopt_rows": layers * tally["stages"],
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
            "engine_decode_steps": tally["engine_steps"], "engine_idle_steps": idle,
            "decode_route": stats.decode_route, "batcher_stages": tally["stages"],
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

        # (b) base at full width and ANALYZER_BASE_LAYERS layers, random
        # weights, temperature 0.7.
        config = analyzer_config(workdir / "base", checkpoint_dir=None, grammar_scale=ANALYZER_BASE_SCALE,
                                 structure_bias=ANALYZER_BASE_BIAS, max_new_tokens=ANALYZER_BASE_MAX_NEW)
        config["analyzer"]["long_video"].update(segment_batch_per_chip=ANALYZER_BASE_BATCH,
                                                serving_slots_per_chip=ANALYZER_BASE_SLOTS)
        t0 = time.perf_counter()
        with base_depth():
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
# width and ``ANALYZER_BASE_LAYERS`` layers through ``cli.main([...])``
# in-process on the port's config, random weights as in the analyzer's
# (b), with the validator and
# the auditor scoring through the engine (``use_engine``, 2 rounds). The
# auditor's threshold is 0: random weights judge at random, and the image
# must be kept for its PNG to be checked (the audit still runs and its
# score is printed). (b) The trained tiny checkpoint through ``python -m
# video_transformer_tpu_torch --batch LIST --sharded`` in a fresh process,
# then again through ``cli.main`` in this process (it skips both clips
# through the progress file), then a ``WatchService`` scan over one clip in
# this process.
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
        before = (stats.decode_steps, stats.tokens_generated, flash_attention.launches, stats.idle_steps)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = execute(engine, frames, *args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        steps, tokens = stats.decode_steps - before[0], stats.tokens_generated - before[1]
        record.append({**({"call": label()} if label else {}), "video": frames is not None, "rows": args[3],
                       "decode_steps": steps, "idle_steps": stats.idle_steps - before[3], "tokens": tokens, "seconds": seconds, "tokens_per_s": tokens / seconds,
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
    batcher kernel and nothing plain on the card (the decode graphs' idle
    steps launch as a live step does)."""
    steps = sum(c["decode_steps"] + c["idle_steps"] for c in calls)
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


def pipeline_cli_base(workdir: Path, frames: np.ndarray, smi: str) -> tuple[dict, dict[str, int]]:
    """(a): ``cli.main(["--url", clip, "--config", config.json])`` at full
    base width and ``ANALYZER_BASE_LAYERS`` layers; the line and the
    launches."""
    config = analyzer_config(workdir, checkpoint_dir=None, grammar_scale=ANALYZER_BASE_SCALE,
                             structure_bias=ANALYZER_BASE_BIAS, max_new_tokens=ANALYZER_BASE_MAX_NEW)
    config["validator"].update(use_engine=True, max_rounds=PIPELINE_ROUNDS)
    config["auditor"].update(use_engine=True, threshold=PIPELINE_AUDIT_THRESHOLD)
    workdir.mkdir(parents=True)
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(config, ensure_ascii=False, indent=1), encoding="utf-8")
    clip = workdir / "lecture.npzv"
    write_npzv(clip, frames, ANALYZER_CLIP_FPS)
    log, record = LogLines(), {}
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with framework_log(log), pipeline_probes(record), base_depth():
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
    engine_layers = ANALYZER_BASE_LAYERS
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


def pipeline_cli_tiny(workdir: Path, rng: np.random.Generator, smi: str):
    """(b): the trained tiny checkpoint through ``python -m
    video_transformer_tpu_torch --batch LIST --sharded`` in a fresh process,
    then through ``cli.main`` with the same arguments in this process,
    which must skip both clips (a second fresh process took 12.7 s to
    start and skip). Starts the fresh process and returns a function that
    waits for it, makes the second run and returns the line."""
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
    args = ["--batch", str(listing), "--sharded", "--config", str(config_path)]
    start = time.perf_counter()
    with open(workdir / "stdout.txt", "w") as out, open(workdir / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "video_transformer_tpu_torch", *args], cwd=REPO,
                                env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=out, stderr=err)
    BACKGROUND.append(proc)
    return functools.partial(pipeline_cli_tiny_again, proc, start, args, config, clips, smi)


def pipeline_cli_tiny_again(proc: subprocess.Popen, start: float, args: list[str], config: dict, clips: list[Path],
                            smi: str) -> dict:
    """(b)'s fresh process waited for, then the second run in this process."""
    code = proc.wait(timeout=PIPELINE_CLI_TIMEOUT - (time.perf_counter() - start))
    seconds = time.perf_counter() - start
    workdir = clips[0].parent
    stdout, stderr = ((workdir / name).read_text(errors="replace") for name in ("stdout.txt", "stderr.txt"))
    if code != 0:
        raise AssertionError(f"pipeline (b) first: exit {code}\n{stdout[-2000:]}\n{stderr[-4000:]}")
    runs = [{"run": "first", "process": "fresh", "seconds": seconds, "exit_code": code,
             "stdout": [line for line in stdout.splitlines() if line.strip("= ")]}]
    out, log = io.StringIO(), LogLines()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out), framework_log(log):
        code = port_cli.main(args)
    seconds = time.perf_counter() - start
    if code != 0:
        raise AssertionError(f"pipeline (b) again: exit {code}\n{out.getvalue()[-2000:]}")
    runs.append({"run": "again", "process": "this", "seconds": seconds, "exit_code": code,
                 "stdout": [line for line in out.getvalue().splitlines() if line.strip("= ")]})
    outputs = {clip.stem: pipeline_outputs(config, clip.stem, f"(b) {clip.stem}") for clip in clips}
    notes = sorted(p.name for p in (Path(config["system"]["output_dir"]) / "documents").glob("*.md"))
    if len(notes) != 2 or "2/2" not in " ".join(runs[0]["stdout"]):
        raise AssertionError(f"pipeline (b): notes {notes}, stdout {runs[0]['stdout']}")
    if "所有视频均已处理" not in log.messages or runs[1]["stdout"]:
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
    with tempfile.TemporaryDirectory(prefix="vtx_pipeline_") as tmp:
        workdir = Path(tmp)
        # (b)'s fresh process runs while this one runs (a) and the scan.
        frames = rng.integers(0, 256, (ANALYZER_CLIP_FRAMES, ANALYZER_FRAME_SIZE, ANALYZER_FRAME_SIZE, 3),
                              dtype=np.uint8)
        tiny_again = pipeline_cli_tiny(workdir / "cli", rng, smi)
        base_line, launched = pipeline_cli_base(workdir / "base", frames, smi)
        gc.collect()
        torch.cuda.empty_cache()
        watch_line, watched = pipeline_watch(workdir / "watch", rng, smi)
        lines = [base_line, tiny_again(), watch_line]
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
        lines.append({"phase": f"{label}_step", "route": trainer.stats.step_route, "step": step,
                      "loss": metrics["loss"],
                      "grad_norm": metrics["grad_norm"], "loss_tokens": metrics["tokens"], "step_ms": ms,
                      "batch_seconds": batch_s, "launches": {k: launched[k] for k in TRAIN_STEP_LAUNCHES}})
    return lines, step_ms, rows


def route_stats(trainer: Trainer) -> dict:
    """A trainer's ``StepStats``: its step route, graphs, capture seconds and replays."""
    stats = trainer.stats
    return {"step_route": stats.step_route, "graphs_captured": stats.graphs_captured,
            "capture_seconds": stats.capture_seconds, "replays": stats.replays}


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
    if trainer.stats.step_route != "graph":
        raise AssertionError(f"train_grounded: step route {trainer.stats.step_route}")
    lines.append({"phase": "train_grounded", "preset": config.name, "steps": GROUNDED_STEPS, "batch": args.batch,
                  **route_stats(trainer),
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
    if trainer.stats.step_route != "graph":
        raise AssertionError(f"train_staged: step route {trainer.stats.step_route}")
    lines.append({"phase": "train_staged", "preset": config.name, "pairs": len(records), "stage_seconds": stage_s,
                  **route_stats(trainer),
                  "setup_seconds": setup_s, "steps": STAGED_STEPS, "step_ms": step_ms,
                  "aligned_body_tokens_kept_of": bodies, "launches": launched, "card": smi})
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return lines, launched


def bf16_eval_launch_check(launched: dict, calls: list[dict], layers: int, label: str) -> None:
    """An eval engine's launches (bf16 KV cache): K1 in every call's
    prefill, K2 once a layer a prefill, K5 once a layer a decode step, no
    K3 and nothing plain on the card (the decode graphs' idle steps launch
    as a live step does)."""
    steps = sum(c["decode_steps"] + c["idle_steps"] for c in calls)
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
# ``device_trace``'s two defences (a warm-up step, a padded window), held in
# ``TRACE_SESSIONS`` sessions of ``TRACE_CALLS`` one-kernel calls each: every
# session must record every call's kernel. As many sessions with either
# defence taken out, and bare sessions with neither (``unwarmed_kernels``),
# are printed beside them.
TRACE_SESSIONS, TRACE_CALLS = 8, 20


def tracing_phase(dev: torch.device, tokenizer, workdir: Path, smi: str) -> dict:
    """The tracer's summary over every engine call of the smoke so far
    (each of ``TRACED_SPANS`` must be there: the engine API phase resumes a
    session), then one ``device_trace`` around a 16-token greedy decode of
    the trained tiny checkpoint: the exported trace must name the spans
    (``engine.preprocess``, ``engine.generate``) beside device kernels.
    Then ``TRACE_SESSIONS`` ``device_trace`` sessions of ``TRACE_CALLS``
    one-kernel calls, each of which must record every kernel, beside as
    many with no warm-up step, with no pad, and bare; each session gives
    the least gap from a launch record to its kernel's (negative where
    CUPTI places the kernel before its launch)."""
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

    def trace_events(fn, out: Path) -> list[dict]:
        with device_trace(out):
            fn()
            torch.cuda.synchronize()
        return json.loads((out / "trace.json").read_text(encoding="utf-8"))["traceEvents"]

    def kernels_in(events: list[dict]) -> int:
        return sum(1 for event in events if event.get("cat") == "kernel")

    def least_launch_gap_us(events: list[dict]) -> float | None:
        launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                    if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
        gaps = [float(e["ts"]) - launches[e["args"]["correlation"]] for e in events
                if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launches]
        return min(gaps) if gaps else None

    start = time.perf_counter()
    with mock.patch.object(torch.cuda.nvtx, "range_push", pushed):
        events = trace_events(lambda: engine.generate(clip, [PROMPT]), workdir)
    seconds = time.perf_counter() - start
    trace_path = workdir / "trace.json"
    named = {}
    for event in events:
        if event.get("name") in TRACED_SPANS:
            named.setdefault(event["name"], set()).add(event.get("cat", ""))
    kernels = kernels_in(events)
    if not {"engine.preprocess", "engine.generate"} <= set(named) or not kernels:
        raise AssertionError(f"tracing: the trace names {sorted(named)} and holds {kernels} device kernels")
    if nvtx_ranges != ["engine.generate", "engine.preprocess"]:
        raise AssertionError(f"tracing: NVTX ranges pushed {nvtx_ranges}")
    device_ms = sum(event.get("dur", 0) for event in events if event.get("cat") == "kernel") / 1e3

    x = torch.zeros(1024, device=dev)

    def calls():
        for _ in range(TRACE_CALLS):
            x.add_(1)

    def sessions(tag: str) -> tuple[list[int], list[float | None]]:
        traces = [trace_events(calls, workdir / f"{tag}_{i}") for i in range(TRACE_SESSIONS)]
        return [kernels_in(events) for events in traces], [least_launch_gap_us(events) for events in traces]

    recorded, gaps = sessions("session")
    with mock.patch.object(tracing_module, "WARMUP_LAUNCHES", 0):
        no_warmup, no_warmup_gaps = sessions("no_warmup")
    with mock.patch.object(tracing_module, "WINDOW_PAD_S", 0.0):
        no_pad, no_pad_gaps = sessions("no_pad")
    bare = [round(unwarmed_kernels(calls, 1)) for _ in range(TRACE_SESSIONS)]
    ablations = {"no_warmup_session_kernels": no_warmup, "no_warmup_least_gap_us": no_warmup_gaps,
                 "no_pad_session_kernels": no_pad, "no_pad_least_gap_us": no_pad_gaps, "bare_session_kernels": bare}
    if recorded != [TRACE_CALLS] * TRACE_SESSIONS:
        raise AssertionError(f"tracing: sessions of {TRACE_CALLS} kernels recorded {recorded} (least launch-to-kernel "
                             f"gaps {gaps} us; {ablations})")
    return {"phase": "tracing", "summary": summary, "trace_bytes": trace_path.stat().st_size,
            "trace_events": len(events), "trace_device_kernels": kernels,
            "span_categories": {name: sorted(cats) for name, cats in named.items()},
            "nvtx_ranges_pushed": nvtx_ranges, "traced_seconds": seconds, "traced_device_ms": device_ms,
            "session_calls": TRACE_CALLS, "warmup_launches": tracing_module.WARMUP_LAUNCHES,
            "window_pad_s": tracing_module.WINDOW_PAD_S, "session_kernels": recorded, "least_launch_gap_us": gaps,
            **ablations,
            "card": smi}


# -- the speculative path (main path 12) -----------------------------------------

SPEC_TOKENS = 6  # the shipped engine.draft.spec_tokens
SPEC_TEMPERATURE = 0.7  # the shipped engine.temperature
# New tokens a request of the speculative batcher, of the greedy runs and of
# the run at 0.7 (the smoke's 5 minutes: at 128 they took 11.7 + 5, 5.6 and
# 5 s of a host-bound 48-128 ms cycle; each runs on both routes).
SPEC_SHORT_TOKENS = 64
# A speculative row may part from the plain loop's tokens only where the
# plain model's top-two constrained logits lie within this fraction of the
# row's largest |logit| (the grounding phase's card-against-CPU bound): the
# verify's matmuls run at M = batch x 6 rows and the plain loop's at
# batch x 1, and the card may round the two differently.
SPEC_TIE_TOL = 2e-2
# The plain loop whose tokens greedy speculation reproduces: one token a
# step. With a subword vocabulary the shipped fast-forward (max_forced_run
# 2) emits each forced byte run as its greedy re-tokenization
# (TokenGrammar.forced_tables), while the verify takes the target's argmax
# among every token the grammar allows there, so the two part at forced
# runs; the JAX engine does the same (its speculative tests use the byte
# vocabulary, where a forced byte is one token).
SPEC_PLAIN_FORCED_RUN = 0
SPEC_SEED = 7  # the runs at SPEC_TEMPERATURE draw from this seed on both routes
SPEC_PROFILED_CYCLES = 2  # idle cycles under the profiler for a cycle's kernel ms (a busy share's numerator)


def spec_session_grammar():
    """The speculative session's grammar: a title of 8 to 12 characters, so
    that a few short rounds finish it (the validator grammar's 220 tokens
    took 12 s) and a third of a document is longer than a draft block."""
    return DfaBuilder().literal('{"title": ').free_string(8, 12).literal("}").finish()


@contextlib.contextmanager
def recorded_calls(engine: InferenceEngine, out: list):
    """Append each engine call's inputs, token ids and completion flags
    (``_execute``, asked for both whatever its caller asked) to ``out``."""
    execute = engine._execute

    def wrapped(frames, tokens_in, lengths, states, b_real, prompt_width, dfa, session_rounds, return_status,
                return_tokens, return_session):
        result = execute(frames, tokens_in, lengths, states, b_real, prompt_width, dfa, session_rounds, True, True,
                         return_session)
        texts, status, ids = result[:3]
        out.append({"frames": frames, "tokens": tokens_in, "lengths": lengths, "states": states, "dfa": dfa,
                    "ids": ids, "status": status})
        kept = (texts,) + ((status,) if return_status else ()) + ((ids,) if return_tokens else ()) + result[3:]
        return kept if len(kept) > 1 else texts

    with mock.patch.object(engine, "_execute", wrapped):
        yield


@contextlib.contextmanager
def spec_tally(engine: InferenceEngine, tally: dict):
    """Count the speculative cycles that ``engine``'s loops launch: the live
    ones and the idle ones that a graph ran past a loop's end
    (``launched_steps``; the batcher's refill periods have none). On the
    per-cycle loop (``_plain_decode``), where Python runs every cycle, also
    sum each cycle's live rows and emitted tokens on the device
    (``_spec_cycle``, the batcher's too); a replayed graph runs no Python,
    so there the sums stay None (the pair's per-cycle run has them)."""
    before = launched_steps(engine.stats)
    patch = contextlib.nullcontext()
    if engine._plain_decode:
        cycle = engine._spec_cycle

        def counted(logp, cache, draft_cache, state, finished, frozen, *rest):
            out = cycle(logp, cache, draft_cache, state, finished, frozen, *rest)
            tally["live"] = tally["live"] + (~frozen).sum()
            tally["emitted"] = tally["emitted"] + out[1].sum()
            return out

        patch = mock.patch.object(engine, "_spec_cycle", counted)
    else:
        tally["live"] = tally["emitted"] = None
    try:
        with patch:
            yield
    finally:
        tally["cycles"] += launched_steps(engine.stats) - before


def new_tally() -> dict:
    return {"cycles": 0, "live": 0, "emitted": 0}


def tally_line(tally: dict, spec_k: int) -> dict:
    """The cycles launched, accepted tokens a live row a cycle (t0 counts),
    and the share of the draft's proposals that the target accepted (None
    on the graphs: ``spec_tally``)."""
    if tally["live"] is None:
        return {"cycles": tally["cycles"], "accepted_tokens_per_cycle": None, "proposals_accepted": None}
    live, emitted = int(tally["live"]), int(tally["emitted"])
    return {"cycles": tally["cycles"], "accepted_tokens_per_cycle": emitted / live if live else 0.0,
            "proposals_accepted": (emitted - live) / (live * (spec_k - 1)) if live else 0.0}


def tie_gap(engine: InferenceEngine, call: dict, row: int, j: int) -> float:
    """The plain model's top-two constrained logit gap before token ``j``
    of row ``row`` of a recorded call (``recorded_calls``), over the row's
    largest |logit|: one prefill of the row's prompt block and its first
    ``j`` ids into a bf16 cache, with the grammar state after them."""
    model, dfa, dev = engine.model, call["dfa"], engine.device
    ids = call["ids"][row][:j]
    length = int(call["lengths"][row])
    width = 128 * math.ceil((length + j) / 128)
    tokens = np.full((1, width), engine.tokenizer.PAD, np.int32)
    tokens[0, :length] = call["tokens"][row, :length]
    tokens[0, length:length + j] = ids
    frames = call["frames"]
    video = engine.config.video_tokens if frames is not None else 0
    with torch.no_grad():
        cache = init_kv_cache(engine.config.decoder, 1, video + width, model.compute_dtype, device=dev)
        tokens_t = torch.from_numpy(tokens).to(dev)
        lengths_t = torch.tensor([length + j], dtype=torch.int32, device=dev)
        if frames is not None:
            logits, _ = model.prefill(engine.preprocess(frames[row:row + 1]), tokens_t, cache, lengths_t)
        else:
            logits, _ = model.prefill_text(tokens_t, cache, lengths_t)
    logits = logits.float()
    state = torch.tensor([grammar_walk(dfa, ids, int(call["states"][row]))], device=dev)
    masked = dfa.constrain(logits, state, engine._table_for(dfa))
    bias = engine.close_bias_array()
    top = (masked if bias is None else masked + bias).topk(2, dim=-1).values[0]
    return (top[0] - top[1]).item() / logits.abs().max().item()


def parted_rows(plain: InferenceEngine, call: dict, got_ids: list[list[int]], got_status: list[bool],
                label: str) -> list[dict]:
    """Where each row of ``got_ids`` leaves the recorded call's stream: the
    first differing token, or the end of a completed row where the other
    went on (a row cut by the token cap at another point is a prefix of the
    same stream). Raises unless every such row parts at a near tie
    (``tie_gap`` under ``SPEC_TIE_TOL``); returns the parted rows."""
    parted = []
    for row, (want, got) in enumerate(zip(call["ids"], got_ids)):
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if j is None and len(want) != len(got):
            shorter_done = call["status"][row] if len(want) < len(got) else got_status[row]
            j = min(len(want), len(got)) if shorter_done else None
        if j is None:
            continue
        gap = tie_gap(plain, call, row, j)
        parted.append({"row": row, "position": j, "top_two_gap_over_max_logit": gap})
        if not gap < SPEC_TIE_TOL:
            raise AssertionError(f"{label}: row {row} leaves the plain loop's tokens at {j}, where the top-two "
                                 f"gap is {gap} x max|logit| (a near tie is under {SPEC_TIE_TOL})")
    return parted


def check_spec_routes(launched: dict[str, int], target: VLMConfig, draft: VLMConfig, prefills: list[bool],
                      cycles: int, label: str, stages: int = 0) -> None:
    """A speculative run's launches: K1 in every encoder layer (a prefill
    with video: ``prefills`` holds each prefill's with_video) and prefill
    layer of both models; K2 once a layer of both models a prefill (a
    batcher stage prefills both); K5 once a target layer a cycle launched
    (the verify, W = SPEC_TOKENS) and once a draft layer a draft step (W =
    1, SPEC_TOKENS a cycle), ``cycles`` counting the idle cycles that a
    graph ran past a loop's end (``spec_tally``); K4 once a layer of each
    pool a stage; no K3 and nothing plain on the card. Raises otherwise."""
    lt, ld = target.decoder.num_layers, draft.decoder.num_layers
    encoders = target.encoder.num_layers + draft.encoder.num_layers
    n = len(prefills) + stages
    flash = n * (lt + ld) + encoders * (sum(prefills) + stages)
    want = {"flash_attention": flash, "write_cache_rows": n * (lt + ld),
            "decode_attention_update": cycles * (lt + SPEC_TOKENS * ld), "adopt_rows": stages * (lt + ld),
            "decode_attention": 0, "quantize_kv_on_card": 0, "update_cache_rows_on_card": 0,
            "mha_reference_on_card": 0}
    got = {key: launched[key] for key in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def spec_k5_reading(gen: torch.Generator, dev: torch.device, dec: DecoderConfig, batch: int, width: int,
                    cache_len: int, index: list[int]) -> dict:
    """K5 at a speculative decode shape (the verify's W = SPEC_TOKENS over
    the target's heads, or a draft step's W = 1 over the tiny draft's one
    head): bit for bit against K2 then K3 and twice on the same inputs
    (``k5_repeatable``), within ``REL_TOL`` of the plain version
    (``update_cache_rows`` then ``_scaled_reference``), timed beside it,
    with its bound."""
    hq, hkv, d = dec.num_heads, dec.num_kv_heads, dec.head_dim
    q = torch.randn(batch, hq, width, d, generator=gen, device=dev).to(torch.bfloat16)
    k_cache, v_cache = (torch.randn(batch, hkv, cache_len, d, generator=gen, device=dev).to(torch.bfloat16)
                        for _ in range(2))
    k_new, v_new = (torch.randn(batch, hkv, width, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    index_t = torch.tensor(index, dtype=torch.int32, device=dev)
    repeated = k5_repeatable(q, k_cache, v_cache, k_new, v_new, index_t, None)
    if not all(repeated.values()):
        raise AssertionError(f"K5 at q {list(q.shape)}: {repeated}")
    fused_k, fused_v, plain_k, plain_v = k_cache.clone(), v_cache.clone(), k_cache.clone(), v_cache.clone()
    out = decode_attention_update(q, fused_k, fused_v, k_new, v_new, index_t)

    def plain_update():
        update_cache_rows(plain_k, k_new, index_t)
        update_cache_rows(plain_v, v_new, index_t)
        return _scaled_reference(q, plain_k, plain_v, index_t + 1, None, None, None)

    ref = plain_update()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"K5 at q {list(q.shape)} disagrees with its plain version: {err} > {tol}")
    group = hq // hkv
    visible = sum(n + width for n in index)
    flops = sum(4 * group * d * (n + 1 + j) for n in index for j in range(width)) * hkv
    bound_ms, bound_by = bound(2 * hkv * visible * d * 2 + 2 * nbytes(q) + 2 * nbytes(k_new, v_new)
                               + nbytes(index_t), flops)
    return {"max_abs_err": err, "tol": tol, **repeated, "rows_per_kv_head": group * width,
            "splits": decode_splits(batch, hkv, cache_len),
            **one_kernel_readings(lambda: decode_attention_update(q, fused_k, fused_v, k_new, v_new, index_t)),
            "plain_ms": time_ms(plain_update), "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"q bf16 [{batch},{hq},{width},{d}] caches bf16 [{batch},{hkv},{cache_len},{d}] index={index}"}


def spec_route_run(engine: InferenceEngine, plain: bool, fn) -> dict:
    """``fn`` (speculative calls of ``engine``) on the per-cycle loop
    (``plain``: ``_plain_decode``) or on the graphs, with the launches
    counted from 0, the cycles launched (``spec_tally``), the ``generate``
    calls recorded (``recorded_calls``), and the route's stats, wall time
    and peak GiB. Raises unless the loop took the route asked for."""
    engine._plain_decode = plain
    stats = engine.stats
    keys = ROUTE_STATS + ("tokens_generated",)
    before = {key: getattr(stats, key) for key in keys}
    tally, calls = new_tally(), []
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        start = time.perf_counter()
        with spec_tally(engine, tally), recorded_calls(engine, calls):
            result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    finally:
        engine._plain_decode = False
    moved = {key: getattr(stats, key) - before[key] for key in keys}
    route = "eager" if plain else "graph"
    if stats.decode_route != route or (plain and moved["idle_steps"]):
        raise AssertionError(f"speculative {route}: the loop took the {stats.decode_route} route, "
                             f"{moved['idle_steps']} idle cycles")
    return {"route": route, "result": result, "calls": calls, "tally": tally, "launched": counts(),
            "cycles": moved["decode_steps"], "idle_cycles": moved["idle_steps"], "wall_s": wall,
            "decode_s": moved["generate_seconds"] - moved["prefill_seconds"], "prefill_s": moved["prefill_seconds"],
            "tokens": moved["tokens_generated"], "graphs_captured": moved["graphs_captured"],
            "capture_s": moved["capture_seconds"], "replays": moved["replays"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def spec_route_summary(run: dict, kernel_ms: float) -> dict:
    """A route's ms a live cycle and a launched one (over its decode
    seconds), its busy share (``kernel_ms``, the kernels' ms a cycle, over
    its ms a launched cycle), idle cycles, graphs captured, capture s,
    replays and peak GiB."""
    ms = run["decode_s"] * 1e3
    launched = run["cycles"] + run["idle_cycles"]
    out = {"ms_per_cycle": ms / run["cycles"], "ms_per_launched_cycle": ms / launched,
           "busy_share": kernel_ms * launched / ms}
    out.update({key: run[key] for key in ("wall_s", "cycles", "idle_cycles", "graphs_captured", "capture_s",
                                          "replays", "peak_gib")})
    return out


def spec_kernel_ms(step) -> float:
    """Kernel ms a speculative cycle: ``step`` (one cycle on a carry whose
    loop has ended, so idle: the kernels a replay runs, at the call's last
    extent) ``SPEC_PROFILED_CYCLES`` times eagerly under the profiler."""
    return step_kernel_ms(lambda: [step() for _ in range(SPEC_PROFILED_CYCLES)], SPEC_PROFILED_CYCLES)


def spec_routes(spec: InferenceEngine, fn, label: str, seed: int | None = None) -> tuple[list[dict], dict]:
    """``fn`` on the per-cycle loop, then twice on the graphs (a first run
    that warms up and captures, then one that replays), the generator
    seeded with ``seed`` before each when sampling. Each run's launches
    must equal its cycles launched x a cycle's (``check_spec_routes``), and
    the runs' token ids, completion flags, results and cycles must be equal
    bit for bit. Returns the runs and each route's summary
    (``spec_route_summary``; the replay ms a cycle beside the graph's)."""
    runs = []
    for plain in (True, False, False):
        if seed is not None:
            spec._generator.manual_seed(seed)
        run = spec_route_run(spec, plain, fn)
        check_spec_routes(run["launched"], spec.config, spec.draft_config,
                          [call["frames"] is not None for call in run["calls"]], run["tally"]["cycles"],
                          f"speculative {label} {run['route']}")
        runs.append(run)
    outs = [([c["ids"] for c in r["calls"]], [c["status"] for c in r["calls"]], r["result"], r["cycles"])
            for r in runs]
    if any(out != outs[0] for out in outs):
        raise AssertionError(f"speculative {label}: the graphs' tokens differ from the per-cycle loop's: "
                             f"cycles {[r['cycles'] for r in runs]}, "
                             f"tokens {[[[len(row) for row in c['ids']] for c in r['calls']] for r in runs]}")
    if not runs[1]["graphs_captured"] or runs[2]["graphs_captured"] or not runs[2]["replays"]:
        raise AssertionError(f"speculative {label}: captures {runs[1]['graphs_captured']} then "
                             f"{runs[2]['graphs_captured']}, replays {runs[2]['replays']}")
    entry = spec._graphs[next(reversed(spec._graphs))]  # the key the runs replayed
    kernel_ms = spec_kernel_ms(lambda: spec._spec_step(entry.carry))
    replay_ms = time_ms(entry.graph.replay, warmup=1, reps=2, rounds=3) / entry.graph.n
    routes = {"kernel_ms_per_cycle": kernel_ms, "eager": spec_route_summary(runs[0], kernel_ms),
              "graph_first": spec_route_summary(runs[1], kernel_ms),
              "graph": dict(spec_route_summary(runs[2], kernel_ms), replay_ms_per_cycle=replay_ms),
              "tokens_equal": True}
    return runs, routes


def sum_launches(runs: list[dict]) -> dict[str, int]:
    return {name: sum(run["launched"][name] for run in runs) for name in runs[0]["launched"]}


def spec_generate(spec: InferenceEngine, plain: InferenceEngine, plain_call: dict | None, clips: np.ndarray,
                  label: str, smi: str, plain_steps: int, seed: int | None = None) -> tuple[dict, dict[str, int]]:
    """One speculative generate of ``clips`` on both routes (``spec_routes``):
    every row walks the grammar, and the tokens equal the plain call's
    (``plain_call``, made by ``plain``), or part from them at printed near
    ties (``parted_rows``). Returns the line and the launches summed over
    the runs."""
    runs, routes = spec_routes(spec, lambda: spec.generate(clips, [PROMPT] * len(clips)), label, seed)
    eager, graph = runs[0], runs[2]
    call = graph["calls"][0]
    walk_rows(spec.dfa, call["status"], call["ids"], spec.max_new_tokens + SPEC_TOKENS, label)
    line = {"phase": "speculative", "run": label, "temperature": spec.temperature, "spec_tokens": spec.spec_tokens,
            "draft": spec.draft_config.name, "rows": len(clips), "tokens": [len(r) for r in call["ids"]],
            "complete": call["status"], **tally_line(eager["tally"], spec.spec_tokens), "plain_steps": plain_steps,
            "target_forwards": eager["cycles"], "ms_per_cycle": routes["graph"]["ms_per_cycle"],
            "eager_ms_per_cycle": routes["eager"]["ms_per_cycle"], "prefill_ms": graph["prefill_s"] * 1e3,
            "tokens_per_s": graph["tokens"] / graph["wall_s"], "eager_tokens_per_s": eager["tokens"] / eager["wall_s"],
            "routes": routes,
            "launches": {name: graph["launched"][name] for name in ("flash_attention", "write_cache_rows",
                                                                    "decode_attention_update", "decode_attention")},
            "card": smi}
    if seed is not None:
        line["seed"] = seed
    if plain_call is not None:
        parted = parted_rows(plain, plain_call, call["ids"], call["status"], label)
        line.update(rows_parted=len(parted), parted=parted)
    return line, sum_launches(runs)


def grammar_advance_line(engine: InferenceEngine, seed: int, smi: str) -> dict:
    """``TokenGrammar.advance`` on the note grammar's tables on the card,
    through the ``next_token`` table and through the byte walk (the same
    tables without it), in this one call: equal successors on random
    (state, token) pairs, states of -1 among them, at the speculative
    greedy run's 2 rows and the batcher's 8; each route's CUDA-event ms
    and host µs a call, and the table's build ms. A speculative cycle
    advances 1 + ``SPEC_TOKENS`` times, a plain step once."""
    dfa, dev = engine.dfa, engine.device
    tables = engine._table_for(dfa)
    walk = {key: value for key, value in tables.items() if key != "next_token"}
    torch.cuda.synchronize()
    start = time.perf_counter()
    built = token_transition_table(tables)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - start) * 1e3
    if not torch.equal(built, tables["next_token"]):
        raise AssertionError("grammar advance: the rebuilt next_token table differs")
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    rows = {}
    for batch in (2, BATCHER_SLOTS):
        state = torch.randint(-1, dfa.num_states, (batch,), generator=gen, device=dev)
        token = torch.randint(0, dfa.vocab_size, (batch,), generator=gen, device=dev)
        if not torch.equal(dfa.advance(state, token, tables), dfa.advance(state, token, walk)):
            raise AssertionError(f"grammar advance: the table and the walk part at batch {batch}")
        rows[str(batch)] = {
            "table_ms": time_ms(lambda: dfa.advance(state, token, tables)),
            "walk_ms": time_ms(lambda: dfa.advance(state, token, walk)),
            "table_host_us": host_us(lambda: dfa.advance(state, token, tables)),
            "walk_host_us": host_us(lambda: dfa.advance(state, token, walk)),
        }
    return {"phase": "grammar_advance", "states": dfa.num_states, "vocab": dfa.vocab_size,
            "table_shape": list(built.shape), "table_build_ms": build_ms, "by_batch": rows,
            "advances_per_cycle": 1 + SPEC_TOKENS, "card": smi}


def speculative_phase(seed: int, engine: InferenceEngine, plain: InferenceEngine, clips: np.ndarray,
                      batch_clips: np.ndarray, batch_prompts: list[str], smi: str) -> tuple[list[dict], dict, dict]:
    """Main path 12, speculative decoding at base's full width and
    ``SERVING_LAYERS`` layers on path 1's int8 weights, ``SPEC_SHORT_TOKENS``
    new tokens (a session's from its grammar), the note grammar; the draft
    is the trained tiny checkpoint (``attach_draft(tiny,
    checkpoint=TINY_WEIGHTS, spec_tokens=6)``). Both
    caches are bf16, so the verify and every draft step run K5. ``plain``
    is the shipped plain loop on the same weights with a bf16 cache (its
    steps and tok/s are the comparison); the token reference is the same
    engine one token a step (``SPEC_PLAIN_FORCED_RUN``).

    Every run below but the analyzer's runs on the per-cycle loop (the
    loop's plain version, ``_plain_decode``) and on the graphs (replayed
    CUDA graphs of ``SPEC_CHUNK`` cycles), whose tokens, flags and cycles
    must be equal bit for bit (``spec_routes``); each route's ms a cycle,
    busy share, capture s, graphs, replays, idle cycles and peak GiB are
    printed.

    - greedy, two clips, against the plain loop (tokens equal, or parting
      at near ties; ``parted_rows``), with accepted tokens a cycle, target
      forwards against the plain steps, ms a cycle and tok/s;
    - a self-draft (``share_target_params=True``, ``SPEC_SHORT_TOKENS``):
      fewer than half as many target forwards as the one-token loop's
      steps for the same tokens, which follow the greedy rule;
    - temperature 0.7 (``SPEC_SHORT_TOKENS``, ``SPEC_SEED``): every row
      walks the grammar;
    - a session under a short title grammar (``spec_session_grammar``),
      its round and reserve sized from one greedy call's longer document
      so that a continuation is needed, continued until it completes,
      against one call with the budget that sizes the same cache;
    - the batcher: 8 slots, a ring of 16, twelve requests of
      ``SPEC_SHORT_TOKENS`` (K1, K2 and K4 into both pools in the stage, K5
      for both models each cycle); the first wave against the speculative
      engine's generate at batch 8;
    - the analyzer's (a) run with ``engine.draft`` in its config
      (``event=engine_draft_attached``, on the graphs) against the plain (a)
      run one token a step, both with a bf16 cache.

    Its first line is ``grammar_advance_line``'s. Returns the lines, the
    launches summed over the phase and K5's
    readings at the verify's and a draft step's shapes."""
    cfg, dev, tokenizer = engine.config, engine.device, engine.tokenizer
    draft_cfg = base_config(tokenizer.vocab_size, "tiny")
    lines, total = [grammar_advance_line(engine, seed, smi)], dict.fromkeys(counts(), 0)

    def add(launched):
        for name in total:
            total[name] += launched[name]

    def spec_engine(**kwargs) -> InferenceEngine:
        out = InferenceEngine(cfg, params=engine.model, tokenizer=tokenizer, max_new_tokens=MAX_NEW_TOKENS,
                              temperature=0.0, max_forced_run=2, param_dtype="bfloat16", device=dev, **kwargs)
        out.dfa = engine.dfa
        return out

    t0 = time.perf_counter()
    spec = spec_engine()
    spec.attach_draft(draft_cfg, checkpoint=TINY_WEIGHTS, spec_tokens=SPEC_TOKENS)
    if spec.draft_model.decoder.layer_0.attn.q.kernel.dtype != torch.bfloat16:
        raise AssertionError("the draft is not served in bf16")
    setup = time.perf_counter() - t0

    # The shipped plain loop on the same weights with a bf16 cache, then the
    # token reference: the same, one token a step.
    steps0 = plain.stats.decode_steps
    gen0 = (plain.stats.generate_seconds, plain.stats.tokens_generated)
    plain.max_new_tokens = SPEC_SHORT_TOKENS
    plain.generate(clips[:2], [PROMPT] * 2)
    plain.max_new_tokens = MAX_NEW_TOKENS
    plain_steps = plain.stats.decode_steps - steps0
    plain_tok_s = (plain.stats.tokens_generated - gen0[1]) / (plain.stats.generate_seconds - gen0[0])
    plain = InferenceEngine(cfg, params=engine.model, tokenizer=tokenizer, max_new_tokens=SPEC_SHORT_TOKENS,
                            temperature=0.0, max_forced_run=SPEC_PLAIN_FORCED_RUN, device=dev)
    plain.dfa = engine.dfa
    plain_calls = []
    with recorded_calls(plain, plain_calls):
        plain.generate(clips[:2], [PROMPT] * 2)
    one_token_steps = plain.stats.decode_steps

    spec.max_new_tokens = SPEC_SHORT_TOKENS
    line, launched = spec_generate(spec, plain, plain_calls[0], clips[:2], "greedy", smi, plain_steps)
    spec.max_new_tokens = MAX_NEW_TOKENS
    lines.append(dict(line, setup_seconds=setup, plain_tokens_per_s=plain_tok_s, preset=cfg.name,
                      one_token_plain_steps=one_token_steps, decoder_layers=cfg.decoder.num_layers,
                      weights="int8", caches="bf16"))
    add(launched)

    self_spec = spec_engine()
    self_spec.max_new_tokens = SPEC_SHORT_TOKENS
    self_spec.attach_draft(cfg, share_target_params=True, spec_tokens=SPEC_TOKENS)
    if self_spec.draft_model is not self_spec.model:
        raise AssertionError("share_target_params: the draft is not the target's model")
    line, launched = spec_generate(self_spec, plain, plain_calls[0], clips[:2], "self_draft", smi, plain_steps)
    one_token = max(line["tokens"])  # the one-token loop's steps for the same tokens
    if not 2 * line["target_forwards"] < one_token:
        raise AssertionError(f"self-draft: {line['target_forwards']} target forwards for {one_token} tokens")
    lines.append(dict(line, one_token_plain_steps=one_token))
    add(launched)
    del self_spec

    spec.temperature, spec.max_new_tokens = SPEC_TEMPERATURE, SPEC_SHORT_TOKENS
    line, launched = spec_generate(spec, plain, None, clips[:2], "temperature_0.7", smi, plain_steps,
                                   seed=SPEC_SEED)
    spec.temperature, spec.max_new_tokens = 0.0, MAX_NEW_TOKENS
    lines.append(line)
    add(launched)

    # A session under a short grammar, resumed until it completes. The
    # round's cap and the reserve come from the longer row's document L (one
    # greedy call that completes it), whatever the random weights write: a
    # round emits at least its cap and at most a draft block more, so with a
    # cap of (L - SPEC_TOKENS) // 2 the longer row needs a continuation, and
    # ceil(L / cap) reserve rounds finish every row.
    title = spec.wrap_grammar(spec_session_grammar())
    spec.max_new_tokens = longest_accepted(title.dfa) + 1
    *_, whole = spec.generate(clips[:2], API_PROMPTS, dfa=title, return_tokens=True)
    longest = max(len(row) for row in whole)
    cap = max(1, (longest - SPEC_TOKENS) // 2)
    rounds = -(-longest // cap)
    stats = spec.stats

    def session_run():
        _, status, ids, session = spec.generate(clips[:2], API_PROMPTS, dfa=title, session_rounds=rounds,
                                                return_session=True, return_status=True, return_tokens=True)
        if session is None or session.rounds_left != rounds or session.draft_cache is None:
            raise AssertionError(f"speculative session reserve: {session and session.rounds_left}")
        prefill_tokens = stats.prefill_tokens
        combined, done, resumed = [list(r) for r in ids], list(status), 0
        while not all(done) and session.rounds_left > 0:
            _, done, more = spec.continue_session(session)
            for row in range(len(done)):
                combined[row] += more[row]
            resumed += 1
        if stats.prefill_tokens != prefill_tokens or not all(done) or not resumed:
            raise AssertionError(f"speculative session: complete {done} after {resumed} rounds, or a round prefilled")
        return combined, done, resumed, session.cache["k"][0].shape[2], session.draft_cache["k"][0].shape[2]

    spec.max_new_tokens = cap
    try:
        session_runs = []
        for plain_route in (True, False):
            run = spec_route_run(spec, plain_route, session_run)
            check_spec_routes(run["launched"], cfg, draft_cfg, [True], run["tally"]["cycles"],
                              f"speculative session {run['route']}")
            add(run["launched"])
            session_runs.append(run)
        if (session_runs[0]["result"], session_runs[0]["cycles"]) != (session_runs[1]["result"],
                                                                      session_runs[1]["cycles"]):
            raise AssertionError(f"speculative session: the graphs' rounds differ from the per-cycle loop's: "
                                 f"cycles {[r['cycles'] for r in session_runs]}")
        entry = spec._graphs[next(reversed(spec._graphs))]  # the session's key
        kernel_ms = spec_kernel_ms(lambda: spec._spec_step(entry.carry))
        combined, done, resumed, session_len, draft_session_len = session_runs[1]["result"]
        spec.max_new_tokens = (1 + rounds) * cap + rounds * SPEC_TOKENS
        prompt_width = spec._prompt_bucket(API_PROMPTS, with_video=True)
        if spec._cache_len(prompt_width, True, title, 0) != session_len:
            raise AssertionError("the long call's cache length differs from the speculative session's")
        long_calls = []
        with recorded_calls(spec, long_calls):
            spec.generate(clips[:2], API_PROMPTS, dfa=title)
        parted = parted_rows(plain, long_calls[0], combined, done, "speculative session")
        walk_rows(title, done, combined, spec.max_new_tokens + SPEC_TOKENS, "speculative session")
    finally:
        spec.max_new_tokens = MAX_NEW_TOKENS
    launched = session_runs[1]["launched"]
    lines.append({"phase": "speculative", "run": "session", "grammar": "title", "round_cap": cap,
                  "reserve": rounds, "longest_row_tokens": longest, "rounds_resumed": resumed, "cache_len": session_len,
                  "draft_cache_len": draft_session_len,
                  "tokens": [len(r) for r in combined], "long_tokens": [len(r) for r in long_calls[0]["ids"]],
                  "rows_parted": len(parted), "parted": parted, **tally_line(session_runs[0]["tally"], SPEC_TOKENS),
                  "routes": {"kernel_ms_per_cycle": kernel_ms,
                             **{r["route"]: spec_route_summary(r, kernel_ms) for r in session_runs},
                             "tokens_equal": True},
                  "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows",
                                                                 "decode_attention_update", "decode_attention")},
                  "card": smi})

    # The speculative batcher: twelve requests through 8 slots, on the
    # per-cycle loop, then twice through one batcher on the graphs (its
    # first refill period eager, then a capture; then replays only).
    def sweep(batcher: ContinuousBatcher, route: str) -> dict:
        stages, stage, stage_s = [], batcher._stage, [0.0]

        def counted_stage():
            before = batcher._staged_total
            torch.cuda.synchronize()
            start = time.perf_counter()
            stage()
            torch.cuda.synchronize()
            stage_s[0] += time.perf_counter() - start
            if batcher._staged_total > before:
                stages.append(batcher._staged_total - before)

        spec._plain_decode = route == "eager"
        try:
            for i, clip in enumerate(batch_clips):
                batcher.submit(Request(i, clip, batch_prompts[i]))
            tally, before = new_tally(), replace(batcher.stats)
            cycles0 = spec.stats.decode_steps
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            with spec_tally(spec, tally), mock.patch.object(batcher, "_stage", counted_stage):
                completions = batcher.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            spec._plain_decode = False
        launched = counts()
        check_spec_routes(launched, cfg, draft_cfg, [], tally["cycles"], f"speculative batcher {route}",
                          stages=len(stages))
        add(launched)
        if batcher.stats.decode_route != route or batcher.stats.idle_steps:
            raise AssertionError(f"speculative batcher: route {batcher.stats.decode_route}, asked for {route}")
        if sorted(c.request_id for c in completions) != list(range(len(batch_clips))):
            raise AssertionError("speculative batcher: not every request completed once")
        return {
            "route": route, "stages": stages, "tally": tally, "launched": launched,
            "tokens": {c.request_id: (c.token_ids, c.complete) for c in completions}, "completions": completions,
            "cycles": spec.stats.decode_steps - cycles0, "idle_cycles": 0, "wall_s": wall, "stage_s": stage_s[0],
            "decode_s": wall - stage_s[0], "graphs_captured": batcher.stats.graphs_captured - before.graphs_captured,
            "capture_s": batcher.stats.capture_seconds - before.capture_seconds,
            "replays": batcher.stats.replays - before.replays, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    spec._plain_decode = True
    try:
        batcher = ContinuousBatcher(spec, slots=BATCHER_SLOTS, max_new_tokens=SPEC_SHORT_TOKENS)
    finally:
        spec._plain_decode = False
    batcher_runs = [sweep(batcher, "eager")]
    batcher = ContinuousBatcher(spec, slots=BATCHER_SLOTS, max_new_tokens=SPEC_SHORT_TOKENS)
    batcher_runs += [sweep(batcher, "graph"), sweep(batcher, "graph")]
    eager_run, first_run, graph_run = batcher_runs
    if any((r["tokens"], r["cycles"]) != (eager_run["tokens"], eager_run["cycles"]) for r in batcher_runs):
        raise AssertionError(f"speculative batcher: the graphs' tokens differ from the per-cycle loop's: cycles "
                             f"{[r['cycles'] for r in batcher_runs]}")
    if not first_run["graphs_captured"] or graph_run["graphs_captured"] or not graph_run["replays"]:
        raise AssertionError(f"speculative batcher: {first_run['graphs_captured']} then "
                             f"{graph_run['graphs_captured']} graphs, {graph_run['replays']} replays")
    stages, completions = graph_run["stages"], graph_run["completions"]
    kernel_ms = spec_kernel_ms(batcher._step)  # every slot done: idle cycles at the sweep's last extent
    for c in completions:
        grammar_walk(spec.dfa, c.token_ids)
        if c.complete:
            check_complete(spec.dfa, c.request_id, c.token_ids)
    got = {c.request_id: c for c in completions}
    wave = []
    spec.max_new_tokens = SPEC_SHORT_TOKENS
    with recorded_calls(spec, wave):
        spec.generate(batch_clips[:BATCHER_SLOTS], batch_prompts[:BATCHER_SLOTS], prompt_len=batcher.prompt_len)
    spec.max_new_tokens = MAX_NEW_TOKENS
    parted = parted_rows(plain, wave[0], [got[i].token_ids for i in range(BATCHER_SLOTS)],
                         [got[i].complete for i in range(BATCHER_SLOTS)], "speculative batcher first wave")
    tokens = sum(c.tokens for c in completions)
    launched = graph_run["launched"]
    lines.append({"phase": "speculative", "run": "batcher", "requests": len(batch_clips), "slots": BATCHER_SLOTS,
                  "queue_depth": batcher.queue_depth, "cache_len": batcher.cache_len,
                  "draft_cache_len": batcher.draft_cache_len, "park_len": batcher.park_len,
                  "draft_park_len": batcher.draft_park_len, "stages": stages, "seconds": graph_run["wall_s"],
                  "stage_seconds": [r["stage_s"] for r in batcher_runs],
                  "tokens": tokens, "tokens_per_s": tokens / graph_run["wall_s"],
                  "eager_tokens_per_s": tokens / eager_run["wall_s"],
                  "ms_per_cycle": graph_run["wall_s"] * 1e3 / graph_run["cycles"],
                  **tally_line(eager_run["tally"], SPEC_TOKENS),
                  "routes": {"kernel_ms_per_cycle": kernel_ms, "eager": spec_route_summary(eager_run, kernel_ms),
                             "graph_first": spec_route_summary(first_run, kernel_ms),
                             "graph": spec_route_summary(graph_run, kernel_ms), "tokens_equal": True},
                  "first_wave_rows_parted": len(parted), "parted": parted,
                  "launches": {name: launched[name] for name in ("flash_attention", "write_cache_rows", "adopt_rows",
                                                                 "decode_attention_update", "decode_attention")},
                  "card": smi})
    del batcher, batcher_runs, eager_run, first_run, graph_run

    # The analyzer's (a) run with the draft in its config, against the plain (a) run.
    with tempfile.TemporaryDirectory(prefix="vtx_spec_analyzer_") as tmp:
        workdir = Path(tmp)
        log = LogLines()
        logger = logging.getLogger("vtx.chip_smoke.speculative")
        logger.handlers, logger.propagate = [log], False
        logger.setLevel(logging.INFO)
        runs = {}
        for label, draft in (("plain", None), ("draft", {"model_preset": "tiny", "checkpoint_dir": str(TINY_WEIGHTS),
                                                          "spec_tokens": SPEC_TOKENS})):
            config = analyzer_config(workdir / label, model_preset="tiny", checkpoint_dir=str(TINY_WEIGHTS),
                                     temperature=0.0, max_new_tokens=GROUNDING_MAX_NEW, kv_quant=None,
                                     **({"draft": draft} if draft else {"max_forced_run": SPEC_PLAIN_FORCED_RUN}))
            analyzer = ContentAnalyzer(config, APICounter(config["system"]["max_api_calls"]), logger)
            target = analyzer.engine
            if draft and not any(m.startswith("event=engine_draft_attached") for m in log.messages):
                raise AssertionError(f"analyzer with a draft: not attached: {log.messages}")
            clip = workdir / f"{label}.npzv"
            write_npzv(clip, render_topic_clip(ANALYZER_TOPIC, ANALYZER_CLIP_FRAMES, target.config.encoder.image_size,
                                               np.random.default_rng(seed)), ANALYZER_CLIP_FPS)
            calls, tally = [], new_tally()
            reset_counts()
            start = time.perf_counter()
            with recorded_calls(target, calls), spec_tally(target, tally) if draft else contextlib.nullcontext():
                result = analyzer.analyze_video(clip)
            wall = time.perf_counter() - start
            launched = counts()
            report = analyzer.generate_report(result, "images/blueprint.png",
                                              self_check_mode=analyzer.config["system"]["self_check_mode"])
            runs[label] = {"analyzer": analyzer, "calls": calls, "report": report, "wall": wall, "tally": tally,
                           "launched": launched}
            if draft:
                check_spec_routes(launched, target.config, target.draft_config,
                                  [call["frames"] is not None for call in calls], tally["cycles"],
                                  "speculative analyzer")
                add(launched)
        parted, compared = [], 0
        for want, got_call in zip(runs["plain"]["calls"], runs["draft"]["calls"]):
            plain_engine = runs["plain"]["analyzer"].engine
            parted = parted_rows(plain_engine, want, got_call["ids"], got_call["status"], "speculative analyzer")
            compared += 1
            if parted:
                break
    lines.append({"phase": "speculative", "run": "analyzer", "event": "engine_draft_attached",
                  "decode_route": runs["draft"]["analyzer"].engine.stats.decode_route,
                  "idle_cycles": runs["draft"]["analyzer"].engine.stats.idle_steps,
                  "engine_calls": [len(runs["plain"]["calls"]), len(runs["draft"]["calls"])],
                  "calls_compared": compared, "rows_parted": len(parted), "parted": parted,
                  "note_equal_to_plain": runs["draft"]["report"] == runs["plain"]["report"],
                  "wall_seconds": [runs["plain"]["wall"], runs["draft"]["wall"]],
                  **tally_line(runs["draft"]["tally"], SPEC_TOKENS),
                  "launches": {name: runs["draft"]["launched"][name]
                               for name in ("flash_attention", "write_cache_rows", "decode_attention_update",
                                            "decode_attention")},
                  "card": smi})
    del runs

    # K5 at the verify's shape and at a draft step's, beside the plain version.
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    verify_len = spec._cache_len(spec._prompt_bucket([PROMPT], True), True, spec.dfa, 0)
    draft_len = spec._cache_len(spec._prompt_bucket([PROMPT], True), True, spec.dfa, 0, draft_cfg)
    # Two rows part-way into the new tokens: positions 100 and 230 of 256.
    early, late = MAX_NEW_TOKENS // 2 - 28, MAX_NEW_TOKENS - 26
    readings = {
        "verify": spec_k5_reading(gen, dev, cfg.decoder, 2, SPEC_TOKENS, verify_len,
                                  [cfg.video_tokens + 128 + early, cfg.video_tokens + 128 + late]),
        "draft_step": spec_k5_reading(gen, dev, draft_cfg.decoder, 2, 1, draft_len,
                                      [draft_cfg.video_tokens + 128 + early, draft_cfg.video_tokens + 128 + late]),
    }
    return lines, total, readings


# Main path 13, serving over a mesh (``mesh``): ranks that share the one
# card (``build_mesh(..., devices=[cuda:0] * 2)``: gloo, CUDA tensors).
# (a) base at its full width and ``MESH_LAYERS`` decoder layers (int8 weights
# and KV cache, the note grammar, greedy) on ``{"data": 1, "model": 2}``:
# ``generate`` on two clips against the 1-rank engine on the same seeded
# weights (equal tokens, or parting only at a printed near tie; the logits
# at the first and the last decode step within ``MESH_LOGIT_TOL``), then
# ``ContentAnalyzer.analyze_video`` on the same mesh engine; (b) ``7b`` at
# full width and ``MESH_INT4_LAYERS`` layers, int4 weights, on the same mesh,
# held to the 1-rank engine as (a) is: K6 at the five per-rank product
# shapes; (c) ``{"data": 2, "model": 1}``
# through ``ContinuousBatcher`` (two data groups, bf16 pool, base at
# ``SERVING_LAYERS`` layers) on the same two ranks: each group's requests
# against a 1-rank batcher of the group's slots over the same requests. Every rank's
# launches are counted from 0 a run; none is plain on a CUDA tensor.
MESH_NEW_TOKENS = 16  # base on two model ranks (and the uneven runs), held to 1 rank over these
# Base's decoder layers on two model ranks, and the analyzer's on them: half
# of its 24, so that the per-step loop over gloo, the smoke's longest, leaves
# the speculative phase's per-cycle pairs their room in the smoke's time.
MESH_LAYERS = 12
MESH_BATCHER_NEW_TOKENS = 16
# A step's logits on the mesh against 1 rank's: max|mesh - one| over
# max|one|, a row. The row-parallel partial sums are rounded to bf16 before
# the all-reduce, once a block for out and down, so the logits move.
MESH_LOGIT_TOL = 5e-2
MESH_TIMEOUT_S = 120.0
MESH_INT4_LAYERS = 2  # of 7b's 28
MESH_ANALYZER_SCALE = ANALYZER_BASE_SCALE / 2  # the note's field budgets: 96-128 steps at 12 or 24 layers
MESH_INT4_NEW_TOKENS = 16
MESH_BATCHER_SLOTS, MESH_BATCHER_REQUESTS = 4, 6  # two groups of 2 slots, one stage of 3 lanes each
# 7b's products on a model axis of 2, (K/2, N) of the packed int4 kernels.
MESH_K6_SHAPES = {"q": (1792, 1792), "k_v": (1792, 256), "gate_up": (1792, 9472), "out": (896, 3584),
                  "down": (4736, 3584)}
_RANK_WATCH: contextlib.ExitStack | None = None


def rank_reset() -> None:
    """Launch counts and the peak memory from 0 on this rank. A worker rank
    first starts the plain-call watch (rank 0 runs under ``main``'s)."""
    global _RANK_WATCH
    if torch.distributed.get_rank() != 0 and _RANK_WATCH is None:
        _RANK_WATCH = contextlib.ExitStack()
        _RANK_WATCH.enter_context(watch_plain_writes())
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def rank_counts() -> dict:
    """This rank's launches since ``rank_reset`` and its peak memory."""
    torch.cuda.synchronize()
    return dict(counts(), rank=torch.distributed.get_rank(), device=f"cuda:{torch.cuda.current_device()}",
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30)


def mesh_launch_check(per_rank: list[dict], want: dict[str, int] | list[dict[str, int]], label: str) -> None:
    """Every rank launched each kernel of ``want`` exactly so often (a list:
    one dict a rank, in rank order, where the plan of heads gives the ranks
    different shares), and nothing plain on the card. Raises otherwise."""
    plain = ("quantize_kv_on_card", "update_cache_rows_on_card", "mha_reference_on_card", "reference_backwards")
    for i, got in enumerate(per_rank):
        mine = want[i] if isinstance(want, list) else want
        bad = {k: got[k] for k in mine if got[k] != mine[k]} | {k: got[k] for k in plain if got[k] and k not in mine}
        if bad:
            raise AssertionError(f"mesh {label}: rank {got['rank']} launches {bad}, expected {mine} and no plain")


def mesh_serve(engine: InferenceEngine, clips: np.ndarray, label: str) -> tuple[dict, dict]:
    """One ``generate`` on every rank with the launches counted from 0;
    the line and the recorded call (its ids and completion flags)."""
    mesh = engine.mesh
    mesh.run_all(rank_reset)
    before = mesh.collectives
    calls: list = []
    with recorded_calls(engine, calls):
        lines = serve(engine, clips)
    collectives = mesh.collectives - before
    per_rank = mesh.run_all(rank_counts)
    # The route: graphs on an NCCL mesh (unless ``_plain_decode`` asks for
    # the plain loop on every rank), the plain loop on gloo.
    route = "graph" if mesh.capturable and not engine._plain_decode else "eager"
    routes = [stats["decode_route"] for stats in mesh.run_all(rank_stats, engine)]
    if any(r != route for r in routes):
        raise AssertionError(f"mesh {label}: decode routes {routes} on a {mesh.backend} mesh, expected {route}")
    line = lines[0]
    steps = line["decode_steps"]
    decode_s = line["call_seconds"] - line["prefill_ms"] / 1e3
    prefill_collectives = 2 * engine.config.decoder.num_layers if mesh.model > 1 else 0
    return {"phase": "mesh", "run": label, "shape": mesh.shape, "decode_route": route, "decode_steps": steps,
            "ms_per_step": decode_s * 1e3 / steps if steps else 0.0, "prefill_ms": line["prefill_ms"],
            "collectives": collectives,
            "collectives_per_step": (collectives - prefill_collectives) / steps if steps else 0.0,
            "tokens": [row["tokens"] for row in lines], "complete": [row["complete"] for row in lines],
            "per_rank": per_rank}, calls[0]


def rank_step_logits(engine: InferenceEngine, inputs: dict, rows: list[int], steps: list[int]) -> torch.Tensor:
    """The served model's next-token logits (f32 [len(rows), vocab], on the
    CPU) before token ``steps[i]`` of row ``rows[i]`` of a recorded call
    (``recorded_calls``), teacher-forced on its ids: one batched prefill of
    each such row's prompt block and its first ``steps[i]`` ids into a
    fresh bf16 cache of the model's kv heads (a mesh rank's share). On a
    mesh every rank runs it (``Mesh.run_all``): the prefill's collectives
    are the model's."""
    model, dev = engine.model, engine.device
    prompt, base = np.asarray(inputs["tokens"]), np.asarray(inputs["lengths"])
    lengths = [int(base[r]) + j for r, j in zip(rows, steps)]
    width = 128 * math.ceil(max(lengths) / 128)
    tokens = np.full((len(rows), width), engine.tokenizer.PAD, np.int32)
    for i, (r, j) in enumerate(zip(rows, steps)):
        n = int(base[r])
        tokens[i, :n] = prompt[r, :n]
        tokens[i, n:n + j] = inputs["ids"][r][:j]
    with torch.no_grad():
        cache = init_kv_cache(engine.config.decoder, len(rows), engine.config.video_tokens + width,
                              model.compute_dtype, device=dev, kv_heads=model.decoder.kv_heads)
        logits, _ = model.prefill(engine.preprocess(inputs["frames"][rows]), torch.from_numpy(tokens).to(dev),
                                  cache, torch.tensor(lengths, dtype=torch.int32, device=dev))
    return logits.float().cpu()


def mesh_logit_gaps(engine: InferenceEngine, one: InferenceEngine, call: dict, label: str) -> dict:
    """The mesh engine's logits against the 1-rank engine's on the same
    inputs, at the first decode step and at each row's last one
    (teacher-forced on the 1-rank call's ids; one prefill of both): every
    rank's logits equal (the all-reduced hidden state is one), and
    max|mesh - one| over max|one| a row under ``MESH_LOGIT_TOL``. Raises
    otherwise."""
    ids = [list(map(int, row)) for row in call["ids"]]
    inputs = {"frames": call["frames"], "tokens": np.asarray(call["tokens"]), "lengths": np.asarray(call["lengths"]),
              "ids": ids}
    n = len(ids)
    rows, steps = list(range(n)) * 2, [0] * n + [max(len(row) - 1, 0) for row in ids]
    ranks = engine.mesh.run_all(rank_step_logits, engine, inputs, rows, steps)
    if any(not torch.equal(got, ranks[0]) for got in ranks[1:]):
        raise AssertionError(f"{label}: the ranks' logits differ")
    want = rank_step_logits(one, inputs, rows, steps)
    gaps = (ranks[0] - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)
    out: dict = {"logit_tol": MESH_LOGIT_TOL}
    for name, part in (("first_step", slice(0, n)), ("last_step", slice(n, 2 * n))):
        gap = gaps[part].max().item()
        out[f"{name}_logit_gap_over_max_logit"] = gap
        out[f"{name}_positions"] = steps[part]
        if not gap <= MESH_LOGIT_TOL:
            raise AssertionError(f"{label}: {name} logits on the mesh differ from 1 rank's by {gap} x max|logit| "
                                 f"(tolerance {MESH_LOGIT_TOL})")
    return out


def rank_heads(engine: InferenceEngine) -> tuple[int, int]:
    """This rank's q and kv heads a decoder layer (its plan of heads)."""
    attn = engine.model.decoder.layer_0.attn
    return attn.heads, attn.kv_heads


def mesh_uneven_runs(seed: int, dev: torch.device, mesh, tokenizer, grammar, serving: dict, clips: np.ndarray,
                     rng: np.random.Generator, smi: str) -> list[dict]:
    """Two decoders whose heads the ``model: 2`` axis does not divide, each
    against the 1-rank engine on the same weights and inputs: (i) the
    trained tiny checkpoint (1 q and 1 kv head), bf16 greedy: rank 0 holds
    the q head and attends, rank 1 holds the kv head and launches no
    decoder attention kernel (K1 in its encoder only); its tokens equal 1
    rank's, or part at a printed near tie; (ii) base's width with one kv
    head (each rank 4 q heads over the replicated kv head, its int8 cache
    a copy), 4 layers, int8 weights and KV: logits within ``MESH_LOGIT_TOL``
    x max|logit| of 1 rank's, K1-K3 alike on both ranks. Returns the lines."""
    lines = []
    tiny = base_config(tokenizer.vocab_size, "tiny")
    tiny_serving = dict(max_new_tokens=MESH_NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
                        param_dtype="bfloat16", max_forced_run=2)
    side = tiny.encoder.image_size
    tiny_clips = rng.integers(0, 256, (2, tiny.encoder.num_frames, side, side, 3), dtype=np.uint8)
    kv1 = base_config(tokenizer.vocab_size)
    kv1 = replace(kv1, decoder=replace(kv1.decoder, num_kv_heads=1, num_layers=SERVING_LAYERS))
    for label, cfg, settings, frames in (("tiny_tp2", tiny, tiny_serving, tiny_clips),
                                         ("base_kv1_tp2", kv1, serving, clips)):
        run_start = time.perf_counter()
        engines = []
        for on_mesh in (None, mesh):
            engine = InferenceEngine(cfg, mesh=on_mesh, device=dev, **settings)
            if cfg is tiny:
                engine.restore(TINY_WEIGHTS)
            engine.dfa = grammar
            engines.append(engine)
        one, engine = engines
        calls: list = []
        with recorded_calls(one, calls):
            one.generate(frames, [PROMPT] * len(frames))
        line, call = mesh_serve(engine, frames, label)
        parted = parted_rows(one, calls[0], call["ids"], call["status"], f"mesh {label}")
        steps, layers, enc = line["decode_steps"], cfg.decoder.num_layers, cfg.encoder.num_layers
        heads = mesh.run_all(rank_heads, engine)
        if cfg is tiny:
            gaps = {}
            attends = {"flash_attention": enc + layers, "write_cache_rows": layers,
                       "decode_attention_update": layers * steps, "decode_attention": 0}
            idle = {"flash_attention": enc, "write_cache_rows": 0, "decode_attention_update": 0,
                    "decode_attention": 0}
            want = [attends if q else idle for q, _ in heads]
            if sorted(q for q, _ in heads) != [0, 1] or any(kv != 1 for _, kv in heads):
                raise AssertionError(f"mesh {label}: rank heads {heads}, expected (1, 1) and (0, 1)")
        else:
            gaps = mesh_logit_gaps(engine, one, calls[0], f"mesh {label}")
            want = {"flash_attention": enc + layers, "write_cache_rows": layers * (1 + steps),
                    "decode_attention": layers * steps, "decode_attention_update": 0}
        mesh_launch_check(line["per_rank"], want, label)
        lines.append(dict(line, seconds=time.perf_counter() - run_start, decoder_layers=layers,
                          heads=cfg.decoder.num_heads, kv_heads=cfg.decoder.num_kv_heads,
                          rank_heads=[list(h) for h in heads], tokens_equal_one_rank=call["ids"] == calls[0]["ids"],
                          parted_rows=parted, one_rank_tokens=[len(r) for r in calls[0]["ids"]], **gaps,
                          weights="tiny .npz" if cfg is tiny else "random, seeded",
                          settings={k: settings.get(k) for k in ("param_dtype", "quantize", "kv_quant")}, card=smi))
        del one, engine, engines
        gc.collect()
    return lines


def mesh_k6_readings(seed: int, dev: torch.device, rows: int) -> dict:
    """K6 against its plain version at the five per-rank shapes of 7b on a
    model axis of 2, at the decode step's ``rows``."""
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    return {name: check_int4(gen, dev, rows, k2, n) for name, (k2, n) in MESH_K6_SHAPES.items()}


def mesh_adopt_reading(gen: torch.Generator, dev: torch.device, cfg: VLMConfig, pool_rows: int, lanes: int,
                       park_len: int, cache_len: int) -> dict:
    """K4 at a data group's own pool (``pool_rows`` rows) and stage lanes,
    bit for bit against its plain version."""
    hkv, d = cfg.decoder.num_kv_heads, cfg.decoder.head_dim
    pool_k, pool_v = (torch.randn(pool_rows, hkv, cache_len, d, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2))
    src_k, src_v = (torch.randn(lanes, hkv, park_len, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    rows = torch.randperm(pool_rows, generator=torch.Generator().manual_seed(7))[:lanes].to(torch.int32).to(dev)
    ref_k, ref_v = pool_k.clone(), pool_v.clone()
    adopt_rows(pool_k, src_k, rows, lanes, park_len, pool_v, src_v)
    adopt_rows_reference(ref_k, src_k, rows, lanes, park_len)
    adopt_rows_reference(ref_v, src_v, rows, lanes, park_len)
    torch.cuda.synchronize()
    err = max((pool_k.float() - ref_k.float()).abs().max().item(), (pool_v.float() - ref_v.float()).abs().max().item())
    if err:
        raise AssertionError(f"mesh: adopt_rows at a group's pool differs from its plain version by {err}")
    bound_ms, bound_by = bound(2 * 2 * lanes * hkv * park_len * d * 2, 0)
    valid = rows.long()

    def library_adopt():
        ref_k[valid, :, :park_len] = src_k
        ref_v[valid, :, :park_len] = src_v

    return {"max_abs_err": err, "tol": 0,
            "ms": time_ms(lambda: adopt_rows(pool_k, src_k, rows, lanes, park_len, pool_v, src_v)),
            "plain_ms": time_ms(lambda: (adopt_rows_reference(ref_k, src_k, rows, lanes, park_len),
                                         adopt_rows_reference(ref_v, src_v, rows, lanes, park_len))),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library_adopt),
            "library": "two index_put_ (dst[rows, :, :park_len] = src), k and v",
            "shape": f"group pool bf16 [{pool_rows},{hkv},{cache_len},{d}] x2, {lanes} lanes of {park_len}"}


def mesh_batcher_tokens(engine: InferenceEngine, requests: list, slots: int, depth: int) -> dict[int, list[int]]:
    """The requests through a batcher of ``slots`` slots; on a mesh every
    rank's route is checked (graphs on NCCL, eager on gloo)."""
    batcher = ContinuousBatcher(engine, slots=slots, queue_depth=depth)
    for request in requests:
        batcher.submit(request)
    got = {c.request_id: c.token_ids for c in batcher.run()}
    mesh = engine.mesh
    if mesh is not None:
        route = "graph" if mesh.capturable and not engine._plain_decode else "eager"
        routes = [stats["decode_route"] for stats in mesh.run_all(rank_stats, batcher)]
        if any(r != route for r in routes):
            raise AssertionError(f"mesh batcher: decode routes {routes} on a {mesh.backend} mesh, expected {route}")
    return got


# -- training over a mesh (main path 14) -------------------------------------------
#
# On the mesh phase's two ranks of this card, before it closes their world:
# base at full width, ``TRAIN_MESH_LAYERS`` of its 24 decoder layers and the
# whole 12-layer encoder, seeded random f32 weights, bf16 compute, the BPE
# vocabulary, batch 2 of 1,024 video and 2,048 text positions (prompt masks
# of 256 and 0 positions). (a) ``{"model": 2}``, (b) ``{"data": 2}``, (c) a
# 2-stage pipe at 2 microbatches under GPipe and 1F1B: ``TRAIN_MESH_STEPS``
# steps through ``Trainer.step`` with the launches counted from 0 on every
# rank (``train_mesh_launches``, nothing plain on the card); in the first
# each rank holds the gradients that the step applies, and its loss,
# against the 1-rank trainer's on the same seeded weights and batch (the
# loss within ``TRAIN_MESH_LOSS_TOL`` relative, every leaf within
# ``GRAD_REL_TOL`` x its largest 1-rank gradient); after the last the
# replicated leaves are bit-equal on every rank. (d) GPipe against
# 1F1B at batch 4 and 4 microbatches, one step each, each rank's peak GiB.
# (e) ``ring_attention`` on a 2-rank ``cp`` mesh, q/k/v [2, 8, 4096, 128]
# bf16, causal and not, with gradients, against ``mha_reference`` on the
# whole sequence. (f) ``moe_swiglu`` on a 2-rank ``expert`` mesh, 8 experts
# of hidden 1,024 and MLP 4,096, each rank's 4 resident, f32, with
# gradients, against the dense evaluation. K7a-c are held at the per-rank
# shapes, and K1 at 1F1B's (its no-grad waves attend a microbatch).
TRAIN_MESH_LAYERS = 4
TRAIN_MESH_STEPS = 1  # one step a run keeps the phase inside its 30 s
TRAIN_MESH_TEXT = 2048
TRAIN_MESH_PROMPT = 256
TRAIN_MESH_SEED = 17
TRAIN_MESH_LOSS_TOL = 1e-2  # |mesh - 1 rank| / |1 rank|, the step-1 loss
TRAIN_MESH_TINY_TEXT, TRAIN_MESH_TINY_PROMPT = 224, 64  # the tiny run: 32 video + 224 text positions
RING_SHAPE = (2, 8, 4096, 128)
# bf16 ring against bf16 mha_reference: max|got - want| over max|want|, the
# output and each gradient (JAX's own bf16 ring test holds 3e-2).
RING_TOL = 3e-2
MOE_EXPERTS, MOE_HIDDEN, MOE_MLP, MOE_TOKENS = 8, 1024, 4096, 2048
# f32 experts on two ranks against the dense sum: the order of the sum moves it.
MOE_TOL = 1e-4


def train_mesh_launches(cfg: VLMConfig, per_rank_layers: int, n_micro: int, schedule: str | None,
                        remat: bool = False) -> dict:
    """The launches a step of one rank by the design: K7a-c once an encoder
    layer and once a decoder layer a rank holds (a pipeline stage's once a
    microbatch), K7a once more a decoder layer under GPipe's ``remat`` (the
    recompute); 1F1B's primal forward and recompute wave attend without
    grad, through K1, twice a stage layer a microbatch."""
    dec = per_rank_layers * n_micro
    k7 = cfg.encoder.num_layers + dec
    return {"flash_fwd_lse": k7 + dec * remat, "flash_bwd_dq": k7, "flash_bwd_dkv": k7,
            "flash_attention": 2 * dec if schedule == "1f1b" else 0, "reference_backwards": 0}


def train_mesh_batch(cfg: VLMConfig, batch: int, seed: int, text: int = TRAIN_MESH_TEXT,
                     prompt: int = TRAIN_MESH_PROMPT) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    patches, tokens = synthetic_batch(rng, cfg, batch, text, prompt=make_prompt_sampler("compact"),
                                      prompt_len=prompt)
    prompt_lens = np.array([prompt if i % 2 == 0 else 0 for i in range(batch)], np.int32)
    return patches, tokens, prompt_lens


_ONE_RANK: dict = {}  # a rank's 1-rank reference: batch -> (loss, {leaf: whole gradient})


def rank_release() -> None:
    """Free this rank's 1-rank reference and its cached blocks."""
    _ONE_RANK.clear()
    gc.collect()
    torch.cuda.empty_cache()


def rank_arm(trainer, patches, tokens, prompt_lens) -> None:
    """On every rank, before the mesh's first step: the 1-rank trainer's
    loss and whole gradients on the same seeded weights and batch (drawn on
    this rank's card once a batch and kept), then the launches and the peak
    counted from 0, and the optimizer's ``run`` wrapped to keep the
    gradients that the first step applies (its eager run: on the graph
    route a key's first step is its warm-up, before the capture)."""
    key = (patches.shape, int(np.asarray(tokens).sum()))
    if key not in _ONE_RANK:  # every run starts from the same seeded weights: one reference a batch
        ref = Trainer(trainer.config, trainer.train_config, seed=TRAIN_MESH_SEED, device=trainer.device)
        ref_metrics, ref_grads = ref.loss_and_grads(patches, tokens, prompt_lens)
        _ONE_RANK[key] = (ref_metrics["loss"].item(),
                          dict(zip([n for n, p in ref.model.named_parameters() if p.requires_grad], ref_grads)))
        del ref, ref_grads
        gc.collect()
        torch.cuda.empty_cache()  # the mesh trainer's reserved GiB are its own
    _ONE_RANK["key"] = key
    kept = {}
    run = trainer.optimizer.run

    def kept_run(grads, norm, apply):
        kept.setdefault("grads", grads)
        return run(grads, norm, apply)

    trainer.optimizer.run, trainer.kept = kept_run, kept
    rank_reset()


def rank_grad_check(trainer, step: dict) -> dict:
    """On every rank, after the mesh's first step: the gradients it applied
    (each leaf against the part of the 1-rank trainer's whole gradient that
    this rank holds) and its loss against the 1-rank trainer's."""
    mesh = trainer.mesh
    one_rank_loss, whole = _ONE_RANK[_ONE_RANK["key"]]
    grads = trainer.kept.pop("grads")
    del trainer.optimizer.run, trainer.kept
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    worst, worst_name = 0.0, ""
    for name, got, axis in zip(names, grads, trainer._split):
        want = whole[name]
        if axis == MODEL_AXIS:  # this rank's part by its plan of heads
            ranges = trainer._model_ranges(name, tuple(want.shape))[mesh.model_index]
            want = shard_tensor(want, spec_for_path(tuple(name.split("."))), ranges)
        if not want.numel():  # a rank with no q heads holds empty q and out leaves
            continue
        ratio = ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30)).item()
        if not ratio <= worst:
            worst, worst_name = ratio, name
    return {"rank": mesh.rank, "loss": step["loss"], "one_rank_loss": one_rank_loss, "tokens": step["tokens"],
            "grad_norm": step["grad_norm"], "leaves": len(names), "worst_grad_ratio": worst,
            "worst_grad": worst_name}


def bit_sums(t: torch.Tensor) -> tuple[int, int]:
    """Two integer sums of a tensor's bits (plain and position-weighted,
    int64): equal sums on two ranks mean equal bits."""
    bits = t.detach().contiguous().view(torch.int32).reshape(-1).long()
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return bits.sum().item(), (bits * weights).sum().item()


def rank_replicas(trainer) -> dict:
    """Each leaf's ``bit_sums`` and the axis that splits it; for a k/v leaf
    whose kv heads have several holders, each kv head's columns' sums too."""
    named = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    out = {name: (axis, *bit_sums(p)) for (name, p), axis in zip(named, trainer._split)}
    heads, d = {}, trainer.config.decoder.head_dim
    for i, (dim, _) in trainer._kv.items():
        name, p = named[i]
        for t, j in enumerate(trainer._plan().kv_heads):
            heads[f"{name}[kv head {j}]"] = bit_sums(p.narrow(dim, t * d, d))
    return {"rank": trainer.mesh.rank, "model_index": trainer.mesh.model_index, "sums": out, "kv_heads": heads}


def replicas_equal(per_rank: list[dict]) -> int:
    """The replicated leaves compared across ranks (and a model shard across
    the data groups that hold it, a kv head's columns across its holders);
    raises on a difference. Returns the number of leaves and kv heads
    compared."""
    compared = 0
    held: dict[str, list[tuple[int, tuple]]] = {}
    for rank in per_rank:
        for key, sums in rank["kv_heads"].items():
            held.setdefault(key, []).append((rank["rank"], sums))
    for key, holders in held.items():
        if any(sums != holders[0][1] for _, sums in holders):
            raise AssertionError(f"train_mesh: {key} differs between its holders {holders} after the steps")
        compared += len(holders) > 1
    for rank in per_rank[1:]:
        for name, (axis, *sums) in rank["sums"].items():
            peers = [r for r in per_rank if axis is None or (axis == MODEL_AXIS
                                                              and r["model_index"] == rank["model_index"])]
            for other in peers:
                if other is not rank and other["sums"][name][1:] != tuple(sums):
                    raise AssertionError(f"train_mesh: leaf {name} differs between ranks {other['rank']} and "
                                         f"{rank['rank']} after the steps")
            compared += len(peers) > 1
    return compared


def rank_stats(obj) -> dict:
    """An engine's, a batcher's or a trainer's route stats on this rank."""
    return dict(vars(obj.stats))


def rank_set(obj, name: str, value) -> None:
    """An attribute set on this rank alone (``_plain_decode``, ``_eager_step``)."""
    setattr(obj, name, value)


def train_mesh_run(cfg: VLMConfig, mesh, label: str, tc: TrainConfig, batch: tuple, want: dict,
                   smi: str, steps: int = TRAIN_MESH_STEPS, eager: bool = False) -> tuple[dict, dict, list]:
    """One mesh shape: ``steps`` steps through ``Trainer.step`` (with
    ``eager`` on the eager route, ``_eager_step`` on every rank) with
    launches, collectives, ms and peak GiB, the first step's gradients
    checked after it; the replicas compared after the last. Returns the
    line, each rank's counts and each rank's leaves' bit sums."""
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tc, seed=TRAIN_MESH_SEED, mesh=mesh)
    setup_s = time.perf_counter() - t0
    if eager:
        mesh.run_all(rank_set, trainer, "_eager_step", True)
    mesh.run_all(rank_arm, trainer, *batch)
    before = mesh.collectives
    metrics, step_ms, checks = [], [], None
    for _ in range(steps):
        start = time.perf_counter()
        metrics.append(trainer.step(*batch))
        step_ms.append((time.perf_counter() - start) * 1e3)
        checks = checks or mesh.run_all(rank_grad_check, trainer, metrics[0])
    collectives = mesh.collectives - before
    route = trainer.stats.step_route
    if route != ("graph" if mesh.trains_on_graphs and not eager else "eager"):
        raise AssertionError(f"train_mesh {label}: step route {route} on a {mesh.backend} mesh {mesh.shape}")
    for got in checks:
        gap = abs(got["loss"] - got["one_rank_loss"]) / abs(got["one_rank_loss"])
        got["loss_gap"] = gap
        if not gap <= TRAIN_MESH_LOSS_TOL or not got["worst_grad_ratio"] <= GRAD_REL_TOL:
            raise AssertionError(f"train_mesh {label}: rank {got['rank']} loss gap {gap}, gradient "
                                 f"{got['worst_grad']} at {got['worst_grad_ratio']} x max (tolerances "
                                 f"{TRAIN_MESH_LOSS_TOL}, {GRAD_REL_TOL})")
    per_rank = mesh.run_all(rank_counts)
    launched = [{k: steps * n for k, n in w.items()} for w in want] if isinstance(want, list) else \
        {k: steps * n for k, n in want.items()}
    mesh_launch_check(per_rank, launched, f"train {label}")
    sums = mesh.run_all(rank_replicas, trainer)
    compared = replicas_equal(sums)
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"train_mesh {label}: non-finite metrics {metrics}")
    stats = mesh.run_all(rank_stats, trainer)
    del trainer
    gc.collect()
    # step_ms: Trainer.step on rank 0, from the call to the host's metrics.
    return {"phase": "train_mesh", "run": label, "shape": mesh.shape, "step_route": route,
            "seconds": time.perf_counter() - t0, "setup_seconds": setup_s,
            "grad_check": checks, "loss_tol": TRAIN_MESH_LOSS_TOL, "grad_tol": GRAD_REL_TOL,
            "steps": metrics, "step_ms": step_ms, "collectives_per_step": collectives / steps,
            "replicated_leaves_bit_equal": compared, "per_rank": per_rank, "launches_per_step_per_rank": want,
            "rank_stats": stats, "card": smi}, per_rank, sums


def rank_ring(mesh, causal: bool, shape: tuple) -> dict:
    """``ring_attention`` fwd + bwd on this rank (seeded bf16 inputs, the
    same on every rank); on rank 0 also ``mha_reference`` on the whole
    sequence with the same output gradient, and the gaps."""
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(TRAIN_MESH_SEED)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    inputs = [t.requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = ring_attention(*inputs, mesh, causal=causal)
    grads = torch.autograd.grad(out, inputs, dout)
    torch.cuda.synchronize()
    result = {"rank": mesh.rank, "ms": (time.perf_counter() - start) * 1e3,
              "sums": [t.float().sum().item() for t in (out, *grads)]}
    if mesh.rank == 0:
        want = mha_reference(*inputs, causal=causal)
        want_grads = torch.autograd.grad(want, inputs, dout)
        result["gaps"] = {name: ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                          for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads), (want, *want_grads))}
    return result


def rank_moe(mesh, experts: int, hidden: int, mlp: int, tokens: int) -> dict:
    """``moe_swiglu`` fwd + bwd with this rank's experts resident (f32); on
    rank 0 also the dense evaluation of every expert, and the gaps."""
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(TRAIN_MESH_SEED)
    whole = init_moe_params(gen, hidden, mlp, experts, device=dev)
    x = torch.randn(2, tokens // 2, hidden, generator=gen, device=dev)
    per = experts // mesh.axis_size(EXPERT_AXIS)
    lo = mesh.axis_index(EXPERT_AXIS) * per
    mine = {n: (t if n == "router" else t[lo:lo + per]).clone().requires_grad_() for n, t in whole.items()}
    torch.cuda.synchronize()
    start = time.perf_counter()
    out, aux = moe_swiglu(mine, x, mesh)
    grads = torch.autograd.grad(out.square().mean() + 0.01 * aux, list(mine.values()))
    torch.cuda.synchronize()
    result = {"rank": mesh.rank, "ms": (time.perf_counter() - start) * 1e3, "aux": aux.item(),
              "out_sum": out.sum().item()}
    if mesh.rank == 0:
        dense = {n: t.clone().requires_grad_() for n, t in whole.items()}
        want, want_aux = moe_swiglu(dense, x)
        want_grads = torch.autograd.grad(want.square().mean() + 0.01 * want_aux, list(dense.values()))
        gaps = {"out": ((out - want).abs().max() / want.abs().max()).item(),
                "aux": abs(aux.item() - want_aux.item()) / abs(want_aux.item())}
        for name, g, w in zip(mine, grads, want_grads):
            w = w if name == "router" else w[lo:lo + per]
            gaps[f"d{name}"] = ((g - w).abs().max() / w.abs().max()).item()
        result["gaps"] = gaps
    return result


def train_mesh_phase(seed: int, dev: torch.device, tokenizer, smi: str) -> tuple[list[dict], dict, dict]:
    """Main path 14 (see the constants above) on the running two-rank
    world. Returns the lines, the launches summed over every rank of every
    run and K7a-c's readings at the per-rank shapes."""
    lines, total = [], dict.fromkeys(counts(), 0)
    start = time.perf_counter()
    cfg = base_config(tokenizer.vocab_size)
    cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=TRAIN_MESH_LAYERS))
    layers = cfg.decoder.num_layers
    batch = train_mesh_batch(cfg, 2, seed + 41)
    tc = TrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10, prompt_len=TRAIN_MESH_PROMPT)
    # The tiny preset on model: 2: rank 0 holds its one q head, both ranks
    # its kv head (the plan of heads); 32 video + 224 text positions. Its
    # encoder's 32 positions take K1 and the recompute backward (JAX's
    # route: not a multiple of 128) on both ranks; the decoder's K7a-c run
    # on rank 0 alone.
    tiny = get_preset("tiny")
    tiny_batch = train_mesh_batch(tiny, 2, seed + 45, text=TRAIN_MESH_TINY_TEXT, prompt=TRAIN_MESH_TINY_PROMPT)
    enc = tiny.encoder.num_layers
    tiny_launches = [{"flash_fwd_lse": n, "flash_bwd_dq": n, "flash_bwd_dkv": n, "flash_attention": enc,
                      "reference_backwards": enc, "mha_reference_on_card": enc}
                     for n in (tiny.decoder.num_layers, 0)]
    runs = [("tp2", cfg, {"data": 1, "model": 2}, tc, batch, train_mesh_launches(cfg, layers, 1, None)),
            ("tiny_tp2", tiny, {"data": 1, "model": 2}, replace(tc, prompt_len=TRAIN_MESH_TINY_PROMPT), tiny_batch,
             tiny_launches),
            ("dp2", cfg, {"data": 2, "model": 1}, tc, batch, train_mesh_launches(cfg, layers, 1, None))]
    runs += [(f"pp2_{s}", cfg, "pipe", replace(tc, pp_microbatches=2, pp_schedule=s), batch,
              train_mesh_launches(cfg, layers // 2, 2, s)) for s in ("gpipe", "1f1b")]
    for label, run_cfg, shape, config, run_batch, want in runs:
        mesh = build_pipe_mesh(2, timeout_s=MESH_TIMEOUT_S) if shape == "pipe" else \
            build_mesh(shape, timeout_s=MESH_TIMEOUT_S)
        line, per_rank, _ = train_mesh_run(run_cfg, mesh, label, config, run_batch, want, smi)
        lines.append(line)
        for got in per_rank:
            for name in total:
                total[name] += got[name]

    mesh.run_all(rank_release)

    # (d) Activation memory: GPipe against 1F1B at 4 microbatches.
    wide = train_mesh_batch(cfg, 4, seed + 43)
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        trainer = Trainer(cfg, replace(tc, pp_microbatches=4, pp_schedule=schedule), seed=TRAIN_MESH_SEED, mesh=mesh)
        mesh.run_all(rank_reset)
        t0 = time.perf_counter()
        metrics = trainer.step(*wide)
        ms = (time.perf_counter() - t0) * 1e3
        if trainer.stats.step_route != ("graph" if mesh.trains_on_graphs else "eager"):
            raise AssertionError(f"train_mesh pp2_{schedule}_m4: step route {trainer.stats.step_route} on a "
                                 f"{mesh.backend} pipe")
        per_rank = mesh.run_all(rank_counts)
        mesh_launch_check(per_rank, train_mesh_launches(cfg, layers // 2, 4, schedule), f"train pp2_{schedule}_m4")
        for got in per_rank:
            for name in total:
                total[name] += got[name]
        peaks[schedule] = {"peak_gib": [got["peak_gib"] for got in per_rank], "step_ms": ms, "loss": metrics["loss"]}
        del trainer
        gc.collect()
    if not all(a < b for a, b in zip(peaks["1f1b"]["peak_gib"], peaks["gpipe"]["peak_gib"])):
        raise AssertionError(f"train_mesh: 1F1B's peak is not below GPipe's on every rank: {peaks}")
    lines.append({"phase": "train_mesh", "run": "pp2_memory", "batch": 4, "n_micro": 4, **peaks, "card": smi})

    # (e) Ring attention and (f) expert parallelism on the same two ranks.
    mesh = build_cp_mesh(2, timeout_s=MESH_TIMEOUT_S)
    for causal in (True, False):
        ranks = mesh.run_all(rank_ring, mesh, causal, RING_SHAPE)
        gaps = ranks[0]["gaps"]
        if any(r["sums"] != ranks[0]["sums"] for r in ranks) or not max(gaps.values()) <= RING_TOL:
            raise AssertionError(f"train_mesh ring causal={causal}: gaps {gaps} (tol {RING_TOL}), sums "
                                 f"{[r['sums'] for r in ranks]}")
        lines.append({"phase": "train_mesh", "run": f"ring_causal_{causal}", "shape": mesh.shape,
                      "qkv": list(RING_SHAPE), "gaps_over_max": gaps, "tol": RING_TOL,
                      "ms": [r["ms"] for r in ranks], "card": smi})
    mesh = build_expert_mesh(2, timeout_s=MESH_TIMEOUT_S)
    ranks = mesh.run_all(rank_moe, mesh, MOE_EXPERTS, MOE_HIDDEN, MOE_MLP, MOE_TOKENS)
    gaps = ranks[0]["gaps"]
    if not max(gaps.values()) <= MOE_TOL or len({(r["aux"], r["out_sum"]) for r in ranks}) != 1:
        raise AssertionError(f"train_mesh moe: gaps {gaps} (tol {MOE_TOL}), ranks {ranks}")
    lines.append({"phase": "train_mesh", "run": "moe", "shape": mesh.shape,
                  "experts": MOE_EXPERTS, "hidden": MOE_HIDDEN, "mlp": MOE_MLP, "tokens": MOE_TOKENS,
                  "gaps_over_max": gaps, "tol": MOE_TOL, "ms": [r["ms"] for r in ranks], "card": smi})
    gc.collect()
    torch.cuda.empty_cache()

    # K7a-c at the per-rank shapes: a model rank's 4 q heads over 1 kv head,
    # a data or pipe rank's batch of 1, and a data rank's encoder; K1 at a
    # 1F1B microbatch's (its primal forward and recompute wave).
    gen = torch.Generator(device=dev).manual_seed(seed + 47)
    seq = cfg.video_tokens + TRAIN_MESH_TEXT
    dec, enc = cfg.decoder, cfg.encoder
    readings = {"tp2": check_flash_train(gen, dev, 2, dec.num_heads // 2, dec.num_kv_heads // 2, seq, True),
                "dp2": check_flash_train(gen, dev, 1, dec.num_heads, dec.num_kv_heads, seq, True),
                "dp2_encoder": check_flash_train(gen, dev, 1, enc.num_heads, enc.num_heads, enc.tokens_per_clip,
                                                 False),
                "pp2_1f1b": {"flash_attention": check_flash(gen, dev, 1, dec.num_heads, dec.num_kv_heads, seq,
                                                            causal=True)}}
    lines.append({"phase": "train_mesh_done", "seconds": time.perf_counter() - start, "card": smi})
    return lines, total, readings


def mesh_phase(seed: int, dev: torch.device, tokenizer, grammar, spawned, smi: str) -> tuple[list[dict], dict, dict]:
    """Main path 13 (see the constants above), on the ``{"data": 1, "model":
    2}`` world that ``spawned`` (``in_background(build_mesh, ...)``) waits
    for. Returns the lines, the launches summed over every rank of every
    run, and the kernel readings at the per-rank shapes."""
    lines, readings = [], {}
    total = dict.fromkeys(counts(), 0)

    def add(per_rank: list[dict]) -> None:
        for got in per_rank:
            for name in total:
                total[name] += got[name]

    rng = np.random.default_rng(seed + 13)
    cfg = base_config(tokenizer.vocab_size)
    cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=MESH_LAYERS))
    layers, enc_layers = cfg.decoder.num_layers, cfg.encoder.num_layers
    serving = dict(max_new_tokens=MESH_NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
                   param_dtype="bfloat16", quantize="int8", kv_quant="int8", max_forced_run=2)
    clips = rng.integers(0, 256, (2, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)

    # (a) The 1-rank engine (while the world may still be starting), then the
    # same weights on two model ranks.
    try:
        one = InferenceEngine(cfg, device=dev, **serving)
        one.dfa = grammar
        calls: list = []
        with recorded_calls(one, calls):
            one.generate(clips, [PROMPT] * 2)
    finally:
        t0 = time.perf_counter()
        mesh, spawn_s = spawned()
        spawn_wait_s = time.perf_counter() - t0
    run_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, mesh=mesh, device=dev, **serving)
        engine.dfa = grammar
        engine_s = time.perf_counter() - t0
        found: dict = {}
        with path_decode_inputs(found):
            line, call = mesh_serve(engine, clips, "base_tp2")
        parted = parted_rows(one, calls[0], call["ids"], call["status"], "mesh base_tp2")
        logit_gaps = mesh_logit_gaps(engine, one, calls[0], "mesh base_tp2")
        mesh_launch_check(line["per_rank"], {
            "flash_attention": enc_layers + layers, "write_cache_rows": layers * (1 + line["decode_steps"]),
            "decode_attention": layers * line["decode_steps"], "decode_attention_update": 0, "int4_matmul": 0,
        }, "base_tp2")
        add(line["per_rank"])
        prompt_bucket = engine._prompt_bucket([PROMPT], with_video=True)
        gen = torch.Generator(device=dev).manual_seed(seed + 29)
        readings["flash_attention"] = check_flash(gen, dev, 2, cfg.decoder.num_heads // 2, 1,
                                                  cfg.video_tokens + prompt_bucket, causal=True)
        decode_line = path_decode_readings(seed, found, "mesh")
        lines.append(dict(line, seconds=time.perf_counter() - run_start, backend=mesh.backend, ranks=mesh.size,
                          devices=[str(d) for d in mesh.devices],
                          spawn_seconds=spawn_s, spawn_wait_seconds=spawn_wait_s, engine_seconds=engine_s,
                          decoder_layers=layers,
                          rank_heads=cfg.decoder.num_heads // 2, rank_kv_heads=cfg.decoder.num_kv_heads // 2,
                          parted_rows=parted, one_rank_tokens=[len(r) for r in calls[0]["ids"]], **logit_gaps,
                          card=smi))
        lines.append(decode_line)

        # The analyzer on the same engine: the base (b) settings of the
        # analyzer phase, with the note's fields at half of (b)'s budgets.
        for name, value in (("dfa", engine.wrap_grammar(note_dfa(engine.byte_vocab, scale=MESH_ANALYZER_SCALE))),
                            ("structure_bias", ANALYZER_BASE_BIAS), ("max_new_tokens", ANALYZER_BASE_MAX_NEW),
                            ("temperature", 0.7)):
            setattr(engine, name, value)
        with tempfile.TemporaryDirectory(prefix="vtx_mesh_") as tmp:
            workdir = Path(tmp)
            log = LogLines()
            logger = logging.getLogger("vtx.chip_smoke.mesh")
            logger.handlers, logger.propagate = [log], False
            logger.setLevel(logging.INFO)
            config = analyzer_config(workdir, checkpoint_dir=None)
            analyzer = ContentAnalyzer(config, APICounter(config["system"]["max_api_calls"]), logger, engine=engine)
            short = workdir / "short.npzv"
            write_npzv(short, rng.integers(0, 256, (ANALYZER_CLIP_FRAMES, ANALYZER_FRAME_SIZE, ANALYZER_FRAME_SIZE, 3),
                                           dtype=np.uint8), ANALYZER_CLIP_FPS)
            mesh.run_all(rank_reset)
            run_start = time.perf_counter()
            line, _ = analyzer_run(analyzer, log, short, "mesh_tp2", smi)
            per_rank = mesh.run_all(rank_counts)
            add(per_rank)
            if any(got["decode_attention"] != per_rank[0]["decode_attention"] for got in per_rank):
                raise AssertionError(f"mesh analyzer: ranks ran different decode steps: {per_rank}")
            lines.append(dict(line, phase="mesh", run="analyzer_tp2", seconds=time.perf_counter() - run_start,
                              per_rank=per_rank))
        del analyzer, engine, one
        gc.collect()
        torch.cuda.empty_cache()

        # (b) 7b int4 on the same two ranks: K6 at every decode step of every
        # rank; tokens and logits held to the 1-rank engine as in (a).
        run_start = time.perf_counter()
        cfg7 = base_config(tokenizer.vocab_size, "7b")
        cfg7 = replace(cfg7, decoder=replace(cfg7.decoder, num_layers=MESH_INT4_LAYERS))
        serving7 = dict(serving, quantize="int4", max_new_tokens=MESH_INT4_NEW_TOKENS)
        side = cfg7.encoder.image_size
        clips7 = rng.integers(0, 256, (2, cfg7.encoder.num_frames, side, side, 3), dtype=np.uint8)
        one = InferenceEngine(cfg7, device=dev, **serving7)
        one.dfa = grammar
        calls = []
        with recorded_calls(one, calls):
            one.generate(clips7, [PROMPT] * 2)
        engine = InferenceEngine(cfg7, mesh=mesh, device=dev, **serving7)
        engine.dfa = grammar
        line, call = mesh_serve(engine, clips7, "7b_int4_tp2")
        parted = parted_rows(one, calls[0], call["ids"], call["status"], "mesh 7b_int4_tp2")
        logit_gaps = mesh_logit_gaps(engine, one, calls[0], "mesh 7b_int4_tp2")
        del one
        steps = line["decode_steps"]
        mesh_launch_check(line["per_rank"], {"int4_matmul": 7 * MESH_INT4_LAYERS * steps,
                                             "decode_attention": MESH_INT4_LAYERS * steps}, "7b_int4_tp2")
        add(line["per_rank"])
        shapes = {name: dict(reading, shape=f"x [6, {2 * k2}] @ int4 [{k2}, {n}]")
                  for (name, reading), (k2, n) in zip(mesh_k6_readings(seed, dev, 6).items(),
                                                      MESH_K6_SHAPES.values())}
        readings["int4_matmul"] = shapes
        k6_lines = {name: {key: r[key] for key in ("shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                                    "library_ms") if key in r} for name, r in shapes.items()}
        lines.append(dict(line, seconds=time.perf_counter() - run_start, decoder_layers=MESH_INT4_LAYERS,
                          parted_rows=parted, one_rank_tokens=[len(r) for r in calls[0]["ids"]], **logit_gaps,
                          k6_shapes=k6_lines, card=smi))
        del engine
        gc.collect()

        # A model axis that does not divide the heads, on the same two ranks.
        uneven = mesh_uneven_runs(seed, dev, mesh, tokenizer, grammar, serving, clips, rng, smi)
        for line in uneven:
            add(line["per_rank"])
        lines.extend(uneven)
    except BaseException:
        mesh.close()
        raise
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Two data groups through the batcher (bf16 pool: K1, K2 and K4 in
    # the stage, K5 at every decode step).
    bcfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=SERVING_LAYERS))
    batch = dict(max_new_tokens=MESH_BATCHER_NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
                 param_dtype="bfloat16", quantize="int8", max_forced_run=2)
    requests = [Request(i, rng.integers(0, 256, (cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8),
                        f"{PROMPT}（片段 {i + 1}）") for i in range(MESH_BATCHER_REQUESTS)]
    depth = 2 * MESH_BATCHER_SLOTS
    run_start = t0 = time.perf_counter()
    # The same two ranks (their world is still up): new groups, no new process.
    mesh = build_mesh({"data": 2, "model": 1}, timeout_s=MESH_TIMEOUT_S)
    regroup_s = time.perf_counter() - t0
    try:
        engine = InferenceEngine(bcfg, mesh=mesh, device=dev, **batch)
        engine.dfa = grammar
        found = {}
        mesh.run_all(rank_reset)
        steps_before = engine.stats.decode_steps
        t0 = time.perf_counter()
        with path_decode_inputs(found):
            got = mesh_batcher_tokens(engine, requests, MESH_BATCHER_SLOTS, depth)
        wall = time.perf_counter() - t0
        per_rank = mesh.run_all(rank_counts)
        add(per_rank)
        for rank in per_rank:
            if not rank["adopt_rows"] or not rank["decode_attention_update"] or rank["decode_attention"]:
                raise AssertionError(f"mesh batcher_dp2: rank {rank['rank']} launches {rank}")
        steps = engine.stats.decode_steps - steps_before
        batcher_line = {"phase": "mesh", "run": "batcher_dp2", "shape": mesh.shape, "backend": mesh.backend,
                        "decode_route": "graph" if mesh.capturable else "eager",  # held by mesh_batcher_tokens
                        "devices": [str(d) for d in mesh.devices], "regroup_seconds": regroup_s,
                        "decoder_layers": SERVING_LAYERS, "requests": len(got), "decode_steps": steps,
                        "wall_seconds": wall, "ms_per_step": wall * 1e3 / steps if steps else 0.0,
                        "collectives": mesh.collectives, "per_rank": per_rank, "card": smi}
        batcher_s = time.perf_counter() - run_start
        lines.append(batcher_line)
        lines.append(path_decode_readings(seed, found, "mesh_batcher"))
        del engine
        gc.collect()
        # Main path 14: training over the same two ranks, before their world closes.
        train_lines, trained, readings["train"] = train_mesh_phase(seed, dev, tokenizer, smi)
        lines.extend(train_lines)
        for name in total:
            total[name] += trained[name]
    finally:
        mesh.close()
    # Each group's requests (the stage's lanes in order, split in halves)
    # through a 1-rank batcher of the group's slots and ring.
    ref_start = time.perf_counter()
    one = InferenceEngine(bcfg, device=dev, **batch)
    one.dfa = grammar
    per_group = MESH_BATCHER_REQUESTS // 2
    want = {}
    for g in range(2):
        want.update(mesh_batcher_tokens(one, requests[g * per_group:(g + 1) * per_group], MESH_BATCHER_SLOTS // 2,
                                        depth // 2))
    if got != want:
        differ = sorted(i for i in want if got.get(i) != want[i])
        raise AssertionError(f"mesh batcher_dp2: requests {differ} differ from the 1-rank batcher of their group")
    # The run's seconds: the mesh's sweep and the 1-rank batchers' (the
    # training runs come between them, while the world is still up).
    batcher_line.update(tokens_equal_one_rank_groups=True, seconds=batcher_s + time.perf_counter() - ref_start)
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    park_len = bcfg.video_tokens + 256
    pool_len = 128 * math.ceil((park_len + MESH_BATCHER_NEW_TOKENS + 2 * 3 + 17) / 128)
    readings["adopt_rows"] = mesh_adopt_reading(gen, dev, bcfg, (MESH_BATCHER_SLOTS + depth) // 2, per_group,
                                                park_len, pool_len)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return lines, total, readings


# The shim's fixed-point colour conversion against the numpy decode's float
# one, the largest difference over every (y, u, v): 2, in green, where the
# shim floors the sum of two chroma terms (``tests/test_torch_native_reader.py``).
Y4M_SHIM_TOL = 2


def native_reader_check(workdir: Path, smi: str) -> dict:
    """A ``.y4m`` read on this machine takes the C++ shim's route (the route
    counter) and its frames equal the numpy decode's within ``Y4M_SHIM_TOL``."""
    frames = np.random.default_rng(5).integers(0, 256, (24, 256, 256, 3), dtype=np.uint8)
    path = workdir / "clip.y4m"
    write_y4m(path, frames, fps=8.0)
    before = dict(Y4M_ROUTES)
    t0 = time.perf_counter()
    native = read_frames(path, 16)
    native_s = time.perf_counter() - t0
    if Y4M_ROUTES["native"] != before["native"] + 1:
        raise AssertionError(f"native_reader: the read took the numpy route ({Y4M_ROUTES}, was {before})")
    with mock.patch.object(native_reader, "y4m_decode_frames", lambda data, indices, pooled=False: None):
        t0 = time.perf_counter()
        plain = read_frames(path, 16)
        numpy_s = time.perf_counter() - t0
    diff = int(np.abs(native.astype(int) - plain.astype(int)).max())
    if diff > Y4M_SHIM_TOL or Y4M_ROUTES["numpy"] != before["numpy"] + 1:
        raise AssertionError(f"native_reader: frames differ from the numpy decode by {diff}")
    return {"phase": "native_reader", "route": "native", "routes": dict(Y4M_ROUTES), "max_abs_diff": diff,
            "tol": Y4M_SHIM_TOL,
            "frames": list(native.shape), "native_ms": native_s * 1e3, "numpy_ms": numpy_s * 1e3,
            "library": str(native_reader._lib_path().relative_to(REPO)), "card": smi}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    try:
        with watch_plain_writes():
            run(args.seed)
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


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

    # The kernels build (one nvcc a source) while this thread sets up path
    # 1's engine and the note grammar, which launch no kernel.
    built = in_background(_lib.library)
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
    t3 = time.perf_counter()
    _, library_s = built()
    if _lib.library.cache_info().misses != 1:
        raise AssertionError("setup: a kernel was called while the kernels were building")
    emit({"phase": "build", "nvcc_seconds": _lib.build_seconds, "load_seconds": library_s,
          "wait_seconds": time.perf_counter() - t3, "k6_ptxas": k6_ptxas(_lib.build_log),
          "k3_k5_ptxas": decode_ptxas(_lib.build_log), "k2_ptxas": k2_ptxas(_lib.build_log)})
    ptxas = [line for line in _lib.build_log.splitlines()
             if any(word in line for word in ("Function properties", "registers", "spill", "setmaxnreg", "wgmma"))]
    emit({"phase": "ptxas", "lines": ptxas})
    sass_dir = tempfile.TemporaryDirectory(prefix="vtx_sass_")
    sass_out = Path(sass_dir.name) / "sass.txt"
    sass = start_sass(sass_out)
    emit({"phase": "setup", "engine_seconds": t1 - t0, "grammar_seconds": t2 - t1,
          "grammar_cached_seconds": t3 - t2, "during_build": True,
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
    with sass_dir:
        emit({"phase": "sass", "kernels": kernel_sass(sass, sass_out)})
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
    ran = sum(requests[i]["decode_steps"] + requests[i]["idle_steps"] for i in (0, 2))  # the two calls'
    check_write_routes(served, layers, 2, ran, "serving")
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

    # Main path 14, the decode graphs against the plain per-step loop: base
    # at full width on path 1's engine (4 layers; then at 0.7 from one seed)
    # and at all 24 decoder layers (int8, the note grammar, three requests),
    # the batcher on path 2's engine; 7b int4 follows in path 4.
    t0 = time.perf_counter()
    deep_cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=DECODE_GRAPH_LAYERS))
    emit(decode_graph_line(engine, clips, "base_4", smi, sampled=True))
    t1 = time.perf_counter()
    deep = InferenceEngine(deep_cfg, **dict(serving, max_new_tokens=DECODE_GRAPH_DEEP_TOKENS))
    deep.dfa = engine.dfa
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t1
    emit(dict(decode_graph_line(deep, clips, "base_24", smi), engine_seconds=engine_s,
              seconds=time.perf_counter() - t1))
    del deep
    gc.collect()
    torch.cuda.empty_cache()
    emit(decode_graph_batcher_line(batch_engine, batch_clips, batch_prompts, BATCHER_SLOTS, smi))
    emit({"phase": "decode_graph_done", "seconds": time.perf_counter() - t0})

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

    # Main path 12, speculative decoding on path 1's int8 weights with the
    # trained tiny draft (K1, K2, K4 and K5 for both models, no K3); then K5
    # at every decode shape it ran (W = 6 and W = 1), against the plain
    # versions.
    t0 = time.perf_counter()
    found = {}
    with path_decode_inputs(found):
        spec_lines, spec_launched, spec_k5 = speculative_phase(seed, engine, batch_engine, clips, batch_clips,
                                                               batch_prompts, smi)
    for line in spec_lines:
        emit(line)
    line = path_decode_readings(seed, found, "speculative")
    emit(line)
    note_path_decode(kernels, line)
    kernels["decode_attention_update"].update({f"spec_{name}": reading for name, reading in spec_k5.items()})
    emit({"phase": "speculative_done", "seconds": time.perf_counter() - t0,
          "launches": {name: n for name, n in spec_launched.items() if n}})
    grammar = engine.dfa
    del engine, batch_engine, found
    torch.cuda.empty_cache()

    # Main path 3, training: three base-width steps through K7a-c.
    with tempfile.TemporaryDirectory(prefix="vtx_train_") as workdir:
        train_lines, trained = train_phase(dev, Path(workdir), smi)
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
    # Main path 13's world of two ranks starts meanwhile, in a thread (its
    # rank 1 is a process of its own, seconds from the card); nothing
    # between here and there builds a mesh.
    torch.cuda.empty_cache()
    spawned = in_background(build_mesh, {"data": 1, "model": 2}, devices=[dev, dev], timeout_s=MESH_TIMEOUT_S)
    int4_kernels, int4_served = int4_serving_phase(seed, dev, tokenizer, grammar, smi)
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

    # Main path 13, serving over a mesh of two ranks on this card: base at
    # MESH_LAYERS layers on model 2 (then the analyzer on it), 7b int4 on model 2,
    # two data groups through the batcher; K1-K6 at the per-rank shapes.
    t0 = time.perf_counter()
    mesh_lines, meshed, mesh_readings = mesh_phase(seed, dev, tokenizer, grammar, spawned, smi)
    for line in mesh_lines:
        emit(line)
        if line["phase"] == "path_decode":
            note_path_decode(kernels, line)
    for key, value in mesh_readings["flash_attention"].items():
        kernels["flash_attention"][f"mesh_tp2_{key}"] = value
    for name, reading in mesh_readings["int4_matmul"].items():
        for key in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "library_ms", "shape"):
            if key in reading:
                kernels["int4_matmul"][f"mesh_{name}_{key}"] = reading[key]
    for key, value in mesh_readings["adopt_rows"].items():
        kernels["adopt_rows"][f"mesh_dp2_{key}"] = value
    for shape, results in mesh_readings["train"].items():  # K7a-c at a mesh rank's shapes
        for name, result in results.items():
            for key in ("max_abs_err", "worst_ratio", "bit_identical_runs", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "shape"):
                if key in result:
                    kernels[name][f"mesh_{shape}_{key}"] = result[key]
    with tempfile.TemporaryDirectory(prefix="vtx_y4m_") as workdir:
        emit(native_reader_check(Path(workdir), smi))
    emit({"phase": "mesh_done", "seconds": time.perf_counter() - t0})
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
                "train_launches", "head_dim_96"):
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
                + content_launched[name] + real_launched[name] + qwen_launched[name] + spec_launched[name]
                + meshed[name] for name in served}
    if launches["mha_reference_on_card"] != launches["reference_backwards"]:  # only the recompute backward's
        raise AssertionError(f"plain attention ran {launches['mha_reference_on_card']} times on a CUDA tensor, "
                             f"{launches['reference_backwards']} of them recompute backwards")

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
