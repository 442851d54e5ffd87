"""Serving and training over a mesh of one rank a card (NCCL), against 1 rank.

Run from the repo root on a host with at least 4 visible cards:

    python tools/mesh_cards.py [--seed 0] [--cards 4]

Each rank has a card of its own, so ``parallel/mesh.py::choose_backend``
picks ``nccl``; ``--cards 1`` puts every rank on ``cuda:0`` (gloo), the
same runs and checks on one card. Two ranks: ``base`` at full width and
depth (24 decoder layers, int8 weights and KV, the note grammar, greedy,
32 new tokens) served on ``{"model": 2}`` and on ``{"data": 2}``; then the
``train_mesh`` runs of ``chip_smoke.py`` (base at full width, 4 decoder
layers, batch 2 of 1,024 video + 2,048 text positions) on ``{"model": 2}``,
``{"data": 2}`` and a 2-stage pipe under GPipe and 1F1B. Four ranks: the
same serving and one training step on ``{"model": 4}``, where base's 2 kv
heads are each replicated on two ranks (the plan of heads of
``parallel/sharding.py``). Every run is held to the 1-rank engine or
trainer with ``chip_smoke.py``'s checks (tokens equal or parting at a near
tie, logits within ``MESH_LOGIT_TOL``, the step's loss and gradients,
replicas bit-equal), and each rank's launches against the steps of its
own decode loops (its data group's). Prints one JSON line a run, the
cards' name and power limit (nvidia-smi), and a last line
``{"ok": true, ...}``; exits 1 on a failed check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from video_transformer_tpu_torch.analyzer.schema import note_dfa  # noqa: E402
from video_transformer_tpu_torch.models.bpe import BpeTokenizer  # noqa: E402
from video_transformer_tpu_torch.ops import _lib  # noqa: E402
from video_transformer_tpu_torch.parallel.engine import InferenceEngine  # noqa: E402
from video_transformer_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from video_transformer_tpu_torch.parallel.pipeline_parallel import build_pipe_mesh  # noqa: E402
from video_transformer_tpu_torch.train.trainer import TrainConfig  # noqa: E402

RANKS = 4  # the widest world: model 4 over base's 2 kv heads


def rank_watch_steps(engine: InferenceEngine) -> None:
    """Record on this rank the steps of each of its own decode loops (its
    data group's rows; ``engine.stats`` keeps the groups' maximum)."""
    decode, engine.group_steps = engine._decode, []

    def watched(*args, **kwargs):
        out = decode(*args, **kwargs)
        engine.group_steps.append(out[3])
        return out
    engine._decode = watched


def rank_group_steps(engine: InferenceEngine) -> int:
    """The steps of this rank's decode loops since ``rank_watch_steps``."""
    return sum(engine.group_steps)


def serve_run(mesh, label: str, cfg, serving: dict, grammar, clips, one, one_call, smi: str) -> dict:
    """``base`` on ``mesh`` against the 1-rank engine's recorded call."""
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, mesh=mesh, **serving)
    engine.dfa = grammar
    build_s = time.perf_counter() - t0
    mesh.run_all(rank_watch_steps, engine)
    line, call = cs.mesh_serve(engine, clips, label)
    steps = mesh.run_all(rank_group_steps, engine)
    parted = cs.parted_rows(one, one_call, call["ids"], call["status"], f"cards {label}")
    gaps = cs.mesh_logit_gaps(engine, one, one_call, f"cards {label}") if mesh.model > 1 else {}
    heads = mesh.run_all(cs.rank_heads, engine)
    # Each data group decodes until its own rows end, as its loop counts
    # them (the ranks of a group alike, the longest group's the call's): K3
    # once a layer a step, K2 once a layer a step and a prefill.
    groups = [steps[g * mesh.model:(g + 1) * mesh.model] for g in range(mesh.data)]  # ranks row-major
    if any(len(set(g)) != 1 for g in groups) or max(steps) != line["decode_steps"]:
        raise AssertionError(f"cards {label}: decode steps a rank {steps}, the call's {line['decode_steps']}")
    layers = cfg.decoder.num_layers
    want = [{"flash_attention": cfg.encoder.num_layers + layers, "write_cache_rows": layers * (1 + n),
             "decode_attention": layers * n} for n in steps]
    cs.mesh_launch_check(line["per_rank"], want, f"cards {label}")
    del engine
    return dict(line, backend=mesh.backend, devices=[str(d) for d in mesh.devices], engine_seconds=build_s,
                rank_group_steps=steps, rank_heads=[list(h) for h in heads], parted_rows=parted,
                tokens_equal_one_rank=call["ids"] == one_call["ids"], **gaps, card=smi)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cards", type=int, default=RANKS,
                        help="cards to spread the ranks over (rank i on cuda:i %% cards; 1: every rank on cuda:0, "
                             "gloo)")
    args = parser.parse_args()
    seed, cards = args.seed, args.cards
    if torch.cuda.device_count() < cards:
        raise SystemExit(f"mesh_cards: {torch.cuda.device_count()} cards visible, {cards} needed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(json.dumps({"phase": "cards", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    smi = smi[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _lib.library()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})

    tokenizer = BpeTokenizer.load(cs.TOKENIZER)
    cfg = cs.base_config(tokenizer.vocab_size)
    serving = dict(max_new_tokens=cs.MESH_NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
                   param_dtype="bfloat16", quantize="int8", kv_quant="int8", max_forced_run=2, device=dev)
    rng = np.random.default_rng(seed + 13)
    clips = rng.integers(0, 256, (2, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)
    one = InferenceEngine(cfg, **serving)
    grammar = one.wrap_grammar(note_dfa(one.byte_vocab))
    one.dfa = grammar
    calls: list = []
    with cs.recorded_calls(one, calls):
        one.generate(clips, [cs.PROMPT] * 2)

    train_cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=cs.TRAIN_MESH_LAYERS))
    layers = cs.TRAIN_MESH_LAYERS
    batch = cs.train_mesh_batch(train_cfg, 2, seed + 41)
    tc = TrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10, prompt_len=cs.TRAIN_MESH_PROMPT)

    with cs.watch_plain_writes():
        # Two ranks: serving on model and data, then the training runs (a)-(c).
        t0 = time.perf_counter()
        mesh = build_mesh({"data": 1, "model": 2}, devices=[f"cuda:{i % cards}" for i in range(2)],
                          timeout_s=cs.MESH_TIMEOUT_S)
        cs.emit({"phase": "world", "ranks": 2, "backend": mesh.backend, "seconds": time.perf_counter() - t0})
        try:
            cs.emit(serve_run(mesh, "base_tp2", cfg, serving, grammar, clips, one, calls[0], smi))
            mesh = build_mesh({"data": 2, "model": 1}, timeout_s=cs.MESH_TIMEOUT_S)
            cs.emit(serve_run(mesh, "base_dp2", cfg, serving, grammar, clips, one, calls[0], smi))
            runs = [("tp2", {"data": 1, "model": 2}, tc, cs.train_mesh_launches(train_cfg, layers, 1, None)),
                    ("dp2", {"data": 2, "model": 1}, tc, cs.train_mesh_launches(train_cfg, layers, 1, None))]
            runs += [(f"pp2_{s}", "pipe", replace(tc, pp_microbatches=2, pp_schedule=s),
                      cs.train_mesh_launches(train_cfg, layers // 2, 2, s)) for s in ("gpipe", "1f1b")]
            for label, shape, config, want in runs:
                mesh = build_pipe_mesh(2, timeout_s=cs.MESH_TIMEOUT_S) if shape == "pipe" else \
                    build_mesh(shape, timeout_s=cs.MESH_TIMEOUT_S)
                line, _ = cs.train_mesh_run(train_cfg, mesh, label, config, batch, want, smi)
                cs.emit(dict(line, backend=mesh.backend, devices=[str(d) for d in mesh.devices]))
            mesh.run_all(cs.rank_release)
        finally:
            mesh.close()

        # Four ranks: model 4 over base's 2 kv heads.
        t0 = time.perf_counter()
        mesh = build_mesh({"data": 1, "model": RANKS}, devices=[f"cuda:{i % cards}" for i in range(RANKS)],
                          timeout_s=cs.MESH_TIMEOUT_S)
        cs.emit({"phase": "world", "ranks": RANKS, "backend": mesh.backend, "seconds": time.perf_counter() - t0})
        try:
            cs.emit(serve_run(mesh, "base_tp4", cfg, serving, grammar, clips, one, calls[0], smi))
            line, _ = cs.train_mesh_run(train_cfg, mesh, "tp4", tc, batch,
                                        cs.train_mesh_launches(train_cfg, layers, 1, None), smi)
            cs.emit(dict(line, backend=mesh.backend, devices=[str(d) for d in mesh.devices]))
            mesh.run_all(cs.rank_release)
        finally:
            mesh.close()
    print(json.dumps({"ok": True, "cards": cards, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
