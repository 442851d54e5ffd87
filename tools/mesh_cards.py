"""Serving and training over a mesh of one rank a card (NCCL), against 1 rank
and on both routes.

Run from the repo root on a host with at least 4 visible cards:

    python tools/mesh_cards.py [--seed 0] [--cards 4] [--only pipe]

Each rank has a card of its own, so ``parallel/mesh.py::choose_backend``
picks ``nccl``, and the mesh's steps replay as CUDA graphs with their
collectives inside them (``Mesh.capturable``, for training
``Mesh.trains_on_graphs``); ``--cards 1`` puts every rank on ``cuda:0``
(gloo: the plain routes), the same runs and checks on one card, but for
the full-depth pipe, whose ranks each also hold a 1-rank reference
trainer of the whole model at batch 4 (it needs a card a rank). Two
ranks: ``base`` at full width and depth (24 decoder layers, int8 weights
and KV, the note grammar, greedy, ``NEW_TOKENS`` new tokens,
so that a call warms up, captures and replays) served on ``{"model": 2}``
and on ``{"data": 2}``, and a greedy speculative run on ``{"model": 2}``
(the trained tiny checkpoint as the draft, bf16 caches); then the
``train_mesh`` runs of ``chip_smoke.py`` (base at full width, 4 decoder
layers, batch 2 of 1,024 video + 2,048 text positions) on ``{"model":
2}`` and ``{"data": 2}`` for ``TRAIN_STEPS`` steps whose learning rate
changes, and the pipe at full depth (24 decoder layers, 12 a stage; batch
4 of the same positions in ``PIPE_MICRO`` = 4 microbatches, so that a K7
call is [1, 8, 3072, 128]) on ``{"pipe": 2}`` under GPipe, 1F1B and GPipe
with remat. Four ranks: the same serving on ``{"model": 4}`` (base's 2 kv
heads each replicated on two ranks, the plan of heads of
``parallel/sharding.py``) and on ``{"data": 2, "model": 2}``, one training
step on ``{"model": 4}``, and the full-depth pipe on ``{"pipe": 4}`` (6
layers a stage) under GPipe and 1F1B. ``--only pipe`` runs the pipe's
training runs alone.

Every serving run decodes on the graph route, then from the same start on
the plain route (``_plain_decode`` on every rank): on each rank the tokens,
completion flags and live steps of each of its decode loops must be equal
bit for bit, and its launches must be its own loops' steps (live and idle)
times a step's kernels. The ``{"model": 2}``, ``{"data": 2}`` and pipe
training runs step on the graph route, then from the same seeded start on
the eager route (``_eager_step`` on every rank): every metric of every
step and every leaf on every rank bit for bit, and each rank's launches
as ``chip_smoke.train_mesh_launches`` predicts for its stage. Every run is
held to the 1-rank engine or trainer with ``chip_smoke.py``'s checks
(tokens equal or parting at a near tie, logits within ``MESH_LOGIT_TOL``,
the step's loss and gradients, replicas bit-equal). Each route prints ms a step (serving: a
second graph call, of replays only), the busy share (the kernels' ms of a
profiled replay or step, NCCL's given apart, over the ms a step), capture
seconds, graphs, replays, and each rank's peak and reserved GiB.
Prints one JSON line a run and one for each world's close (its
seconds), the cards' name and power limit (nvidia-smi), the links between
the cards (``nvidia-smi topo -m``), and a last line
``{"ok": true, ...}``; exits 1 on a failed check.
"""

from __future__ import annotations

import argparse
import json
import statistics
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
NEW_TOKENS = 64  # four chunks of DECODE_CHUNK (16): a warm-up, a capture, replays
SPEC_NEW_TOKENS = 32  # the speculative run: chunks of 4 cycles
TRAIN_STEPS = 3  # a warm-up and a capture, then replays; the learning rate moves each step
PIPE_MICRO = 4  # the full-depth pipe's microbatches (of one row each)
PIPE_RUNS = {2: (("gpipe", False), ("1f1b", False), ("gpipe", True)), 4: (("gpipe", False), ("1f1b", False))}


def leave(mesh, ranks: int) -> None:
    """Close ``mesh``'s world (every rank releases its graphs, then all
    leave) and print the seconds it took."""
    t0 = time.perf_counter()
    mesh.close()
    cs.emit({"phase": "left", "ranks": ranks, "seconds": time.perf_counter() - t0})


def rank_watch_steps(engine: InferenceEngine) -> None:
    """Record on this rank each of its own decode loops (its data group's
    rows; ``engine.stats`` keeps the groups' maximum): live steps, each
    row's tokens up to its position, and its completion flag."""
    decode, engine.group_loops = engine._decode, []

    def watched(*args, **kwargs):
        out = decode(*args, **kwargs)
        tokens, out_pos, complete, steps = out[:4]
        rows = [row[:n] for row, n in zip(tokens.cpu().tolist(), out_pos.cpu().tolist())]
        engine.group_loops.append((steps, rows, complete.cpu().tolist()))
        return out
    engine._decode = watched


def rank_loops(engine: InferenceEngine) -> dict:
    """This rank's decode loops since the last call, its route stats, and
    then the loops forgotten."""
    loops, engine.group_loops = engine.group_loops, []
    return {"loops": loops, "stats": dict(vars(engine.stats))}


def kernel_ms(fn) -> tuple[float, float]:
    """The kernels' ms that torch.profiler (device activity) records over
    ``fn``: all of them, and NCCL's (whose kernels also wait for the other
    ranks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3
    return total, nccl


def rank_replay_readings(engine: InferenceEngine) -> dict:
    """On this rank (every rank at once: their collectives meet), the graph
    of the engine's last key replayed past its loop's end (frozen steps:
    the kernels a live replay runs): ms a step by CUDA events around the
    replays, and the kernels' ms a step of one profiled replay, all and
    NCCL's."""
    graph = engine._graphs[next(reversed(engine._graphs))].graph
    replay_ms = cs.time_ms(graph.replay, warmup=1, reps=2, rounds=3) / graph.n
    total, nccl = kernel_ms(graph.replay)
    return {"replay_ms_per_step": replay_ms, "kernel_ms_per_step": total / graph.n,
            "nccl_kernel_ms_per_step": nccl / graph.n}


def rank_train_readings(trainer, batch: tuple) -> dict:
    """One step on this rank's route (every rank at once), timed, then one
    under the profiler: wall ms, the kernels' ms, NCCL's."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.step(*batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - start) * 1e3
    total, nccl = kernel_ms(lambda: trainer.step(*batch))
    return {"wall_ms": wall, "kernel_ms": total, "nccl_kernel_ms": nccl, "busy_share": total / wall}


def topology() -> str:
    """``nvidia-smi topo -m``: the link between each pair of cards."""
    return subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True, timeout=60).stdout.strip()


def route_serve(engine: InferenceEngine, clips: np.ndarray, label: str, plain: bool) -> tuple[dict, dict, list]:
    """One ``generate`` on every rank on the graph route or (``plain``) the
    plain route, with launches counted from 0; the line, the recorded call
    and each rank's loops and route stats."""
    mesh = engine.mesh
    mesh.run_all(cs.rank_set, engine, "_plain_decode", plain)
    mesh.run_all(rank_loops, engine)  # forget earlier loops
    before = mesh.run_all(cs.rank_stats, engine)
    line, call = cs.mesh_serve(engine, clips, f"{label}_{'plain' if plain else 'graph'}")
    ranks = mesh.run_all(rank_loops, engine)
    mesh.run_all(cs.rank_set, engine, "_plain_decode", False)
    for rank, was in zip(ranks, before):
        now = rank["stats"]
        rank["moved"] = {k: now[k] - was[k] for k in cs.ROUTE_STATS}
        rank["live_steps"] = sum(loop[0] for loop in rank["loops"])
        rank["launched_steps"] = rank["live_steps"] + rank["moved"]["idle_steps"]
    return line, call, ranks


def serve_run(mesh, label: str, cfg, serving: dict, grammar, clips, one, one_call, smi: str,
              draft=None) -> dict:
    """``cfg`` on ``mesh`` on both routes: the graph route twice (a first
    call that warms up and captures, then a call of replays), then the
    plain route. Each rank is held to itself across the calls (every loop's
    live steps, each row's tokens and flag) and to its own loops' launches
    (live and idle steps); the tokens against the 1-rank engine's recorded
    call."""
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, mesh=mesh, **serving)
    engine.dfa = grammar
    if draft is not None:
        engine.attach_draft(draft, checkpoint=cs.TINY_WEIGHTS, spec_tokens=cs.SPEC_TOKENS)
    build_s = time.perf_counter() - t0
    mesh.run_all(rank_watch_steps, engine)
    runs = {"graph_first": route_serve(engine, clips, label, plain=False),
            "graph": route_serve(engine, clips, label, plain=False)}
    # (On gloo both routes are the plain loop: no graph to replay.)
    readings = mesh.run_all(rank_replay_readings, engine) if mesh.capturable else None
    runs["plain"] = route_serve(engine, clips, label, plain=True)
    _, plain_call, plain_ranks = runs["plain"]
    for name, (_, call, ranks) in runs.items():
        if (call["ids"], call["status"]) != (plain_call["ids"], plain_call["status"]):
            raise AssertionError(f"cards {label}: the {name} call's tokens differ from the plain route's")
        for rank, plain_rank in zip(ranks, plain_ranks):
            if rank["loops"] != plain_rank["loops"]:
                raise AssertionError(f"cards {label}: rank {ranks.index(rank)}'s loops on the {name} call differ "
                                     f"from the plain route's: steps {[loop[0] for loop in rank['loops']]} / "
                                     f"{[loop[0] for loop in plain_rank['loops']]}")
            moved = rank["moved"]
            # The first call captures (then replays), the second replays only.
            want = {"graph_first": (mesh.capturable, mesh.capturable), "graph": (False, mesh.capturable),
                    "plain": (False, False)}[name]
            if (bool(moved["graphs_captured"]), bool(moved["replays"])) != want or \
                    (name == "plain" and moved["idle_steps"]):
                raise AssertionError(f"cards {label}: the {name} call's route stats {moved}")
    call = runs["graph"][1]
    parted = cs.parted_rows(one, one_call, call["ids"], call["status"], f"cards {label}")
    gaps = cs.mesh_logit_gaps(engine, one, one_call, f"cards {label}") if mesh.model > 1 and draft is None else {}
    heads = mesh.run_all(cs.rank_heads, engine)
    layers, enc = cfg.decoder.num_layers, cfg.encoder.num_layers
    routes = {}
    for name, (line, _, ranks) in runs.items():
        # Each data group decodes until its own rows end, as its loops count
        # them (the ranks of a group alike): a step's kernels times the steps
        # each rank launched, live and idle; the prefill's K1 and K2.
        for i, (got, rank) in enumerate(zip(line["per_rank"], ranks)):
            n = rank["launched_steps"]
            if draft is not None:
                cs.check_spec_routes(got, cfg, draft, [True], n, f"cards {label} {name} rank {i}")
            else:
                cs.mesh_launch_check([got], {"flash_attention": enc + layers, "write_cache_rows": layers * (1 + n),
                                             "decode_attention": layers * n}, f"cards {label} {name}")
        group_steps = [rank["live_steps"] for rank in ranks]
        groups = [group_steps[g * mesh.model:(g + 1) * mesh.model] for g in range(mesh.data)]  # ranks row-major
        if any(len(set(g)) != 1 for g in groups) or max(group_steps) != line["decode_steps"]:
            raise AssertionError(f"cards {label}: decode steps a rank {group_steps}, the call's "
                                 f"{line['decode_steps']}")
        launched = max(rank["launched_steps"] for rank in ranks)
        ms_launched = line["ms_per_step"] * line["decode_steps"] / launched
        routes[name] = {
            "decode_route": line["decode_route"], "ms_per_step": line["ms_per_step"],
            "ms_per_launched_step": ms_launched,
            "capture_s": [rank["moved"]["capture_seconds"] for rank in ranks],
            "graphs_captured": [rank["moved"]["graphs_captured"] for rank in ranks],
            "replays": [rank["moved"]["replays"] for rank in ranks],
            "idle_steps": [rank["moved"]["idle_steps"] for rank in ranks], "rank_live_steps": group_steps,
            "peak_gib": [got["peak_gib"] for got in line["per_rank"]],
            "peak_reserved_gib": [got["peak_reserved_gib"] for got in line["per_rank"]],
            "collectives_per_step": line["collectives_per_step"], "prefill_ms": line["prefill_ms"]}
        if readings is not None and name != "graph_first":
            # Busy share: the kernels' ms of a step (NCCL's included, which
            # also wait for the other ranks) over the call's ms a launched step.
            routes[name]["busy_share"] = [r["kernel_ms_per_step"] / ms_launched for r in readings]
            routes[name]["busy_share_without_nccl"] = [
                (r["kernel_ms_per_step"] - r["nccl_kernel_ms_per_step"]) / ms_launched for r in readings]
    del engine
    return {"phase": "mesh_cards", "run": label, "shape": mesh.shape, "backend": mesh.backend,
            "devices": [str(d) for d in mesh.devices], "engine_seconds": build_s, "decoder_layers": cfg.decoder.num_layers,
            "draft": None if draft is None else "tiny .npz", "max_new_tokens": serving["max_new_tokens"],
            "decode_steps": runs["graph"][0]["decode_steps"], "tokens": runs["graph"][0]["tokens"],
            "complete": runs["graph"][0]["complete"], "routes_equal": True, "routes": routes,
            "replay_readings": readings, "rank_heads": [list(h) for h in heads], "parted_rows": parted,
            "tokens_equal_one_rank": call["ids"] == one_call["ids"], **gaps, "card": smi}


def train_pair(train_cfg, mesh, label: str, tc: TrainConfig, batch: tuple, want: dict, smi: str) -> dict:
    """``TRAIN_STEPS`` steps on the graph route, then on the eager route from
    the same seeded start: metrics and every rank's leaves bit for bit, each
    route's ms a step and a profiled step's busy share on every rank."""
    lines, sums = {}, {}
    for route in ("graph", "eager"):
        line, _, sums[route] = cs.train_mesh_run(train_cfg, mesh, f"{label}_{route}", tc, batch, want, smi,
                                                 steps=TRAIN_STEPS, eager=route == "eager")
        lines[route] = line
    graph, eager = lines["graph"], lines["eager"]
    if graph["steps"] != eager["steps"] or [r["sums"] for r in sums["graph"]] != [r["sums"] for r in sums["eager"]]:
        differ = sorted({name for g, e in zip(sums["graph"], sums["eager"]) for name in g["sums"]
                         if g["sums"][name] != e["sums"][name]})
        raise AssertionError(f"cards train {label}: the graph route parts from the eager route: metrics "
                             f"{graph['steps']} / {eager['steps']}, leaves {differ[:8]} ({len(differ)})")
    routes = {}
    for route, line in lines.items():
        stats = line["rank_stats"]
        routes[route] = {"step_route": line["step_route"], "step_ms": line["step_ms"],
                         "steady_step_ms": statistics.median(line["step_ms"][1:]),
                         "capture_s": [s["capture_seconds"] for s in stats],
                         "graphs_captured": [s["graphs_captured"] for s in stats],
                         "replays": [s["replays"] for s in stats],
                         "peak_gib": [got["peak_gib"] for got in line["per_rank"]],
                         "peak_reserved_gib": [got["peak_reserved_gib"] for got in line["per_rank"]],
                         "collectives_per_step": line["collectives_per_step"], "grad_check": line["grad_check"]}
    # One timed and one profiled step a route on every rank, each on a
    # trainer of its own after its key's first step.
    for route in ("graph", "eager"):
        trainer = cs.Trainer(train_cfg, tc, seed=cs.TRAIN_MESH_SEED, mesh=mesh)
        mesh.run_all(cs.rank_set, trainer, "_eager_step", route == "eager")
        trainer.step(*batch)  # the key's warm-up (and on the graph route its capture)
        routes[route]["profiled"] = mesh.run_all(rank_train_readings, trainer, batch)
        del trainer
    mesh.run_all(cs.rank_release)
    return {"phase": "mesh_cards", "run": f"train_{label}", "shape": mesh.shape, "backend": mesh.backend,
            "devices": [str(d) for d in mesh.devices], "steps": TRAIN_STEPS, "metrics": graph["steps"],
            "learning_rate_moves": True, "routes_equal": True, "routes": routes,
            "launches_per_step_per_rank": want, "card": smi}


def pipe_runs(stages: int, cfg, tc: TrainConfig, batch: tuple, smi: str):
    """The full-depth pipe on ``stages`` ranks (a mesh on the running world
    a run), each of ``PIPE_RUNS[stages]`` through ``train_pair``; returns
    the last mesh."""
    for schedule, remat in PIPE_RUNS[stages]:
        mesh = build_pipe_mesh(stages, timeout_s=cs.MESH_TIMEOUT_S)
        label = f"pp{stages}_{schedule}" + ("_remat" if remat else "")
        want = cs.train_mesh_launches(cfg, cfg.decoder.num_layers // stages, PIPE_MICRO, schedule, remat)
        config = replace(tc, pp_microbatches=PIPE_MICRO, pp_schedule=schedule, remat=remat)
        cs.emit(dict(train_pair(cfg, mesh, label, config, batch, want, smi), decoder_layers=cfg.decoder.num_layers,
                     batch=len(batch[1]), n_micro=PIPE_MICRO, remat=remat))
    return mesh


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cards", type=int, default=RANKS,
                        help="cards to spread the ranks over (rank i on cuda:i %% cards; 1: every rank on cuda:0, "
                             "gloo)")
    parser.add_argument("--only", choices=["all", "pipe"], default="all",
                        help="pipe: the full-depth pipe's training runs alone")
    args = parser.parse_args()
    seed, cards, everything = args.seed, args.cards, args.only == "all"
    if torch.cuda.device_count() < cards:
        raise SystemExit(f"mesh_cards: {torch.cuda.device_count()} cards visible, {cards} needed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(json.dumps({"phase": "cards", "nvidia_smi": smi, "topology": topology().splitlines(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    smi = smi[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _lib.library()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})

    tokenizer = BpeTokenizer.load(cs.TOKENIZER)
    cfg = cs.base_config(tokenizer.vocab_size)
    draft = cs.base_config(tokenizer.vocab_size, "tiny")
    serving = dict(max_new_tokens=NEW_TOKENS, temperature=0.0, seed=seed, tokenizer=tokenizer,
                   param_dtype="bfloat16", quantize="int8", kv_quant="int8", max_forced_run=2, device=dev)
    spec_serving = dict(serving, max_new_tokens=SPEC_NEW_TOKENS)
    rng = np.random.default_rng(seed + 13)
    clips = rng.integers(0, 256, (2, cfg.encoder.num_frames, 256, 256, 3), dtype=np.uint8)
    calls: list = []
    if everything:
        one = InferenceEngine(cfg, **serving)
        grammar = one.wrap_grammar(note_dfa(one.byte_vocab))
        one.dfa = grammar
        with cs.recorded_calls(one, calls):
            one.generate(clips, [cs.PROMPT] * 2)
        one_spec = InferenceEngine(cfg, **spec_serving)
        one_spec.dfa = grammar
        one_spec.attach_draft(draft, checkpoint=cs.TINY_WEIGHTS, spec_tokens=cs.SPEC_TOKENS)
        with cs.recorded_calls(one_spec, calls):
            one_spec.generate(clips, [cs.PROMPT] * 2)

    train_cfg = replace(cfg, decoder=replace(cfg.decoder, num_layers=cs.TRAIN_MESH_LAYERS))
    layers = cs.TRAIN_MESH_LAYERS
    batch = cs.train_mesh_batch(train_cfg, 2, seed + 41)
    pipe_batch = cs.train_mesh_batch(cfg, 4, seed + 43)
    tc = TrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10, prompt_len=cs.TRAIN_MESH_PROMPT)
    per_step = cs.train_mesh_launches(train_cfg, layers, 1, None)

    with cs.watch_plain_writes():
        # Two ranks: serving on model and data, the speculative run, then the training runs.
        t0 = time.perf_counter()
        mesh = build_mesh({"data": 1, "model": 2}, devices=[f"cuda:{i % cards}" for i in range(2)],
                          timeout_s=cs.MESH_TIMEOUT_S)
        cs.emit({"phase": "world", "ranks": 2, "backend": mesh.backend, "capturable": mesh.capturable,
                 "seconds": time.perf_counter() - t0})
        try:
            if everything:
                cs.emit(serve_run(mesh, "base_tp2", cfg, serving, grammar, clips, one, calls[0], smi))
                cs.emit(serve_run(mesh, "spec_tp2", cfg, spec_serving, grammar, clips, one_spec, calls[1], smi,
                                  draft=draft))
                mesh = build_mesh({"data": 2, "model": 1}, timeout_s=cs.MESH_TIMEOUT_S)
                cs.emit(serve_run(mesh, "base_dp2", cfg, serving, grammar, clips, one, calls[0], smi))
                for label, shape in (("tp2", {"data": 1, "model": 2}), ("dp2", {"data": 2, "model": 1})):
                    mesh = build_mesh(shape, timeout_s=cs.MESH_TIMEOUT_S)
                    cs.emit(train_pair(train_cfg, mesh, label, tc, batch, per_step, smi))
            mesh = pipe_runs(2, cfg, tc, pipe_batch, smi)
        finally:
            leave(mesh, 2)

        # Four ranks: model 4 over base's 2 kv heads, data 2 x model 2, and the pipe.
        t0 = time.perf_counter()
        mesh = build_mesh({"data": 1, "model": RANKS}, devices=[f"cuda:{i % cards}" for i in range(RANKS)],
                          timeout_s=cs.MESH_TIMEOUT_S)
        cs.emit({"phase": "world", "ranks": RANKS, "backend": mesh.backend, "capturable": mesh.capturable,
                 "seconds": time.perf_counter() - t0})
        try:
            if everything:
                cs.emit(serve_run(mesh, "base_tp4", cfg, serving, grammar, clips, one, calls[0], smi))
                mesh = build_mesh({"data": 2, "model": 2}, timeout_s=cs.MESH_TIMEOUT_S)
                cs.emit(serve_run(mesh, "base_dp2tp2", cfg, serving, grammar, clips, one, calls[0], smi))
                mesh = build_mesh({"data": 1, "model": RANKS}, timeout_s=cs.MESH_TIMEOUT_S)
                line, _, _ = cs.train_mesh_run(train_cfg, mesh, "tp4", tc, batch, per_step, smi)
                cs.emit(dict(line, backend=mesh.backend, devices=[str(d) for d in mesh.devices]))
                mesh.run_all(cs.rank_release)
            mesh = pipe_runs(RANKS, cfg, tc, pipe_batch, smi)
        finally:
            leave(mesh, RANKS)
    print(json.dumps({"ok": True, "cards": cards, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
