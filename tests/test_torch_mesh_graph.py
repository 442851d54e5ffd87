"""The decode loops and the training step on the graph route over a mesh of
CPU ranks (gloo), against the plain route and the JAX package (CPU).

On the cards an NCCL ``(data, model)`` mesh replays CUDA graphs of whole
decode chunks and of the training step, its collectives inside them
(``Mesh.capturable``). Here the ranks are gloo CPU processes, so
``tests/torch_mesh_ranks.py::graph_stand_in`` makes them take that route
all the same: ``TapeGraph`` stands in for ``torch.cuda.CUDAGraph`` (a
capture records the ops of the captured steps, collectives included, and
a replay runs the record again), and ``DECODE_CHUNK`` is 5 (``SPEC_CHUNK``
2), so that a call warms up, captures and replays. The tiny preset at
float32, greedy, a short grammar:

- ``generate`` on ``{"model": 2}``, ``{"data": 2}`` (a 2-rank world) and
  ``{"data": 2, "model": 2}`` (a 4-rank world): the graph route's tokens,
  flags and steps equal the plain route's (``_plain_decode``) and JAX's
  engine's on the same mesh shape; each rank's collectives and launches
  move by what a step moves times the steps that ran, idle ones included;
- data groups that end after different numbers of chunks (one real clip:
  the other group's rows are padding) gather the right rows;
- a speculative run (a random tiny draft) on ``{"model": 2}`` and the
  batcher (4 slots, device refill and host-driven) on ``{"data": 2,
  "model": 2}``: the graph route's tokens equal the plain route's;
- the trainer's body on ``{"data": 2, "model": 2}`` with accumulation (2
  micro-steps) and a replicated kv head (6 q over 3 kv heads; JAX
  ``tests/test_train.py``'s micro geometry) on the graph route, against
  JAX's ``Trainer`` at ``tests/test_torch_train_mesh.py``'s tolerances and
  against the eager route bit for bit; every rank's body run with every
  host read of a tensor refused;
- the route rule: the engine's "graph" only for NCCL on a ``(data,
  model)`` mesh, the trainer's for NCCL on a ``(data, model)`` or a pipe
  mesh (``tests/test_torch_pipe_graph.py`` holds the pipe's step).
"""

import dataclasses
import functools
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu.models.config import DecoderConfig as JDecoder
from video_transformer_tpu.models.config import EncoderConfig as JEncoder
from video_transformer_tpu.models.config import VLMConfig as JVLM
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.ops.constrained import DfaBuilder as JDfaBuilder
from video_transformer_tpu.parallel.engine import InferenceEngine as JEngine
from video_transformer_tpu.parallel.mesh import build_mesh as j_build_mesh
from video_transformer_tpu.train.data import synthetic_batch
from video_transformer_tpu.train.trainer import TrainConfig as JTrainConfig
from video_transformer_tpu.train.trainer import Trainer as JTrainer
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig, get_preset
from video_transformer_tpu_torch.ops.constrained import DfaBuilder
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.mesh import Mesh, build_mesh
from video_transformer_tpu_torch.parallel.serving import ContinuousBatcher, Request
from video_transformer_tpu_torch.train.trainer import TrainConfig, Trainer
from video_transformer_tpu_torch.weights import flatten_tree, from_jax_params, save_npz
import torch_mesh_ranks as ranks
from chip_smoke import rank_set, rank_stats

MAX_NEW = 24
PROMPTS = ["a", "bb", "ccc"]
TP2 = {"data": 1, "model": 2}
DP2 = {"data": 2, "model": 1}
DP2TP2 = {"data": 2, "model": 2}
LR = 1e-3
TC = dict(learning_rate=LR, warmup_steps=1, total_steps=10, accum_steps=2)
TRAIN_STEPS = 4  # two updates, the first at lr 0
PROMPT_LENS = np.array([16, 0, 8, 30], np.int32)


def tiny(get):
    return dataclasses.replace(get("tiny"), dtype="float32")


def micro(vlm, enc, dec):
    """JAX ``tests/test_train.py::micro_config``'s geometry, 6 q over 3 kv heads."""
    return vlm(name="micro-train",
               encoder=enc(hidden_dim=64, num_layers=1, num_heads=2, head_dim=32, mlp_dim=128, image_size=32,
                           patch_size=16, tubelet_t=2, num_frames=4),
               decoder=dec(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=6, num_kv_heads=3, head_dim=32,
                           mlp_dim=128, max_seq_len=512), dtype="float32")


def dfa(builder):
    return builder().literal('{"title": ').free_string(1, 8).literal(', "tags": ').string_list(1, 6).literal(
        "}").finish()


def frames(n: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, 4, 64, 64, 3), dtype=np.uint8)


def requests(n: int = 7) -> list[Request]:
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(0, 255, (4, 64, 64, 3), dtype=np.uint8), f"analyze {i}") for i in range(n)]


def generate(engine, n: int = 3):
    texts, status, ids = engine.generate(frames(n), PROMPTS[:n], return_status=True, return_tokens=True)
    return texts, status, ids


def batches():
    return [synthetic_batch(np.random.default_rng(10 + i), micro(JVLM, JEncoder, JDecoder), batch=4, text_len=48)
            for i in range(2)]


# -- JAX's side (this process) ----------------------------------------------------


def jax_serving(shape: dict) -> tuple[dict, dict]:
    """JAX's greedy tokens on ``shape`` (3 clips, and 1), and its weights as
    converted-checkpoint leaves."""
    n = shape["data"] * shape["model"]
    engine = JEngine(tiny(j_get_preset), mesh=j_build_mesh(shape, devices=jax.devices()[:n]), dfa=dfa(JDfaBuilder),
                     max_new_tokens=MAX_NEW, temperature=0.0, seed=0, compilation_cache_dir=None)
    leaves = {key.replace(".", "/"): np.asarray(leaf) for key, leaf in flatten_tree(engine.params)}
    return {"three": generate(engine), "one": generate(engine, 1)}, leaves


def jax_training() -> tuple[dict, list[dict]]:
    trainer = JTrainer(micro(JVLM, JEncoder, JDecoder), j_build_mesh(DP2TP2, devices=jax.devices()[:4]),
                       JTrainConfig(**TC), seed=0)
    init = jax.tree_util.tree_map(np.asarray, trainer.params)
    data = batches()
    return init, [trainer.step(*data[i % 2], PROMPT_LENS) for i in range(TRAIN_STEPS)]


# -- the port's side (the ranks) ---------------------------------------------------------


def port_engine(mesh, leaves: dict | None, **kwargs) -> InferenceEngine:
    """The port's engine on ``mesh`` on the graph route, restored from
    JAX's weights (every rank reads the file) or seeded."""
    kwargs = {"max_new_tokens": MAX_NEW, "temperature": 0.0, **kwargs}
    engine = InferenceEngine(tiny(get_preset), dfa=dfa(DfaBuilder), device="cpu", mesh=mesh, **kwargs)
    if leaves is not None:
        with tempfile.TemporaryDirectory(prefix="vtx_mesh_graph_") as tmp:
            engine.restore(save_npz(Path(tmp) / "weights.npz", leaves))
    mesh.run_all(ranks.take_graph_route, engine)
    return engine


def on_route(engine, plain: bool, call):
    """``call()`` on the graph route or the plain route (``_plain_decode``
    on every rank), with every rank's counts and route stats beside it."""
    mesh = engine.mesh
    mesh.run_all(rank_set, engine, "_plain_decode", plain)
    before = mesh.run_all(ranks.rank_counts, mesh)
    stats = mesh.run_all(rank_stats, engine)
    got = call()
    after = mesh.run_all(ranks.rank_counts, mesh)
    now = mesh.run_all(rank_stats, engine)
    mesh.run_all(rank_set, engine, "_plain_decode", False)
    moved = [{k: a[k] - b[k] for k in a if k != "rank"} for a, b in zip(after, before)]
    routes = [{k: n[k] - s[k] if isinstance(n[k], (int, float)) else n[k] for k in n} for n, s in zip(now, stats)]
    return got, moved, routes


def serve_pair(engine, n: int = 3) -> dict:
    """Both routes of one engine from the same start, then what a step
    moves on each rank."""
    graph = on_route(engine, False, lambda: generate(engine, n))
    plain = on_route(engine, True, lambda: generate(engine, n))
    return {"graph": graph, "plain": plain, "step": engine.mesh.run_all(ranks.step_costs, engine)}


def batcher_pair(engine, refill: bool) -> dict:
    def run():
        batcher = ContinuousBatcher(engine, slots=4, prompt_len=16, chunk_steps=6, refill_period=3,
                                    device_refill=refill)
        for request in requests():
            batcher.submit(request)
        got = {c.request_id: (list(c.token_ids), bool(c.complete)) for c in batcher.run()}
        return got, engine.mesh.run_all(rank_stats, batcher)

    return {route: on_route(engine, route == "plain", run)[0] for route in ("graph", "plain")}


def train_run(mesh, init: dict, eager: bool) -> dict:
    cfg = micro(VLMConfig, EncoderConfig, DecoderConfig)
    trainer = Trainer(cfg, TrainConfig(**TC), mesh=mesh, model=functools.partial(from_jax_params, init, cfg,
                                                                                  device="cpu"))
    mesh.run_all(ranks.take_graph_route, trainer)
    mesh.run_all(rank_set, trainer, "_eager_step", eager)
    data = batches()
    before = mesh.run_all(ranks.rank_counts, mesh)
    metrics = [trainer.step(*data[i % 2], PROMPT_LENS) for i in range(TRAIN_STEPS)]
    after = mesh.run_all(ranks.rank_counts, mesh)
    return {"metrics": metrics, "leaves": mesh.run_all(ranks.trainer_leaves, trainer),
            "stats": mesh.run_all(rank_stats, trainer),
            "moved": [{k: a[k] - b[k] for k in a if k != "rank"} for a, b in zip(after, before)]}


def world(devices: int, work) -> dict:
    """``work(first mesh)`` on a world of ``devices`` CPU ranks on the
    graph route's stand-ins, which are put back before the world closes."""
    mesh = build_mesh(DP2TP2 if devices == 4 else TP2, devices=["cpu"] * devices, timeout_s=120)
    mesh.run_all(ranks.graph_stand_in, True)
    try:
        return work(mesh)
    finally:
        mesh.run_all(ranks.graph_stand_in, False)
        mesh.close()


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_runs = {name: jax_serving(shape) for name, shape in (("tp2", TP2), ("dp2", DP2), ("dp2tp2", DP2TP2))}
        init, j_metrics = jax_training()

        def two_ranks(mesh):
            out = {"tp2": serve_pair(port_engine(mesh, jax_runs["tp2"][1]))}
            spec = port_engine(mesh, None, max_forced_run=0)
            spec.attach_draft(tiny(get_preset), spec_tokens=4)
            out["spec"] = serve_pair(spec)
            mesh = build_mesh(DP2, timeout_s=120)  # the running world, new groups
            engine = port_engine(mesh, jax_runs["dp2"][1])
            out["dp2"] = serve_pair(engine)
            out["dp2_one"] = serve_pair(engine, 1)
            return out

        def four_ranks(mesh):
            engine = port_engine(mesh, jax_runs["dp2tp2"][1])
            out = {"dp2tp2": serve_pair(engine), "dp2tp2_one": serve_pair(engine, 1),
                   "batcher": {refill: batcher_pair(engine, refill) for refill in (True, False)},
                   "train": {"graph": train_run(mesh, init, False), "eager": train_run(mesh, init, True)}}
            cfg = micro(VLMConfig, EncoderConfig, DecoderConfig)
            trainer = Trainer(cfg, TrainConfig(**TC), mesh=mesh, model=functools.partial(from_jax_params, init, cfg,
                                                                                          device="cpu"))
            out["host_reads"] = mesh.run_all(ranks.body_reads_nothing, trainer, *batches()[0], PROMPT_LENS)
            return out

        return {"jax": {name: run[0] for name, run in jax_runs.items()}, "j_train": j_metrics,
                **world(2, two_ranks), **world(4, four_ranks)}
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


def check_pair(pair: dict) -> None:
    """The graph route took graphs on every rank and its tokens, flags and
    steps are the plain route's; each rank's collectives and launches moved
    by a step's times the steps that ran (idle ones too) on the graph
    route, by a step's times the live steps on the plain route."""
    (g_out, g_moved, g_routes), (p_out, p_moved, p_routes) = pair["graph"], pair["plain"]
    assert g_out == p_out
    for rank, (gm, pm, gr, pr, step) in enumerate(zip(g_moved, p_moved, g_routes, p_routes, pair["step"])):
        assert gr["decode_route"] == "graph" and pr["decode_route"] == "eager", rank
        assert gr["decode_steps"] == pr["decode_steps"] and pr["idle_steps"] == 0 and pr["replays"] == 0, rank
        for key in ("collectives", "decode_attention"):
            assert gm[key] - pm[key] == step[key] * gr["idle_steps"], (rank, key, gm, pm, step, gr)


@pytest.mark.parametrize("shape", ["tp2", "dp2", "dp2tp2"])
def test_generate_on_the_graph_route_equals_the_plain_route_and_jax(runs, shape):
    pair = runs[shape]
    check_pair(pair)
    assert pair["graph"][0] == runs["jax"][shape]["three"]
    routes = pair["graph"][2]
    assert all(r["graphs_captured"] == 1 and r["replays"] >= 1 for r in routes)  # a capture, then replays
    if shape != "dp2":  # the model ranks hold shares: their collectives are the step's
        assert all(s["collectives"] > 0 for s in pair["step"])


@pytest.mark.parametrize("shape", ["dp2", "dp2tp2"])
def test_data_groups_that_end_at_different_chunks_gather_the_right_rows(runs, shape):
    """One real clip: group 0 decodes its row through chunks and replays,
    group 1's row is padding, frozen from step 0, so its loop stops after
    the warm-up chunk; the gathered rows are JAX's and the plain route's."""
    pair = runs[f"{shape}_one"]
    check_pair(pair)
    assert pair["graph"][0] == runs["jax"][shape]["one"]
    routes = pair["graph"][2]
    model = 2 if shape == "dp2tp2" else 1
    group0, group1 = routes[:model], routes[model:]
    assert all(r["replays"] >= 1 and r["graphs_captured"] == 1 for r in group0)
    # (A rank's decode_steps are the call's, the longest group's.)
    assert all(r["replays"] == 0 and r["graphs_captured"] == 0 and r["idle_steps"] == ranks.STAND_IN_CHUNK
               for r in group1)


def test_speculative_loop_on_the_graph_route_equals_the_plain_route(runs):
    pair = runs["spec"]
    check_pair(pair)
    assert all(r["replays"] >= 1 for r in pair["graph"][2])


@pytest.mark.parametrize("refill", [True, False], ids=["device_refill", "host_driven"])
def test_batcher_on_the_graph_route_equals_the_plain_route(runs, refill):
    (graph, g_stats), (plain, p_stats) = runs["batcher"][refill]["graph"], runs["batcher"][refill]["plain"]
    assert sorted(graph) == list(range(7)) and graph == plain
    assert all(s["decode_route"] == "graph" and s["replays"] >= 1 for s in g_stats)
    assert all(s["decode_route"] == "eager" and s["replays"] == 0 for s in p_stats)


def test_training_body_on_the_graph_route_equals_jax_and_the_eager_route(runs):
    """4 micro-steps (two updates) of the 6 q / 3 kv micro decoder with
    accumulation: the loss within rtol 1e-5 and the grad norm within 1e-4
    of JAX's, the token count exact; the eager route's metrics and every
    rank's leaves bit for bit; K7a-c, the recompute backward and the
    collectives moved alike on both routes (head_dim 32: the recompute
    backward, not K7)."""
    graph, eager = runs["train"]["graph"], runs["train"]["eager"]
    for step, (got, want) in enumerate(zip(graph["metrics"], runs["j_train"])):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4, err_msg=f"step {step}")
        assert got["tokens"] == want["tokens"]
    assert graph["metrics"] == eager["metrics"]
    for g, e in zip(graph["leaves"], eager["leaves"]):
        assert all(torch.equal(g["leaves"][name], leaf) for name, leaf in e["leaves"].items()), g["rank"]
    assert graph["moved"] == eager["moved"] and all(m["collectives"] > 0 and m["reference_backwards"] > 0
                                                   for m in graph["moved"])
    assert [tuple(r["kv_heads"]) for r in graph["leaves"]] == [(0, 0, 1), (1, 2, 2)] * 2
    # Two bodies ("accumulate", "accumulate and apply"), each warmed up, captured, then replayed.
    assert all((s["step_route"], s["graphs_captured"], s["replays"]) == ("graph", 2, TRAIN_STEPS - 2)
               for s in graph["stats"])
    assert all((s["step_route"], s["graphs_captured"]) == ("eager", 0) for s in eager["stats"])


def test_the_training_body_reads_nothing_on_any_rank(runs):
    for rank in runs["host_reads"]:
        assert rank["refused"] and rank["count"] == 2
        assert all(np.isfinite(rank["metrics"])) and rank["metrics"][2] > 0


def test_route_rule():
    """The engine: "graph" only for NCCL on a ``(data, model)`` mesh. The
    trainer: "graph" for NCCL on a ``(data, model)`` or a pipe mesh. Gloo
    and the ``cp`` and ``expert`` meshes keep the plain (eager) routes, and
    ``_plain_decode``/``_eager_step`` ask for them anywhere."""
    cards = [torch.device("cuda", i) for i in range(2)]
    meshes = {
        "nccl_dp_tp": Mesh({"data": 1, "model": 2}, cards, "nccl"),
        "nccl_dp": Mesh({"data": 2, "model": 1}, cards, "nccl"),
        "gloo_dp_tp": Mesh({"data": 1, "model": 2}, [torch.device("cpu")] * 2, "gloo"),
        "nccl_pipe": Mesh({"pipe": 2}, cards, "nccl"),
        "gloo_pipe": Mesh({"pipe": 2}, [torch.device("cuda", 0)] * 2, "gloo"),
        "nccl_cp": Mesh({"cp": 2}, cards, "nccl"),
        "nccl_expert": Mesh({"expert": 2}, cards, "nccl"),
    }
    assert {name: mesh.capturable for name, mesh in meshes.items()} == {
        "nccl_dp_tp": True, "nccl_dp": True, "gloo_dp_tp": False, "nccl_pipe": False, "gloo_pipe": False,
        "nccl_cp": False, "nccl_expert": False}
    assert {name: mesh.trains_on_graphs for name, mesh in meshes.items()} == {
        "nccl_dp_tp": True, "nccl_dp": True, "gloo_dp_tp": False, "nccl_pipe": True, "gloo_pipe": False,
        "nccl_cp": False, "nccl_expert": False}
    engine = InferenceEngine(tiny(get_preset), device="cpu", max_new_tokens=4)
    trainer = Trainer(tiny(get_preset), device="cpu")
    assert (engine._decode_route(), trainer._step_route()) == ("chunked", "eager")  # the CPU, no mesh
    for name, mesh in meshes.items():
        engine.__dict__["mesh"], trainer.mesh = mesh, mesh
        assert engine._decode_route() == ("graph" if mesh.capturable else "plain"), name
        assert trainer._step_route() == ("graph" if name in ("nccl_dp_tp", "nccl_dp", "nccl_pipe") else "eager"), name
        engine._plain_decode = trainer._eager_step = True
        assert (engine._decode_route(), trainer._step_route()) == ("plain", "eager"), name
        engine._plain_decode = trainer._eager_step = False
