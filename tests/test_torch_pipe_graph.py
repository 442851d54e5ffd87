"""The pipe mesh's training step on the graph route over two CPU ranks
(gloo), against the eager route and the JAX package's pipe ``Trainer``.

On the cards an NCCL pipe mesh captures each stage's whole step (the
forward ticks, the schedule's backward ticks, the global norm and AdamW)
as one CUDA graph and replays it (``Mesh.trains_on_graphs``). Here the
ranks are gloo CPU processes, so ``tests/torch_mesh_ranks.py::
graph_stand_in`` makes them take that route all the same (``TapeGraph``
records the capture's aten and c10d ops and replays them). JAX
``tests/test_train.py``'s micro geometry at 4 decoder layers (2 a stage),
float32, batch 4 of 48 text tokens in 2 microbatches, per-row prompt
masks, learning rate 1e-3 (the first update at lr 0). Four cases: GPipe,
1F1B, GPipe with remat, and GPipe with accumulation over 2 micro-steps:

- the graph route's metrics at every step and every rank's leaves after
  the steps equal the eager route's (``_eager_step``) bit for bit; every
  rank takes "graph", one capture a body, then replays;
- both routes against one JAX ``Trainer`` on ``j_build_pipe_mesh(2)``
  (GPipe; accumulation against its own run): the loss within rtol 1e-5,
  the grad norm within 1e-4, the token count exact, and after the steps
  every leaf within 0.1 x lr (``tests/test_torch_train_mesh.py``'s
  tolerances);
- every step moves each rank's launches (K1 and its recompute backward:
  head_dim 32 takes no K7) and collectives by what the eager route's same
  step moves, K1 by the schedule's count (1F1B's two no-grad waves, remat's
  recompute);
- every rank's step body, run with every host read of a tensor refused.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu.models.config import DecoderConfig as JDecoder
from video_transformer_tpu.models.config import EncoderConfig as JEncoder
from video_transformer_tpu.models.config import VLMConfig as JVLM
from video_transformer_tpu.parallel.pipeline_parallel import build_pipe_mesh as j_build_pipe_mesh
from video_transformer_tpu.train.data import synthetic_batch
from video_transformer_tpu.train.trainer import TrainConfig as JTrainConfig
from video_transformer_tpu.train.trainer import Trainer as JTrainer
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig
from video_transformer_tpu_torch.parallel.mesh import build_pipe_mesh
from video_transformer_tpu_torch.train.trainer import TrainConfig, Trainer
from video_transformer_tpu_torch.weights import from_jax_params
import torch_mesh_ranks as ranks
from chip_smoke import rank_set, rank_stats

LR = 1e-3
STEPS = 4  # micro-steps a run: a warm-up and a capture a body, then replays
N_MICRO = 2
LAYERS = 4
STAGES = 2
TC = dict(learning_rate=LR, warmup_steps=1, total_steps=10, pp_microbatches=N_MICRO)
PROMPT_LENS = np.array([16, 0, 8, 30], np.int32)
CASES = {"gpipe": {}, "1f1b": {"pp_schedule": "1f1b"}, "gpipe_remat": {"remat": True},
         "gpipe_accum": {"accum_steps": 2}}


def micro(vlm, enc, dec):
    """JAX ``tests/test_train.py::micro_config``'s geometry, 4 decoder layers."""
    return vlm(name="micro-train",
               encoder=enc(hidden_dim=64, num_layers=1, num_heads=2, head_dim=32, mlp_dim=128, image_size=32,
                           patch_size=16, tubelet_t=2, num_frames=4),
               decoder=dec(vocab_size=512, hidden_dim=64, num_layers=LAYERS, num_heads=2, num_kv_heads=2,
                           head_dim=32, mlp_dim=128, max_seq_len=512), dtype="float32")


CFG = micro(VLMConfig, EncoderConfig, DecoderConfig)
J_CFG = micro(JVLM, JEncoder, JDecoder)


def batches():
    return [synthetic_batch(np.random.default_rng(10 + i), J_CFG, batch=4, text_len=48) for i in range(2)]


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        out.update(flat(value, f"{prefix}{key}.") if isinstance(value, dict) else {prefix + key: value})
    return out


def jax_run(**extra) -> tuple[dict, list[dict], dict]:
    """JAX's pipe trainer (GPipe): its initial weights, its metrics a
    micro-step and its final weights."""
    trainer = JTrainer(J_CFG, j_build_pipe_mesh(STAGES), JTrainConfig(**TC, **extra), seed=0)
    init = jax.tree_util.tree_map(np.asarray, trainer.params)
    data = batches()
    metrics = [trainer.step(*data[i % 2], PROMPT_LENS) for i in range(STEPS)]
    return init, metrics, flat(jax.tree_util.tree_map(np.asarray, trainer.params)["params"])


def whole_leaves(trainer) -> dict:
    """This rank's leaves and, gathered into the 1-rank layout, the whole
    model's (every rank calls it: the gather is a collective)."""
    return {"leaves": ranks.trainer_leaves(trainer)["leaves"], "whole": trainer._whole_state()}


def pipe_run(mesh, init: dict, case: str, eager: bool) -> dict:
    """``STEPS`` micro-steps of ``case`` from JAX's initial weights on one
    route; each step's metrics and each rank's counts moved by it."""
    trainer = Trainer(CFG, TrainConfig(**TC, **CASES[case]), mesh=mesh,
                      model=functools.partial(from_jax_params, init, CFG, device="cpu"))
    mesh.run_all(ranks.take_graph_route, trainer)
    mesh.run_all(rank_set, trainer, "_eager_step", eager)
    data = batches()
    metrics, moved = [], []
    for i in range(STEPS):
        before = mesh.run_all(ranks.rank_counts, mesh)
        metrics.append(trainer.step(*data[i % 2], PROMPT_LENS))
        after = mesh.run_all(ranks.rank_counts, mesh)
        moved.append([{k: a[k] - b[k] for k in a if k != "rank"} for a, b in zip(after, before)])
    out = {"metrics": metrics, "moved": moved, "stats": mesh.run_all(rank_stats, trainer),
           "leaves": mesh.run_all(whole_leaves, trainer)}
    if not eager:
        fresh = Trainer(CFG, TrainConfig(**TC, **CASES[case]), mesh=mesh,
                        model=functools.partial(from_jax_params, init, CFG, device="cpu"))
        out["host_reads"] = mesh.run_all(ranks.body_reads_nothing, fresh, *data[0], PROMPT_LENS)
    return out


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        init, j_metrics, j_final = jax_run()
        _, j_accum, j_accum_final = jax_run(accum_steps=2)
        out = {"jax": {"gpipe": (j_metrics, j_final), "gpipe_accum": (j_accum, j_accum_final)}}
        mesh = build_pipe_mesh(STAGES, ["cpu"] * STAGES, timeout_s=120)
        mesh.run_all(ranks.graph_stand_in, True)
        try:
            for case in CASES:
                out[case] = {route: pipe_run(mesh, init, case, route == "eager") for route in ("graph", "eager")}
        finally:
            mesh.run_all(ranks.graph_stand_in, False)
            mesh.close()
        return out
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


@pytest.mark.parametrize("case", list(CASES))
def test_graph_route_equals_the_eager_route_bit_for_bit(runs, case):
    graph, eager = runs[case]["graph"], runs[case]["eager"]
    assert graph["metrics"] == eager["metrics"]
    for g, e in zip(graph["leaves"], eager["leaves"]):
        assert g["leaves"].keys() == e["leaves"].keys()
        assert all(torch.equal(leaf, e["leaves"][name]) for name, leaf in g["leaves"].items())
    # Each stage holds its own blocks: layers 0-1 on rank 0, 2-3 on rank 1.
    held = [sorted({n.split(".")[1] for n in g["leaves"] if n.startswith("decoder.layer_")}) for g in graph["leaves"]]
    assert held == [["layer_0", "layer_1"], ["layer_2", "layer_3"]]
    bodies = 2 if case == "gpipe_accum" else 1  # "accumulate", "accumulate and apply"
    assert all((s["step_route"], s["graphs_captured"], s["replays"]) == ("graph", bodies, STEPS - bodies)
               for s in graph["stats"])
    assert all((s["step_route"], s["graphs_captured"], s["replays"]) == ("eager", 0, 0) for s in eager["stats"])


@pytest.mark.parametrize("route", ["graph", "eager"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipe_step_equals_jax(runs, case, route):
    """Every schedule against JAX's GPipe run (accumulation against JAX's
    accumulating run): metrics a micro-step, then the whole model."""
    got = runs[case][route]
    want, final = runs["jax"]["gpipe_accum" if case == "gpipe_accum" else "gpipe"]
    assert len(got["metrics"]) == len(want) == STEPS
    for step, (g, w) in enumerate(zip(got["metrics"], want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4, err_msg=f"step {step}")
        assert g["tokens"] == w["tokens"]
    for rank in got["leaves"]:
        state = rank["whole"]
        assert set(state) == set(final)
        for name, leaf in final.items():
            np.testing.assert_allclose(state[name].numpy(), np.asarray(leaf), atol=0.1 * LR, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_a_replay_moves_what_an_eager_step_moves(runs, case):
    """Each micro-step moves every rank's launches and collectives as the
    eager route's same micro-step does; K1 and its recompute backward by the
    schedule's count a stage (head_dim 32: every attention call is K1 with
    the recompute backward, the encoder's too)."""
    graph, eager = runs[case]["graph"], runs[case]["eager"]
    assert graph["moved"] == eager["moved"]
    dec = LAYERS // STAGES * N_MICRO  # a stage's block calls a pass
    enc = CFG.encoder.num_layers
    extra = {"1f1b": 2 * dec, "gpipe_remat": dec}.get(case, 0)  # no-grad waves; remat's recompute
    for step in graph["moved"]:
        for rank in step:
            assert rank["flash_attention"] == enc + dec + extra, (case, rank)
            assert rank["reference_backwards"] == enc + dec, (case, rank)
            assert rank["collectives"] > 0 and rank["decode_attention"] == 0, (case, rank)


@pytest.mark.parametrize("case", list(CASES))
def test_the_pipe_body_reads_nothing_on_any_rank(runs, case):
    got = runs[case]["graph"]["host_reads"]
    assert len(got) == STAGES
    for rank in got:
        assert rank["refused"] and rank["count"] == 2  # two updates, with accumulation too
        assert all(np.isfinite(rank["metrics"])) and rank["metrics"][2] > 0
