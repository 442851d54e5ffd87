"""Training over a mesh of CPU ranks (gloo) against the JAX package's Trainer.

The micro geometry of JAX's ``tests/test_train.py`` (a 1-layer encoder, a
2-layer decoder of width 64 with 2 heads, vocab 512), float32, batch 4 of
48 text tokens with per-row prompt masks (so that the two data groups
count different tokens), learning rate 1e-3. JAX's ``Trainer`` runs on the
same mesh shapes of the 8 CPU devices of ``tests/conftest.py``: a
``{"data": 2, "model": 2}`` mesh, on it the variant with an untied head,
q/k/v biases, accumulation (2 micro-steps) and remat, and a 2-stage pipe
(2 microbatches; the port's GPipe and 1F1B both against JAX's GPipe run,
which JAX's own tests hold equal to its 1F1B). The port's trainers start
from JAX's initial weights: on the 4-rank world through a ``model``
function that each rank calls (``weights.from_jax_params``), on the 2-rank
pipe world through ``restore_checkpoint`` of those weights written in the
1-rank layout. Per step the loss within rtol 1e-5 and the grad norm within
rtol 1e-4 of JAX's, the token count exact; after the steps every
parameter (the mesh's checkpoint, gathered whole) within 0.1 x lr of
JAX's. Also:

- the replicated leaves bit-equal on every rank after the steps (a split
  leaf bit-equal across the data groups);
- the variant on the mesh against the 1-rank port trainer on the same
  weights, at the same tolerances;
- the mesh's checkpoint restored into a 1-rank ``Trainer`` and an
  ``InferenceEngine`` (equal leaves);
- a ``model`` axis that does not divide the heads, against JAX's
  ``Trainer`` on the same mesh shape: the tiny preset's geometry (1 q and
  1 kv head, float32) on the 4-rank ``{"data": 2, "model": 2}`` mesh (one
  model rank holds no q head), 6 q over 3 kv heads on the same mesh (a kv
  copy a q head: kv heads (0, 0, 1) and (1, 2, 2), copies within a rank
  and across ranks), and 8 q over 2 kv heads on a ``model: 4`` mesh built
  on the running world (two holders a kv head); every copy of a kv head's
  columns bit-equal, within a rank and across ranks, after the steps;
- the training CLI under ``torchrun`` with ``--tp 2`` (a 2-head tiny
  decoder) and with ``--pp 2 --pp-micro 2`` (the tiny preset), and
  the batch rounded up to what the mesh divides it into (``--tp`` with
  ``--pp`` exiting is ``tests/test_torch_train_data.py``'s).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import types
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
from video_transformer_tpu.parallel.mesh import build_mesh as j_build_mesh
from video_transformer_tpu.parallel.pipeline_parallel import build_pipe_mesh as j_build_pipe_mesh
from video_transformer_tpu.train.data import synthetic_batch
from video_transformer_tpu.train.trainer import TrainConfig as JTrainConfig
from video_transformer_tpu.train.trainer import Trainer as JTrainer
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig, get_preset
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.mesh import build_mesh, build_pipe_mesh
from video_transformer_tpu_torch.train import run
from video_transformer_tpu_torch.train.trainer import TrainConfig, Trainer
from video_transformer_tpu_torch.weights import from_jax_params
from torch_mesh_ranks import trainer_leaves

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
STEPS = 3
TC = dict(learning_rate=LR, warmup_steps=1, total_steps=10)
PIPE = dict(pp_microbatches=2)
PROMPT_LENS = np.array([16, 0, 8, 30], np.int32)


def micro(vlm, enc, dec, **decoder):
    """JAX ``tests/test_train.py::micro_config``'s geometry."""
    decoder = {"vocab_size": 512, "hidden_dim": 64, "num_layers": 2, "num_heads": 2, "num_kv_heads": 2,
               "head_dim": 32, "mlp_dim": 128, "max_seq_len": 512, **decoder}
    return vlm(name="micro-train",
               encoder=enc(hidden_dim=64, num_layers=1, num_heads=2, head_dim=32, mlp_dim=128, image_size=32,
                           patch_size=16, tubelet_t=2, num_frames=4),
               decoder=dec(**decoder), dtype="float32")


CFG = micro(VLMConfig, EncoderConfig, DecoderConfig)
J_CFG = micro(JVLM, JEncoder, JDecoder)
# The variant: the untied head's vocab shards (a differentiable all-gather),
# the q/k/v bias shards, the accumulated norm over split leaves and remat
# replaying the blocks' collectives.
UNTIED = micro(VLMConfig, EncoderConfig, DecoderConfig, tied_embeddings=False, qkv_bias=True)
J_UNTIED = micro(JVLM, JEncoder, JDecoder, tied_embeddings=False, qkv_bias=True)
VARIANT = dict(accum_steps=2, remat=True)
VARIANT_STEPS = 4  # two updates, the first at lr 0
# Decoders whose heads the model axis does not divide: (mesh, port config, JAX config).
TP4 = {"data": 1, "model": 4}
UNEVEN = {
    "tiny_dp2tp2": ({"data": 2, "model": 2}, dataclasses.replace(get_preset("tiny"), dtype="float32"),
                    dataclasses.replace(j_get_preset("tiny"), dtype="float32")),
    # Neither divides the other: each rank holds a kv copy a q head, rank 0
    # kv heads (0, 0, 1) and rank 1 (1, 2, 2).
    "6q3kv_dp2tp2": ({"data": 2, "model": 2}, micro(VLMConfig, EncoderConfig, DecoderConfig, num_heads=6,
                                                    num_kv_heads=3),
                     micro(JVLM, JEncoder, JDecoder, num_heads=6, num_kv_heads=3)),
    "8q2kv_tp4": (TP4, micro(VLMConfig, EncoderConfig, DecoderConfig, num_heads=8, num_kv_heads=2),
                  micro(JVLM, JEncoder, JDecoder, num_heads=8, num_kv_heads=2)),
}


def batches(config=J_CFG):
    return [synthetic_batch(np.random.default_rng(10 + i), config, batch=4, text_len=48) for i in range(STEPS)]


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        out.update(flat(value, f"{prefix}{key}.") if isinstance(value, dict) else {prefix + key: value})
    return out


def jax_run(mesh, config=J_CFG, n: int = STEPS, **extra) -> tuple[dict, list[dict], dict]:
    """JAX's initial weights, its metrics a step and its final weights."""
    trainer = JTrainer(config, mesh, JTrainConfig(**TC, **extra), seed=0)
    init = to_np(trainer.params)
    data = batches(config)
    metrics = [trainer.step(*data[i % STEPS], PROMPT_LENS) for i in range(n)]
    return init, metrics, flat(to_np(trainer.params)["params"])


def write_checkpoint(variables: dict, root: Path) -> Path:
    """JAX's weights as a port checkpoint in the 1-rank layout."""
    target = root / "params_0"
    target.mkdir(parents=True)
    state = {k: v.detach() for k, v in from_jax_params(variables, CFG, device="cpu").state_dict().items()}
    torch.save(state, target / "params.pt")
    return target


def read_checkpoint(path: Path) -> dict:
    return torch.load(path / "params.pt", map_location="cpu", weights_only=True)


def steps(trainer, n: int = STEPS, config=J_CFG) -> list[dict]:
    data = batches(config)
    return [trainer.step(*data[i % STEPS], PROMPT_LENS) for i in range(n)]


def uneven_run(mesh, case: str, init: dict, root: Path) -> dict:
    """The case's trainer on ``mesh`` from JAX's initial weights: metrics a
    step, every rank's leaves and the checkpoint."""
    _, cfg, j_cfg = UNEVEN[case]
    trainer = Trainer(cfg, TrainConfig(**TC), mesh=mesh, model=functools.partial(from_jax_params, init, cfg,
                                                                                  device="cpu"))
    out = {"metrics": steps(trainer, config=j_cfg)}
    out["ranks"] = mesh.run_all(trainer_leaves, trainer)
    out["checkpoint"] = trainer.save_checkpoint(root / case)
    return out


def dp_tp_world(init: dict, variant_init: dict, uneven_init: dict, root: Path) -> dict:
    out: dict = {}
    mesh = build_mesh({"data": 2, "model": 2}, ["cpu"] * 4, timeout_s=120)
    try:
        out["shape"], out["backend"] = mesh.shape, mesh.backend
        for case in ("tiny_dp2tp2", "6q3kv_dp2tp2"):
            out[case] = uneven_run(mesh, case, uneven_init[case], root)
        trainer = Trainer(CFG, TrainConfig(**TC), mesh=mesh,
                          model=functools.partial(from_jax_params, init, CFG, device="cpu"))
        out["metrics"] = steps(trainer)
        out["ranks"] = mesh.run_all(trainer_leaves, trainer)
        out["checkpoint"] = trainer.save_checkpoint(root / "dp2tp2")
        trainer = Trainer(UNTIED, TrainConfig(**TC, **VARIANT), mesh=mesh,
                          model=functools.partial(from_jax_params, variant_init, UNTIED, device="cpu"))
        out["variant"] = steps(trainer, VARIANT_STEPS)
        out["variant_checkpoint"] = trainer.save_checkpoint(root / "variant")
        out["variant_ranks"] = mesh.run_all(trainer_leaves, trainer)
        # A model: 4 mesh on the running world: new groups over the same ranks.
        mesh = build_mesh(TP4, timeout_s=120)
        out["8q2kv_tp4"] = uneven_run(mesh, "8q2kv_tp4", uneven_init["8q2kv_tp4"], root)
    finally:
        mesh.close()
    return out


def pipe_world(start: Path, root: Path) -> dict:
    out: dict = {}
    mesh = build_pipe_mesh(2, ["cpu"] * 2, timeout_s=120)
    try:
        for schedule in ("gpipe", "1f1b"):
            trainer = Trainer(CFG, TrainConfig(**TC, **PIPE, pp_schedule=schedule), mesh=mesh, seed=5)
            trainer.restore_checkpoint(start)
            out[schedule] = {"restored_step": trainer.step_count, "metrics": steps(trainer),
                             "ranks": mesh.run_all(trainer_leaves, trainer)}
            out[schedule]["checkpoint"] = trainer.save_checkpoint(root / schedule)
    finally:
        mesh.close()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("vtx_train_mesh")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        j_mesh = j_build_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
        init, j_dp, j_dp_final = jax_run(j_mesh)
        variant_init, j_variant, j_variant_final = jax_run(j_mesh, J_UNTIED, VARIANT_STEPS, **VARIANT)
        j_pipe = jax_run(j_build_pipe_mesh(2), **PIPE)[1:]
        j_uneven = {case: jax_run(j_build_mesh(shape, devices=jax.devices()[:4]), j_cfg)
                    for case, (shape, _, j_cfg) in UNEVEN.items()}
        start = write_checkpoint(init, root / "start")
        one = Trainer(UNTIED, TrainConfig(**TC, **VARIANT), device="cpu",
                      model=from_jax_params(variant_init, UNTIED, device="cpu"))
        one_variant = (steps(one, VARIANT_STEPS), {k: v.detach().clone() for k, v in one.model.state_dict().items()})
        return {"jax": {"dp2tp2": (j_dp, j_dp_final), "variant": (j_variant, j_variant_final), "pipe": j_pipe,
                        **{case: run[1:] for case, run in j_uneven.items()}},
                "one_variant": one_variant,
                "dp2tp2": dp_tp_world(init, variant_init, {case: run[0] for case, run in j_uneven.items()}, root),
                "pipe": pipe_world(start, root)}
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


def check_metrics(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4, err_msg=f"step {step}")
        assert g["tokens"] == w["tokens"]


def check_params(state: dict, want: dict) -> None:
    assert set(state) == set(want)
    for name, leaf in want.items():
        np.testing.assert_allclose(state[name].numpy(), np.asarray(leaf), atol=0.1 * LR, rtol=0, err_msg=name)


def check_replicas(ranks: list[dict]) -> None:
    """Whole leaves bit-equal on every rank; a split leaf bit-equal on the
    ranks that hold the same part (the data groups of a model index); the
    columns of a kv head bit-equal on every rank that holds the head."""
    d = ranks[0]["head_dim"]
    for name in ranks[0]["kv_leaves"]:
        heads: dict[int, torch.Tensor] = {}
        for rank in ranks:
            for t, j in enumerate(rank["kv_heads"]):
                part = rank["leaves"][name][..., t * d:(t + 1) * d]
                assert j not in heads or torch.equal(part, heads[j]), (name, j, rank["rank"])
                heads.setdefault(j, part)
    for rank in ranks[1:]:
        for name, leaf in rank["leaves"].items():
            split, other = rank["split"][name], ranks[0]
            same_part = [r for r in ranks if r["model_index"] == rank["model_index"]][0]
            if split is None:
                assert torch.equal(leaf, other["leaves"][name]), (name, rank["rank"])
            elif split == "model":
                assert torch.equal(leaf, same_part["leaves"][name]), (name, rank["rank"], same_part["rank"])
    assert any(r["split"][n] for r in ranks for n in r["split"])


def test_data_and_model_axes_equal_jax(worlds):
    out = worlds["dp2tp2"]
    assert out["shape"] == {"data": 2, "model": 2} and out["backend"] == "gloo"
    want, final = worlds["jax"]["dp2tp2"]
    check_metrics(out["metrics"], want)
    assert out["metrics"][0]["tokens"] < 4 * 48  # the prompt masks
    check_params(read_checkpoint(out["checkpoint"]), final)


@pytest.mark.parametrize("case", list(UNEVEN))
def test_model_axis_that_does_not_divide_the_heads_equals_jax(worlds, case):
    """JAX's ``Trainer`` on the same mesh shape and weights: the loss, the
    grad norm (a replicated kv head counted once) and the parameters after
    the steps (each kv head's gradient summed over its holders)."""
    out = worlds["dp2tp2"][case]
    want, final = worlds["jax"][case]
    check_metrics(out["metrics"], want)
    check_params(read_checkpoint(out["checkpoint"]), final)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipe_trainer_equals_jax(worlds, schedule):
    out = worlds["pipe"][schedule]
    want, final = worlds["jax"]["pipe"]
    assert out["restored_step"] == 0
    check_metrics(out["metrics"], want)
    check_params(read_checkpoint(out["checkpoint"]), final)


@pytest.mark.parametrize("world", ["dp2tp2", "variant", "gpipe", "1f1b", *UNEVEN])
def test_replicated_leaves_stay_bit_equal(worlds, world):
    if world in ("gpipe", "1f1b"):
        ranks = worlds["pipe"][world]["ranks"]
    elif world in UNEVEN:
        ranks = worlds["dp2tp2"][world]["ranks"]
        assert ranks[0]["kv_leaves"] and len(ranks) == 4
        if world == "6q3kv_dp2tp2":  # two copies of a kv head on each rank, compared below
            assert [tuple(r["kv_heads"]) for r in ranks] == [(0, 0, 1), (1, 2, 2)] * 2
    else:
        ranks = worlds["dp2tp2"]["ranks" if world == "dp2tp2" else "variant_ranks"]
    assert len(ranks) == (2 if world in ("gpipe", "1f1b") else 4)
    check_replicas(ranks)


def test_untied_head_biases_accumulation_and_remat_on_the_mesh_equal_jax(worlds):
    """The variant on the 4-rank mesh against JAX's ``Trainer`` on the same
    mesh shape and weights: per micro-step metrics, then the parameters."""
    out = worlds["dp2tp2"]
    want, final = worlds["jax"]["variant"]
    check_metrics(out["variant"], want)
    check_params(read_checkpoint(out["variant_checkpoint"]), final)
    ranks = out["variant_ranks"]
    assert ranks[0]["split"]["decoder.lm_head"] == "model" and ranks[0]["split"]["decoder.layer_0.attn.q.bias"]


def test_untied_head_biases_accumulation_and_remat_on_the_mesh_equal_one_rank(worlds):
    """The same run against the 1-rank port trainer on the same weights."""
    got, (want, state) = worlds["dp2tp2"]["variant"], worlds["one_variant"]
    check_metrics(got, want)
    check_params(read_checkpoint(worlds["dp2tp2"]["variant_checkpoint"]), {k: v.numpy() for k, v in state.items()})


def test_mesh_checkpoint_restores_on_one_rank_and_in_the_engine(worlds):
    path = worlds["dp2tp2"]["checkpoint"]
    saved = read_checkpoint(path)
    assert path.name == f"params_{STEPS}"
    one = Trainer(CFG, device="cpu", seed=9)
    one.restore_checkpoint(path)
    assert one.step_count == STEPS
    assert all(torch.equal(v, saved[k]) for k, v in one.model.state_dict().items())
    engine = InferenceEngine(CFG, device="cpu", max_new_tokens=2)
    engine.restore(path)
    assert all(torch.equal(v, saved[k]) for k, v in engine.model.state_dict().items())


# -- the CLI ------------------------------------------------------------------

TP_TINY = '''import sys
from dataclasses import replace
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.train import run

def two_heads(name):  # the tiny preset's decoder at 2 heads of 64: --tp 2 splits them
    cfg = get_preset(name)
    return replace(cfg, decoder=replace(cfg.decoder, num_heads=2, num_kv_heads=2, head_dim=64))

run.get_preset = two_heads
sys.exit(run.main())
'''


CLI_FLAGS = {"tp2": ["--tp", "2"], "pp2": ["--pp", "2", "--pp-micro", "2"]}


def torchrun(root: Path, target: list[str], flags: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", *target,
           "--preset", "tiny", "--device", "cpu", "--steps", "2", "--batch", "2", "--text-len", "224",
           "--prompt-len", "0", "--out", str(root / "ckpt"), "--log-dir", str(root / "logs"), *flags]
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory) -> dict[str, tuple[Path, int, str]]:
    """Both CLI runs, started together: each case's directory, exit code and
    the end of its stderr."""
    procs = {}
    for case, flags in CLI_FLAGS.items():
        root = tmp_path_factory.mktemp(f"vtx_cli_{case}")
        if case == "tp2":
            script = root / "tp_tiny.py"
            script.write_text(TP_TINY, encoding="utf-8")
            target = [str(script)]
        else:
            target = ["-m", "video_transformer_tpu_torch.train.run"]
        procs[case] = (root, torchrun(root, target, flags))
    out = {}
    for case, (root, proc) in procs.items():
        try:
            _, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        out[case] = (root, proc.returncode, stderr[-4000:])
    return out


@pytest.mark.parametrize("case", list(CLI_FLAGS))
def test_cli_trains_over_a_mesh_under_torchrun(cli_runs, case):
    root, code, stderr = cli_runs[case]
    assert code == 0, stderr
    log = (root / "logs" / "train.log").read_text(encoding="utf-8")
    shape = "{'data': 1, 'model': 2}" if case == "tp2" else "{'pipe': 2}"
    assert f"mesh: {shape}" in log and "event=train_complete steps=2" in log, log
    state = read_checkpoint(root / "ckpt" / "params_2")
    assert "decoder.layer_1.attn.q.kernel" in state and all(torch.isfinite(v).all() for v in state.values())


@pytest.mark.parametrize("flags, shape, divisor", [(["--tp", "1"], {"data": 3, "model": 1}, 3),
                                                   (["--pp", "2", "--pp-micro", "4"], {"pipe": 2}, 4)],
                         ids=["data3", "pp2_micro4"])
def test_cli_rounds_the_batch_up_to_the_mesh(monkeypatch, flags, shape, divisor):
    """As JAX's CLI: the batch rounds up to ``data`` or to ``--pp-micro``, and
    the mesh is logged (the mesh's ranks themselves are the torchrun tests')."""
    built = []

    class Shaped:
        def __init__(self, axes):
            self.shape, self.data = dict(axes), axes.get("data", 1)
            built.append(self.shape)

    monkeypatch.setattr(run, "build_mesh", lambda axes, devices: Shaped({"data": 3, **axes}))
    monkeypatch.setattr(run, "build_pipe_mesh", lambda n, devices: Shaped({"pipe": n}))
    logged = []
    logger = types.SimpleNamespace(info=logged.append)
    args = run.build_parser().parse_args(["--device", "cpu", "--batch", "5", *flags])
    run.build_train_mesh(args, logger)
    assert built == [shape] and args.batch == 2 * divisor  # 5 rounded up
    assert f"batch rounded up to {2 * divisor} (divisor {divisor})" in logged and f"mesh: {shape} preset=tiny" in logged
