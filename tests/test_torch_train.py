"""The port's training path against the JAX package's, on the CPU.

Same seeds, same numpy inputs, tiny preset in float32:

- the prompt templates (the JSON copy against ``config/prompts.yaml``), the
  prompt sampler, ``_pack_row`` and ``synthetic_batch`` give identical
  strings and arrays;
- the learning-rate schedule, the global-norm clip and MultiSteps
  accumulation give optax's values;
- the teacher-forced logits and ``distillation_loss`` (per-row prompt mask)
  match JAX's on the same weights (``weights.from_jax_params``);
- the slice as a whole: Trainer steps from the same JAX parameters match
  the JAX ``Trainer`` on a one-device ("data", "model") mesh, per step and in
  every parameter afterwards, with and without remat plus accumulation;
- the CLI runs end to end on the CPU, checkpoints round-trip, and the
  mesh options build their meshes (training over them:
  ``tests/test_torch_train_mesh.py``).

Tolerances are stated beside each check.
"""

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_transformer_tpu.analyzer.schema import note_dfa as j_note_dfa
from video_transformer_tpu.contracts.timefmt import format_seconds as j_format_seconds
from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu.parallel.mesh import build_mesh
from video_transformer_tpu.train import run as j_run
from video_transformer_tpu.train.data import synthetic_batch as j_synthetic_batch
from video_transformer_tpu.train.trainer import TrainConfig as JTrainConfig
from video_transformer_tpu.train.trainer import Trainer as JTrainer
from video_transformer_tpu.train.trainer import distillation_loss as j_distillation_loss
from video_transformer_tpu.train.trainer import make_optimizer as j_make_optimizer
from video_transformer_tpu_torch.analyzer.prompts import load_prompts
from video_transformer_tpu_torch.analyzer.schema import note_dfa
from video_transformer_tpu_torch.contracts.timefmt import format_seconds
from video_transformer_tpu_torch.models.bpe import BpeTokenizer
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.quant import quantize_decoder_int8
from video_transformer_tpu_torch.models.tokenizer import ByteTokenizer
from video_transformer_tpu_torch.parallel.mesh import Mesh
from video_transformer_tpu_torch.train import run
from video_transformer_tpu_torch.train.data import synthetic_batch
from video_transformer_tpu_torch.train.trainer import (
    AdamW,
    TrainConfig,
    Trainer,
    distillation_loss,
    global_norm,
    lr_schedule,
)
from video_transformer_tpu_torch.weights import cast_weights, from_jax_params, random_params
from torch_mesh_ranks import stage_layers

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOKENIZER = REPO / "data" / "tokenizers" / "bpe-zh-2048.json"
TEXT_LEN = 224  # + 32 tiny video tokens = 256 positions: the decoder takes the K7 route


def configs():
    return replace(j_get_preset("tiny"), dtype="float32"), replace(get_preset("tiny"), dtype="float32")


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_vars():
    j_cfg, _ = configs()
    return to_np(JVideoLM(j_cfg).init_variables(jax.random.PRNGKey(0)))


def batch(seed: int, prompt_len: int = 64):
    cfg = get_preset("tiny")
    rng = np.random.default_rng(seed)
    patches, tokens = synthetic_batch(rng, cfg, 2, TEXT_LEN, prompt=run.make_prompt_sampler("compact"),
                                      prompt_len=prompt_len)
    return patches, tokens, np.array([prompt_len, 16], np.int32)


# -- data ---------------------------------------------------------------------


def test_prompt_json_copy_equals_the_yaml():
    want = yaml.safe_load((REPO / "config" / "prompts.yaml").read_text(encoding="utf-8"))
    assert load_prompts() == {str(k): str(v) for k, v in want.items()}


@pytest.mark.parametrize("seconds", [0, 59.9, 61, 3599, 3600, 7199.5, 86399])
def test_format_seconds_matches_jax(seconds):
    assert format_seconds(seconds) == j_format_seconds(seconds)


@pytest.mark.parametrize("profile", ["compact", "spec", "mixed"])
def test_prompt_sampler_matches_jax(profile):
    ours, theirs = run.make_prompt_sampler(profile), j_run.make_prompt_sampler(profile)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(12):
        assert ours(rng_a) == theirs(rng_b)


def test_pack_row_matches_jax():
    tok = BpeTokenizer.load(TOKENIZER)
    note = '{"title": "梯度下降精讲", "one_sentence_summary": "学习率控制收敛速度"}'
    for prompt, prompt_len in ((None, 0), (run.make_prompt_sampler("compact"), 256), ("分析", 128)):
        rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
        j_prompt = j_run.make_prompt_sampler("compact") if callable(prompt) else prompt
        ours = run._pack_row(tok, tok.encode, note, 384, prompt, prompt_len, rng_a)
        theirs = j_run._pack_row(tok, tok.encode, note, 384, j_prompt, prompt_len, rng_b)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]


@pytest.mark.parametrize("mode", ["templated", "dfa", "bytes", "prompted"])
def test_synthetic_batch_matches_jax(mode):
    """Identical arrays from the same seed (exact)."""
    j_cfg, cfg = configs()
    kwargs, j_kwargs = {}, {}
    if mode == "dfa":
        kwargs, j_kwargs = {"templated": False, "dfa": note_dfa(512)}, {"templated": False, "dfa": j_note_dfa(512)}
    elif mode == "bytes":
        kwargs = j_kwargs = {"templated": False}
    elif mode == "prompted":
        kwargs = {"prompt": run.make_prompt_sampler("mixed"), "prompt_len": 96}
        j_kwargs = {"prompt": j_run.make_prompt_sampler("mixed"), "prompt_len": 96}
    ours = synthetic_batch(np.random.default_rng(7), cfg, 3, 400, **kwargs)
    theirs = j_synthetic_batch(np.random.default_rng(7), j_cfg, 3, 400, **j_kwargs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- optimizer ----------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(1, 10), (5, 40), (100, 10_000), (3, 3)])
def test_lr_schedule_matches_optax(warmup, total):
    """Within rtol 1e-5 of optax's schedule at every count: both evaluate in
    float32 (the cosine argument alone carries ~1e-6 relative error), the
    port on a count tensor, as its optimizer does on the device."""
    cfg = TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1), 3e-5)
    ours = lr_schedule(cfg)
    assert ours(0) == 0.0
    for count in list(range(0, 2 * warmup + 3)) + [total // 2, total - 1, total, total + 7]:
        np.testing.assert_allclose(ours(count), float(want(count)), rtol=1e-5, atol=1e-12, err_msg=str(count))


@pytest.mark.parametrize("accum", [1, 3])
def test_optimizer_matches_optax(accum):
    """Clip, AdamW and MultiSteps against the JAX package's make_optimizer
    on the same gradients, half of them above the clip norm: f32 rounding
    only (atol 1e-6 on parameters of order 1, after updates of order 1e-2)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=8, accum_steps=accum)
    opt = j_make_optimizer(JTrainConfig(**cfg))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = opt.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    ours = AdamW(t_params.values(), TrainConfig(**cfg))
    for step in range(4 * accum):
        scale = 0.05 if step % 2 else 3.0  # global norm ~0.4 or ~20: clip on every other step
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
        np.testing.assert_allclose(
            float(global_norm([torch.from_numpy(g) for g in grads.values()])),
            float(optax.global_norm(grads)), rtol=1e-6,
        )
        updates, j_state = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        applied = ours.update([torch.from_numpy(grads[k]) for k in t_params])
        assert applied == ((step + 1) % accum == 0)
        for k in shapes:
            np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(j_params[k]), atol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert ours.count == 4


# -- model and loss -----------------------------------------------------------


def test_teacher_forced_logits_match_jax(jax_vars):
    """f32 logits [B, Nv + St, V] within 1e-4 (two layers of summation order)."""
    j_cfg, cfg = configs()
    patches, tokens, _ = batch(0)
    want = JVideoLM(j_cfg).apply(jax_vars, jnp.asarray(patches), jnp.asarray(tokens))
    model = from_jax_params(jax_vars, cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(patches), torch.from_numpy(tokens))
    assert got.shape == (2, cfg.video_tokens + TEXT_LEN, cfg.decoder.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_distillation_loss_matches_jax(jax_vars):
    """Loss within 1e-5 relative, accuracy and token count exact, per-row
    prompt mask (rows masked to 64 and 16 positions)."""
    j_cfg, cfg = configs()
    patches, tokens, prompt_lens = batch(1)
    loss, metrics = j_distillation_loss(JVideoLM(j_cfg), jax_vars, jnp.asarray(patches), jnp.asarray(tokens),
                                        ByteTokenizer.PAD, jnp.asarray(prompt_lens))
    model = from_jax_params(jax_vars, cfg, device="cpu")
    got, got_metrics = distillation_loss(model, torch.from_numpy(patches), torch.from_numpy(tokens),
                                         ByteTokenizer.PAD, torch.from_numpy(prompt_lens))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert got_metrics["tokens"].item() == float(metrics["tokens"])
    assert got_metrics["tokens"].item() < (tokens != ByteTokenizer.PAD).sum()  # the mask bit
    assert got_metrics["accuracy"].item() == pytest.approx(float(metrics["accuracy"]), abs=1e-7)


@pytest.mark.parametrize(
    "remat,accum,steps",
    [(False, 1, 3), (True, 2, 4)],  # with accumulation, 4 micro-steps make two updates (the first at lr 0)
    ids=["plain", "remat-accum2"],
)
def test_trainer_matches_jax_trainer(remat, accum, steps):
    """The slice as a whole, tiny preset in f32, from the same parameters
    and batches. Per step: loss (rtol 1e-5), grad_norm (rtol 1e-4) and
    accuracy (within one token's argmax of the masked count: a near-tie may
    round either way). Afterwards every parameter within 0.1 x peak lr."""
    j_cfg, cfg = configs()
    tc = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, accum_steps=accum, remat=remat)
    mesh = build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    j_trainer = JTrainer(j_cfg, mesh, JTrainConfig(**tc), seed=0)
    ours = Trainer(cfg, TrainConfig(**tc), device="cpu",
                   model=from_jax_params(to_np(j_trainer.params), cfg, device="cpu"))
    assert ours.model.decoder.remat is remat
    for step in range(steps):
        patches, tokens, prompt_lens = batch(10 + step)
        want = j_trainer.step(patches, tokens, prompt_lens)
        got = ours.step(patches, tokens, prompt_lens)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4, err_msg=f"step {step}")
        assert got["tokens"] == want["tokens"]
        assert abs(got["accuracy"] - want["accuracy"]) <= 1.0 / want["tokens"] + 1e-7
    assert ours.optimizer.count == steps // accum
    state = ours.model.state_dict()
    for name, leaf in jax.tree_util.tree_leaves_with_path(to_np(j_trainer.params["params"])):
        key = ".".join(str(getattr(p, "key", p)) for p in name)
        np.testing.assert_allclose(state[key].numpy(), leaf, atol=0.1 * tc["learning_rate"], rtol=0, err_msg=key)


def test_remat_gives_the_same_gradients():
    _, cfg = configs()
    model = random_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    patches, tokens, prompt_lens = (torch.from_numpy(a) for a in batch(2))
    grads = []
    for remat in (False, True):
        model.decoder.remat = remat
        loss, _ = distillation_loss(model, patches, tokens, ByteTokenizer.PAD, prompt_lens)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_weights_are_trainable_parameters_and_int8_is_not(jax_vars):
    _, cfg = configs()
    model = random_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(model.state_dict())  # every weight is a parameter
    assert all(p.dtype == torch.float32 and p.requires_grad for p in params.values())
    quantized = quantize_decoder_int8(from_jax_params(jax_vars, cfg, device="cpu"))
    int8 = [n for n, p in quantized.named_parameters() if p.dtype == torch.int8]
    assert int8 and all(not quantized.get_parameter(n).requires_grad for n in int8)
    cast = cast_weights(quantized, torch.bfloat16)
    kinds = {p.dtype for p in cast.parameters()}
    assert kinds == {torch.bfloat16, torch.int8}
    assert all(isinstance(p, torch.nn.Parameter) for p in cast.parameters())


# -- CLI and checkpoints -------------------------------------------------------


def test_cli_runs_end_to_end_on_the_cpu(tmp_path):
    rc = run.main([
        "--preset", "tiny", "--device", "cpu", "--steps", "2", "--batch", "2", "--text-len", str(TEXT_LEN),
        "--tokenizer", str(TOKENIZER), "--out", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs"),
    ])
    assert rc == 0
    assert (tmp_path / "ckpt" / "params_2" / "params.pt").exists()


def test_checkpoint_round_trip_and_init_from(tmp_path):
    _, cfg = configs()
    trainer = Trainer(cfg, TrainConfig(warmup_steps=1, total_steps=4), device="cpu", seed=3)
    patches, tokens, prompt_lens = batch(3)
    trainer.step(patches, tokens, prompt_lens)
    trainer.step(patches, tokens, prompt_lens)
    saved = trainer.save_checkpoint(tmp_path)
    assert saved.name == "params_2" and trainer.save_checkpoint(tmp_path) == saved
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    other = Trainer(cfg, device="cpu", seed=4)
    other.restore_checkpoint(saved)
    assert other.step_count == 2
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    args = run.build_parser().parse_args(["--preset", "tiny", "--device", "cpu", "--steps", "1",
                                          "--text-len", str(TEXT_LEN), "--init-from", str(tmp_path)])
    _, resumed, _ = run.prepare(args, run.setup_logging(tmp_path / "logs"))
    assert resumed.step_count == 2
    assert torch.equal(resumed.model.decoder.embed.embedding, want["decoder.embed.embedding"])


@pytest.mark.parametrize("flags", [["--data", "staged"], ["--grounded"], ["--tp", "2"], ["--pp", "2"]])
def test_unported_options_raise(tmp_path, flags):
    """Every option is ported. ``--data`` and ``--grounded`` prepare their
    batch iterators (``tests/test_torch_train_data.py`` holds the batches to
    JAX's). ``--tp 2`` and ``--pp 2`` build their meshes of two CPU ranks:
    on ``model: 2`` the tiny preset's one q head lies on rank 0 and its kv
    head on both (the plan of heads), and a step's loss and grad norm are
    the 1-rank trainer's on the same seeded weights; its two layers make two
    pipeline stages, and the batch rounds up to ``--pp-micro``
    (``tests/test_torch_train_mesh.py`` holds both meshes to JAX)."""
    if flags[0] in ("--data", "--grounded"):
        from video_transformer_tpu_torch.train.grounded import stage_grounded_corpus

        if flags[0] == "--data":
            stage_grounded_corpus(tmp_path / flags[1], 2, get_preset("tiny").encoder)
            flags = ["--data", str(tmp_path / flags[1])]
        args = run.build_parser().parse_args(["--device", "cpu", "--text-len", str(TEXT_LEN), "--batch", "2",
                                              "--grounded-cache", "2", *flags])
        config, _, batches = run.prepare(args, run.setup_logging(tmp_path))
        patches, tokens, blocks = next(batches)
        assert patches.shape[:2] == (2, config.video_tokens) and tokens.shape == (2, args.text_len)
        assert blocks.tolist() == [args.prompt_len] * 2  # the prompt block, clamped to half the text
        return
    args = run.build_parser().parse_args(["--device", "cpu", "--text-len", str(TEXT_LEN), "--batch", "3", *flags])
    mesh = run.build_train_mesh(args, run.setup_logging(tmp_path))
    try:
        if flags[0] == "--tp":
            assert mesh.shape == {"data": 1, "model": 2} and args.batch == 3
            tiny = get_preset("tiny")
            batch = synthetic_batch(np.random.default_rng(0), tiny, 2, TEXT_LEN)
            got = Trainer(tiny, device="cpu", mesh=mesh).step(*batch)
            want = Trainer(tiny, device="cpu").step(*batch)
            assert got["tokens"] == want["tokens"]
            np.testing.assert_allclose([got["loss"], got["grad_norm"]], [want["loss"], want["grad_norm"]], rtol=1e-3)
        else:
            assert mesh.shape == {"pipe": 2} and args.batch == 4  # rounded up to --pp-micro (4)
            trainer = Trainer(get_preset("tiny"), TrainConfig(pp_microbatches=args.pp_micro), device="cpu",
                              mesh=mesh)
            assert [list(r) for r in mesh.run_all(stage_layers, trainer)] == [[0], [1]]
    finally:
        mesh.close()


def test_trainer_rejects_a_mesh():
    """On a mesh every rank makes its own weights: a VideoLM as ``model``
    would cross whole and is refused, as are stages that do not divide the
    layers; both before any rank builds."""
    model = random_params(get_preset("tiny"), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="a function each rank calls"):
        Trainer(get_preset("tiny"), device="cpu", model=model, mesh=Mesh({"data": 1, "model": 2}, [torch.device("cpu")] * 2))
    with pytest.raises(ValueError, match="pipeline stages"):
        Trainer(get_preset("tiny"), device="cpu", mesh=Mesh({"pipe": 3}, [torch.device("cpu")] * 3))
    assert not torch.distributed.is_initialized()
