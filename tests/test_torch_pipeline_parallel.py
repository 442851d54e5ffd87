"""Pipeline parallelism: the port's staged decoder against the JAX package's.

The micro geometry of JAX's ``tests/test_pipeline_parallel.py`` (vocab 256,
width 64, 2 q heads over 1 kv head, tokens [4, 16], float32), with 2 and 4
layers, on gloo CPU ranks: a 2-rank and a 4-rank ``("pipe",)`` world, each
started once for the module, every case run on every rank
(``Mesh.run_all``; the ranks' side is in ``tests/torch_mesh_ranks.py``,
which imports no JAX). The port's decoder holds JAX's weights. Against JAX:

- logits within 1e-5 x max|logits| of JAX's ``pipeline_decoder_apply``
  (2 stages, GPipe) or of its sequential ``Decoder`` (the 4-stage and 1F1B
  cases: JAX's own tests hold those equal to it);
- the gradients of ``mean(logits ** 2)`` for every leaf (each stage's
  blocks from that stage's rank; the embedding and final norm, the same on
  every rank) against ``jax.grad`` of the sequential decoder: within rtol
  1e-4, with an atol of 1e-4 x the leaf's largest gradient for the
  elements near 0.

Each of the 10 test functions of JAX's file has a counterpart (GPipe and
1F1B forward, wide forward, gradients, remat, layout), and the refusals are
JAX's: uneven stages, an indivisible batch and an unknown schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu.models.config import DecoderConfig as JDecoderConfig
from video_transformer_tpu.models.lm import Decoder as JDecoder
from video_transformer_tpu.parallel.pipeline_parallel import build_pipe_mesh as j_build_pipe_mesh
from video_transformer_tpu.parallel.pipeline_parallel import pipeline_decoder_apply as j_pipeline_decoder_apply
from video_transformer_tpu_torch.models.config import DecoderConfig
from video_transformer_tpu_torch.models.lm import Decoder
from video_transformer_tpu_torch.parallel.mesh import Mesh
from video_transformer_tpu_torch.parallel.pipeline_parallel import (
    PIPE_AXIS,
    build_pipe_mesh,
    pipeline_blocks_forward,
    shard_stages,
    stack_block_params,
    stage_blocks,
    stage_range,
)
from torch_mesh_ranks import pipe_stage_run, port_decoder

LOGIT_TOL = 1e-5  # x max|logits|
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-4  # x max|grad| of the leaf


def cfg(cls, layers: int):
    return cls(vocab_size=256, hidden_dim=64, num_layers=layers, num_heads=2, num_kv_heads=1, head_dim=32,
               mlp_dim=128, max_seq_len=64)


def flat(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def jax_reference(layers: int, staged: bool = False) -> dict:
    """JAX's weights, tokens, sequential logits and ``jax.grad`` of the
    sequential loss; with ``staged``, also its 2-stage GPipe logits."""
    c = cfg(JDecoderConfig, layers)
    model = JDecoder(c)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, c.vocab_size)
    variables = jax.jit(lambda key: model.init(key, tokens, dtype=jnp.float32))(jax.random.PRNGKey(0))

    def logits(v):
        return model.apply(v, tokens, dtype=jnp.float32)[0]

    out = {"leaves": flat(variables["params"]), "tokens": np.asarray(tokens),
           "logits": np.asarray(jax.jit(logits)(variables)),
           "grads": flat(jax.jit(jax.grad(lambda v: jnp.mean(logits(v) ** 2)))(variables)["params"])}
    if staged:
        mesh = j_build_pipe_mesh(2)
        staged = jax.jit(lambda v: j_pipeline_decoder_apply({"params": {"decoder": v}}, tokens, c, mesh, n_micro=2))
        out["staged"] = np.asarray(staged(variables["params"]))
    return out


CASES_2 = {  # (layers, n_micro, schedule, remat, cut) on 2 stages
    "gpipe": (2, 2, "gpipe", False, False),
    "gpipe_remat": (2, 2, "gpipe", True, True),
    "1f1b": (2, 2, "1f1b", False, True),
    "1f1b_micro4": (4, 4, "1f1b", False, False),
    "1f1b_remat": (2, 2, "1f1b", True, False),
}
CASES_4 = {  # on 4 stages
    "gpipe_micro4": (4, 4, "gpipe", False, True),
    "gpipe_micro1": (4, 1, "gpipe", False, False),
    "1f1b_micro4": (4, 4, "1f1b", False, False),
}


def _world(stages: int, cases: dict, ref: dict) -> dict:
    mesh = build_pipe_mesh(stages, ["cpu"] * stages, timeout_s=120)
    try:
        assert mesh.shape == {PIPE_AXIS: stages} and mesh.backend == "gloo"
        return {name: mesh.run_all(pipe_stage_run, mesh, ref[case[0]]["leaves"], case[0], ref[case[0]]["tokens"], *case[1:])
                for name, case in cases.items()}
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {2: jax_reference(2, staged=True), 4: jax_reference(4)}
        return {"ref": ref, 2: _world(2, CASES_2, ref), 4: _world(4, CASES_4, ref)}
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


def check_logits(ranks: list[dict], want: np.ndarray) -> None:
    for rank in ranks:  # every stage holds the last stage's output
        np.testing.assert_allclose(rank["logits"], want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def check_grads(ranks: list[dict], want: dict, layers: int) -> None:
    """Every leaf's gradient, from the rank whose stage holds it."""
    seen = set()
    for rank in ranks:
        for name, got in rank["grads"].items():
            ref = want[name]
            np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(ref).max(), err_msg=name)
            seen.add(name)
        # The replicated leaves' gradients are whole on every stage.
        for name in ("embed.embedding", "final_norm.weight"):
            assert np.array_equal(rank["grads"][name], ranks[0]["grads"][name]), name
    assert seen == set(want) and all(np.abs(want[f"layer_{i}.attn.q.kernel"]).max() > 0 for i in range(layers))


class TestPipelineParity:
    def test_forward_matches_jax_pipeline(self, runs):
        got, ref = runs[2]["gpipe"], runs["ref"][2]
        np.testing.assert_allclose(ref["staged"], ref["logits"], rtol=0, atol=LOGIT_TOL * np.abs(ref["logits"]).max())
        check_logits(got, ref["staged"])

    @pytest.mark.parametrize("case", ["gpipe_micro4", "gpipe_micro1"])
    def test_forward_matches_sequential_wide(self, runs, case):
        check_logits(runs[4][case], runs["ref"][4]["logits"])

    def test_gradients_flow_across_stages(self, runs):
        check_grads(runs[2]["gpipe"], runs["ref"][2]["grads"], 2)

    def test_remat_matches(self, runs):
        check_logits(runs[2]["gpipe_remat"], runs["ref"][2]["logits"])
        check_grads(runs[2]["gpipe_remat"], runs["ref"][2]["grads"], 2)


class Test1F1BSchedule:
    def test_forward_matches_sequential(self, runs):
        check_logits(runs[2]["1f1b"], runs["ref"][2]["logits"])

    @pytest.mark.parametrize("stages,case", [(4, "1f1b_micro4"), (2, "1f1b_micro4")])
    def test_forward_matches_sequential_wide(self, runs, stages, case):
        check_logits(runs[stages][case], runs["ref"][4]["logits"])

    def test_gradients_match_sequential_fast(self, runs):
        check_grads(runs[2]["1f1b"], runs["ref"][2]["grads"], 2)

    @pytest.mark.parametrize("stages,case", [(4, "1f1b_micro4"), (2, "1f1b_micro4")])
    def test_gradients_match_sequential(self, runs, stages, case):
        check_grads(runs[stages][case], runs["ref"][4]["grads"], 4)

    def test_remat_gradients_match(self, runs):
        """1F1B drops remat (as JAX does); its gradients equal GPipe's."""
        check_grads(runs[2]["1f1b_remat"], runs["ref"][2]["grads"], 2)
        for a, b in zip(runs[2]["1f1b_remat"], runs[2]["gpipe"]):
            for name in a["grads"]:
                np.testing.assert_allclose(a["grads"][name], b["grads"][name], rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL * np.abs(b["grads"][name]).max(), err_msg=name)


class TestLayout:
    def test_stack_block_params_layout(self, runs):
        leaves = runs["ref"][2]["leaves"]
        decoder = port_decoder(leaves, 2)
        stacked = stack_block_params(decoder, 2)
        assert stacked["attn.q.kernel"].shape[0] == 2
        assert np.array_equal(stacked["attn.q.kernel"][1].detach().numpy(), leaves["layer_1.attn.q.kernel"])

    def test_each_stage_holds_its_blocks(self, runs):
        assert [r["layers"] for r in runs[4]["gpipe_micro4"]] == [[0], [1], [2], [3]]
        assert [r["layers"] for r in runs[2]["1f1b_micro4"]] == [[0, 1], [2, 3]]
        mesh = Mesh({PIPE_AXIS: 2}, [torch.device("cpu")] * 2, rank=1)
        decoder = shard_stages(port_decoder(runs["ref"][4]["leaves"], 4), mesh)
        assert [n for n in decoder._modules if n.startswith("layer_")] == ["layer_2", "layer_3"]
        assert [b.attn.layer_idx for b in stage_blocks(decoder, mesh)] == [2, 3]

    def test_schedules_issue_their_collectives(self, runs):
        """GPipe's backward: a send a tick but the last, then the input's
        gradient to every stage; 1F1B's: the two waves' sends."""
        for stages, case, ticks in ((2, "gpipe", 2 + 1 - 1 + 1), (4, "gpipe_micro4", 4 + 3 - 1 + 1),
                                    (2, "1f1b", (2 + 1 - 1) + (2 + 2 - 1) + 1)):
            assert {r["backward_collectives"] for r in runs[stages][case]} == {ticks}, case


class TestRefusals:
    def _mesh(self, stages: int) -> Mesh:
        return Mesh({PIPE_AXIS: stages}, [torch.device("cpu")] * stages)

    def test_uneven_stages_raise(self):
        with pytest.raises(ValueError, match="pipeline stages"):
            stage_range(2, self._mesh(3))
        with pytest.raises(ValueError, match="need 3 devices, have 2"):
            build_pipe_mesh(3, ["cpu"] * 2)

    def test_the_engine_refuses_a_pipe_mesh(self):
        from video_transformer_tpu_torch.models.config import get_preset
        from video_transformer_tpu_torch.parallel.engine import InferenceEngine

        with pytest.raises(ValueError, match=r"\(data, model\) mesh"):
            InferenceEngine(get_preset("tiny"), device="cpu", mesh=self._mesh(2))

    def test_indivisible_batch_and_unknown_schedule_raise(self):
        decoder = Decoder(cfg(DecoderConfig, 2))
        x = torch.zeros(3, 16, 64)
        positions = torch.arange(16).expand(3, 16)
        rope = (decoder.rope_cos, decoder.rope_sin)
        blocks = stage_blocks(decoder, self._mesh(2))
        with pytest.raises(ValueError, match="must divide into 2 microbatches"):
            pipeline_blocks_forward(blocks, x, positions, rope, self._mesh(2), n_micro=2)
        with pytest.raises(ValueError, match="unknown pipeline schedule"):
            pipeline_blocks_forward(blocks, x, positions, rope, self._mesh(2), n_micro=1, schedule="zb")
