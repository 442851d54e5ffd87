"""Context parallelism: the port's ring attention against the JAX package's
``mha_reference``, on gloo CPU ranks.

The inputs and tolerances of JAX's ``tests/test_context_parallel.py``: q
[2, 4, 256, 32] over 2 kv heads, standard normal from JAX's PRNG, float32;
a 2-rank and a 4-rank ``("cp",)`` world, each started once for the module
(the ranks' side is ``tests/torch_mesh_ranks.py::cp_run``). Outputs within
2e-5 of ``mha_reference`` (3e-2 in bfloat16), causal and not; the
gradients of ``mean(out ** 2)`` within 3e-5 of ``jax.grad`` of the same
loss through ``mha_reference``; a change to the last shard's keys leaves
the earlier shards' outputs alone (1e-5); an indivisible sequence raises.
Each of JAX's 5 test functions has a counterpart; the port's covers 2 and
4 ranks (JAX's 8-shard case is ``slow`` there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu.ops.attention import mha_reference
from video_transformer_tpu_torch.parallel.context_parallel import CP_AXIS, build_cp_mesh, ring_attention
from video_transformer_tpu_torch.parallel.mesh import Mesh
from torch_mesh_ranks import cp_run


def qkv(b=2, hq=4, hkv=2, s=256, d=32, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(keys[0], (b, hq, s, d)), jax.random.normal(keys[1], (b, hkv, s, d)),
            jax.random.normal(keys[2], (b, hkv, s, d)))


def np_args(*arrays):
    return [np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a) for a in arrays]


def _cases(n: int) -> dict:
    """Each case's JAX inputs (float32 numpy) and rank arguments."""
    cases = {f"causal_{c}": (np_args(*qkv()), c, False) for c in (True, False)}
    cases["grad"] = (np_args(*qkv(b=1, hq=2, hkv=1, s=64)), True, True)
    if n == 4:
        q, k, v = qkv(b=1, hq=2, hkv=2, s=64)
        cases["boundary"] = (np_args(q, k, v), True, False)
        cases["boundary_perturbed"] = (np_args(q, k.at[:, :, 48:, :].set(33.0), v.at[:, :, 48:, :].set(-33.0)),
                                       True, False)
    return cases


def _to_bf16(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _world(n: int) -> dict:
    mesh = build_cp_mesh(n, ["cpu"] * n, timeout_s=120)
    try:
        assert mesh.shape == {CP_AXIS: n}
        out = {name: (args, mesh.run_all(cp_run, mesh, *args, causal, grad))
               for name, (args, causal, grad) in _cases(n).items()}
        if n == 4:
            args = np_args(*qkv(s=128))
            out["bf16"] = (args, mesh.run_all(cp_run, mesh, *_to_bf16(args), True, False))
        return out
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def worlds():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {n: _world(n) for n in (2, 4)}
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


class TestRingAttention:
    @pytest.mark.parametrize("n_shards", [2, 4])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference(self, worlds, n_shards, causal):
        args, ranks = worlds[n_shards][f"causal_{causal}"]
        ref = np.asarray(mha_reference(*map(jnp.asarray, args), causal=causal))
        for rank in ranks:  # every rank holds the whole output
            np.testing.assert_allclose(rank["out"], ref, atol=2e-5, rtol=2e-5)

    def test_causality_across_shard_boundaries(self, worlds):
        out1 = worlds[4]["boundary"][1][0]["out"]
        out2 = worlds[4]["boundary_perturbed"][1][0]["out"]
        np.testing.assert_allclose(out1[:, :, :48], out2[:, :, :48], atol=1e-5)
        assert not np.allclose(out1[:, :, 48:], out2[:, :, 48:])

    def test_bfloat16_path(self, worlds):
        args, ranks = worlds[4]["bf16"]
        q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in args)
        ref = np.asarray(mha_reference(q, k, v, causal=True), np.float32)
        assert ranks[0]["dtype"] == "torch.bfloat16"
        np.testing.assert_allclose(ranks[0]["out"], ref, atol=3e-2, rtol=3e-2)

    def test_indivisible_sequence_raises(self):
        q, k, v = (torch.from_numpy(a) for a in np_args(*qkv(s=100)))
        with pytest.raises(ValueError, match="divide"):
            ring_attention(q, k, v, Mesh({CP_AXIS: 8}, [torch.device("cpu")] * 8))
        with pytest.raises(ValueError, match="need 8 devices, have 4"):
            build_cp_mesh(8, ["cpu"] * 4)

    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_gradients_match_reference(self, worlds, n_shards):
        """Gradients through the ring (the rotation's backward) equal the
        sequential ones, whole on every rank."""
        args, ranks = worlds[n_shards]["grad"]
        want = jax.grad(lambda t: jnp.mean(mha_reference(*t, causal=True) ** 2))(tuple(map(jnp.asarray, args)))
        for rank in ranks:
            for got, ref in zip(rank["grads"], want):
                np.testing.assert_allclose(got, np.asarray(ref), atol=3e-5, rtol=3e-5)
