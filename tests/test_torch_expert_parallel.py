"""Expert parallelism: the port's MoE SwiGLU against the JAX package's, on
gloo CPU ranks.

JAX's ``tests/test_expert_parallel.py`` setting: ``init_moe_params(
PRNGKey(0), 64, 128, 8)`` and x [2, 16, 64] from ``PRNGKey(1)``, float32,
carried across with ``weights.from_jax_moe_params``; a 2-rank and a 4-rank
``("expert",)`` world, each started once for the module (the ranks' side
is ``tests/torch_mesh_ranks.py::ep_run``). Against JAX's dense evaluation
(``mesh=None``): outputs within 2e-5, the aux loss within rtol 1e-6, the
gradients of ``mean(out ** 2) + 0.01 * aux`` within atol 3e-5, rtol 3e-4 of
``jax.grad``, with every expert's weights on every rank and with each
rank's own experts resident. The port's dense evaluation equals JAX's; the
top-2 rule and the load-balance loss are JAX's. Each of JAX's 4 test
functions has a counterpart (its 8-device case is covered at 2 and 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_transformer_tpu.parallel.expert_parallel import _top2_routing as j_top2_routing
from video_transformer_tpu.parallel.expert_parallel import init_moe_params as j_init_moe_params
from video_transformer_tpu.parallel.expert_parallel import moe_swiglu as j_moe_swiglu
from video_transformer_tpu_torch.parallel.expert_parallel import (
    EXPERT_AXIS,
    _top2_routing,
    build_expert_mesh,
    init_moe_params,
    moe_swiglu,
)
from video_transformer_tpu_torch.weights import from_jax_moe_params
from torch_mesh_ranks import ep_run

H, M, E = 64, 128, 8


@pytest.fixture(scope="module")
def setup():
    params = {k: np.asarray(v) for k, v in j_init_moe_params(jax.random.PRNGKey(0), H, M, E).items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, H)))
    dense = jax.jit(lambda p: j_moe_swiglu(p, jnp.asarray(x), mesh=None))
    out, aux = dense({k: jnp.asarray(v) for k, v in params.items()})

    def loss(p):
        o, a = dense(p)
        return jnp.mean(o ** 2) + 0.01 * a

    grads = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in params.items()})
    return {"params": params, "x": x, "out": np.asarray(out), "aux": float(aux),
            "grads": {k: np.asarray(v) for k, v in grads.items()}}


@pytest.fixture(scope="module")
def worlds(setup):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for n in (2, 4):
            mesh = build_expert_mesh(n, ["cpu"] * n, timeout_s=120)
            try:
                assert mesh.shape == {EXPERT_AXIS: n}
                out[n] = {resident: mesh.run_all(ep_run, mesh, setup["params"], setup["x"], resident)
                          for resident in (False, True)}
            finally:
                mesh.close()
        return out
    finally:
        torch.set_num_threads(threads)
        assert not dist.is_initialized()


class TestExpertParallel:
    @pytest.mark.parametrize("n_devices", [2, 4])
    @pytest.mark.parametrize("resident", [False, True], ids=["replicated_weights", "resident_experts"])
    def test_sharded_matches_dense(self, setup, worlds, n_devices, resident):
        for rank in worlds[n_devices][resident]:
            np.testing.assert_allclose(rank["out"], setup["out"], atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(rank["aux"], setup["aux"], rtol=1e-6)
            assert rank["collectives"] >= 1

    def test_dense_matches_jax(self, setup):
        params = from_jax_moe_params(setup["params"], device="cpu")
        out, aux = moe_swiglu(params, torch.from_numpy(setup["x"]), mesh=None)
        np.testing.assert_allclose(out.detach().numpy(), setup["out"], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(aux.item(), setup["aux"], rtol=1e-6)

    def test_top2_sparsity(self, setup):
        """Zeroing an expert outside token 0's top two leaves its output alone."""
        params = from_jax_moe_params(setup["params"], device="cpu")
        tokens = torch.from_numpy(setup["x"]).reshape(-1, H)
        top2 = set((tokens[0] @ params["router"]).topk(2).indices.tolist())
        with torch.no_grad():
            full, _ = moe_swiglu(params, torch.from_numpy(setup["x"]))
            dead = next(e for e in range(E) if e not in top2)
            pruned = dict(params, down=params["down"].detach().clone().index_fill_(0, torch.tensor([dead]), 0.0))
            out, _ = moe_swiglu(pruned, torch.from_numpy(setup["x"]))
        np.testing.assert_allclose(full.reshape(-1, H)[0].numpy(), out.reshape(-1, H)[0].numpy(), atol=1e-6)

    @pytest.mark.parametrize("n_devices", [2, 4])
    @pytest.mark.parametrize("resident", [False, True], ids=["replicated_weights", "resident_experts"])
    def test_gradients_match_dense(self, setup, worlds, n_devices, resident):
        per = E // n_devices
        for index, rank in enumerate(worlds[n_devices][resident]):
            lo = index * per
            for key in ("router", "gate", "up", "down"):
                want = setup["grads"][key]
                if resident and key != "router":
                    want = want[lo:lo + per]
                np.testing.assert_allclose(rank["grads"][key], want, atol=3e-5, rtol=3e-4, err_msg=key)

    def test_load_balance_loss_favors_uniform(self):
        uniform = torch.zeros(64, E)
        collapsed = torch.zeros(64, E)
        collapsed[:, 0], collapsed[:, 1] = 10.0, 9.0
        _, aux_uniform = _top2_routing(uniform)
        _, aux_collapsed = _top2_routing(collapsed)
        assert aux_uniform.item() < aux_collapsed.item()
        for logits in (uniform, collapsed):  # the tie rule and the aux loss are JAX's
            weights, aux = _top2_routing(logits)
            j_weights, j_aux = j_top2_routing(jnp.asarray(logits.numpy()))
            np.testing.assert_allclose(weights.numpy(), np.asarray(j_weights), rtol=1e-6)
            np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-6)

    def test_init_draws_jax_scales(self):
        params = init_moe_params(torch.Generator().manual_seed(0), H, M, E, device="cpu")
        assert {k: tuple(v.shape) for k, v in params.items()} == {
            "router": (H, E), "gate": (E, H, M), "up": (E, H, M), "down": (E, M, H)}
        assert abs(params["down"].std().item() - M ** -0.5) < 0.1 * M ** -0.5
