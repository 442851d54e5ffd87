"""The port's mesh and sharding rules against the JAX package's (CPU, no ranks).

``parallel/mesh.py``'s shape resolution on JAX's cases
(``tests/test_engine.py::TestMesh``) and its env contract in torchrun's
terms; ``parallel/sharding.py``'s ``spec_for_path`` equal to JAX's for
every leaf of a micro model (float, int8 and int4 serving trees); a rank's
shard equal to the matching slice of the 1-rank weights, quantized whole
first, also where ``model`` does not divide the heads (the plan of heads:
whole GQA groups a rank, every q head on one rank); a 1 x 1 mesh that
makes no process group. The multi-rank paths are in
``tests/test_torch_tp.py``.
"""

from dataclasses import replace

import pytest
import torch

from video_transformer_tpu.parallel.mesh import mesh_shape_from_config as j_mesh_shape
from video_transformer_tpu.parallel.sharding import spec_for_path as j_spec_for_path
from video_transformer_tpu_torch.models.config import DecoderConfig, EncoderConfig, VLMConfig, get_preset
from video_transformer_tpu_torch.models.quant import quantize_decoder
from video_transformer_tpu_torch.models.vlm import VideoLM
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
from video_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    choose_backend,
    distributed_init_kwargs,
    mesh_devices,
    mesh_shape_from_config,
)
from video_transformer_tpu_torch.parallel.sharding import head_plan, kv_replicated, shard_model, spec_for_path
from video_transformer_tpu_torch.weights import _init_param, cast_weights, random_params


def micro_config(**decoder) -> VLMConfig:
    """JAX ``tests/test_engine.py::micro_config``'s geometry."""
    return VLMConfig(
        name="micro",
        encoder=EncoderConfig(hidden_dim=64, num_layers=1, num_heads=2, head_dim=32, mlp_dim=128, image_size=32,
                              patch_size=16, tubelet_t=2, num_frames=4),
        decoder=DecoderConfig(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2, num_kv_heads=2, head_dim=32,
                              mlp_dim=128, max_seq_len=1024, **decoder),
        dtype="float32",
    )


class TestMeshShape:
    @pytest.mark.parametrize("cfg,n,want", [
        ({"data": -1, "model": 2}, 8, (4, 2)), ({}, 8, (8, 1)), ({"data": 2, "model": 4}, 8, (2, 4)),
        ({"model": 0}, 4, (4, 1)), (None, 1, (1, 1)),
    ])
    def test_resolution_equals_jax(self, cfg, n, want):
        assert mesh_shape_from_config(cfg, n) == j_mesh_shape(cfg, n) == want

    @pytest.mark.parametrize("cfg", [{"model": 3}, {"data": 3, "model": 2}])
    def test_invalid_mesh_raises_as_in_jax(self, cfg):
        with pytest.raises(ValueError):
            j_mesh_shape(cfg, 8)
        with pytest.raises(ValueError):
            mesh_shape_from_config(cfg, 8)

    def test_backend_rule(self):
        cuda = [torch.device("cuda", i) for i in range(4)]
        assert choose_backend(cuda) == "nccl"
        assert choose_backend([torch.device("cuda", 0)] * 2) == "gloo"  # NCCL refuses two ranks on one card
        assert choose_backend([torch.device("cpu")] * 4) == "gloo"

    def test_cpu_ranks_follow_the_config(self):
        assert mesh_devices("cpu", {"data": -1, "model": 2}) == [torch.device("cpu")] * 2
        assert mesh_devices("cpu", {"data": 2, "model": 2}) == [torch.device("cpu")] * 4
        assert mesh_devices("cpu", None) == [torch.device("cpu")]

    def test_one_by_one_mesh_makes_no_process_group(self):
        mesh = build_mesh({"data": -1, "model": 1}, devices=["cpu"])
        assert (mesh.data, mesh.model, mesh.size) == (1, 1, 1) and not mesh.is_controller
        assert not torch.distributed.is_initialized()
        engine = InferenceEngine(micro_config(), max_new_tokens=2, temperature=0.0, device="cpu", mesh=mesh)
        assert engine.mesh is None and engine.data_parallel == 1
        assert not torch.distributed.is_initialized()

    def test_a_model_as_params_is_refused_on_a_mesh(self):
        """Each rank makes its own weights; a VideoLM would cross whole."""
        mesh = Mesh({"data": 1, "model": 2}, [torch.device("cpu")] * 2)
        model = random_params(micro_config(), torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="a function each rank calls"):
            InferenceEngine(micro_config(), params=model, device="cpu", mesh=mesh)
        assert not torch.distributed.is_initialized()


class TestEnvContract:
    """JAX's cases (``tests/test_multihost.py``) in torchrun's terms."""

    def test_absent_address_means_single_process(self):
        assert distributed_init_kwargs({}) is None
        assert distributed_init_kwargs({"WORLD_SIZE": "4", "RANK": "0"}) is None
        assert distributed_init_kwargs({"MASTER_ADDR": "h"}) is None
        assert distributed_init_kwargs({"MASTER_ADDR": "h", "WORLD_SIZE": "1", "RANK": "0"}) is None

    def test_explicit_topology(self):
        kwargs = distributed_init_kwargs({"MASTER_ADDR": "host", "MASTER_PORT": "8476", "WORLD_SIZE": "4",
                                          "RANK": "2", "LOCAL_RANK": "1"})
        assert kwargs == {"host": "host", "port": 8476, "world_size": 4, "rank": 2, "local_rank": 1}
        assert distributed_init_kwargs({"MASTER_ADDR": "h", "WORLD_SIZE": "2", "RANK": "1"})["port"] == 29500

    @pytest.mark.parametrize("env", [
        {"MASTER_ADDR": "h", "WORLD_SIZE": "2"}, {"MASTER_ADDR": "h", "RANK": "0"},
    ])
    def test_half_specified_topology_rejected(self, env):
        with pytest.raises(ValueError, match="set together"):
            distributed_init_kwargs(env)

    def test_non_integer_topology_rejected(self):
        with pytest.raises(ValueError, match="integers"):
            distributed_init_kwargs({"MASTER_ADDR": "h", "WORLD_SIZE": "two", "RANK": "0"})

    def test_rank_out_of_range_rejected(self):
        with pytest.raises(ValueError, match="outside"):
            distributed_init_kwargs({"MASTER_ADDR": "h", "WORLD_SIZE": "2", "RANK": "2"})


def _model(cfg: VLMConfig, quant: str | None):
    model = random_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return quantize_decoder(model, quant) if quant else model


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_spec_for_path_equals_jax_on_every_leaf(quant):
    """Every leaf of a served micro tree (the port's names are JAX's paths
    joined by dots; scales are the ``quant`` collection's leaves), with q/k/v
    biases and an untied head."""
    model = _model(micro_config(qkv_bias=True, tied_embeddings=False), quant)
    names = list(model.state_dict())
    assert any(n.endswith("lm_head") for n in names) and any(n.endswith("q.bias") for n in names)
    if quant:
        assert any(n.endswith("down.scale") for n in names)
    for name in names:
        path = tuple(name.split("."))
        assert spec_for_path(path) == tuple(j_spec_for_path(path)), name


def _rank_mesh(rank: int, data: int = 1, model: int = 2) -> Mesh:
    """A rank's view of a mesh with no process group: enough to shard."""
    return Mesh({"data": data, "model": model}, [torch.device("cpu")] * (data * model), rank=rank)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_is_the_slice_of_the_whole_weights(quant, rank):
    """Quantize whole, then shard: column-parallel kernels, biases and
    scales split on the output dim; row-parallel kernels split on the input
    dim (an int4 carrier [K/2, N] in whole packed rows) and keep the whole
    kernel's scales; the untied head splits its vocab; the rest is whole."""
    cfg = micro_config(qkv_bias=True, tied_embeddings=False)
    whole = _model(cfg, quant).state_dict()
    part = shard_model(_model(cfg, quant), _rank_mesh(rank)).state_dict()
    assert list(part) == list(whole)
    for name, tensor in whole.items():
        spec = spec_for_path(tuple(name.split(".")))
        got = part[name]
        if name.startswith("decoder.") and "model" in spec:
            dim = spec.index("model")
            want = tensor.chunk(2, dim=dim)[rank]
        else:
            want = tensor
        assert got.dtype == tensor.dtype and torch.equal(got, want), name
    block = shard_model(_model(cfg, quant), _rank_mesh(rank)).decoder.layer_0
    assert (block.attn.heads, block.attn.kv_heads) == (1, 1)


def test_quantizing_a_shard_would_change_row_parallel_scales():
    """Why the order is quantize, then shard: a row-parallel kernel's
    per-output-channel scale is its amax over all K rows; a half of the rows
    has its own, smaller amax."""
    model = random_params(micro_config(), torch.Generator().manual_seed(0), "cpu")
    kernel = model.decoder.layer_0.mlp.down.kernel.detach()
    whole = kernel.abs().amax(dim=0)
    halves = [half.abs().amax(dim=0) for half in kernel.chunk(2, dim=0)]
    assert torch.equal(torch.maximum(*halves), whole)
    assert not torch.equal(halves[0], whole) and not torch.equal(halves[1], whole)


def test_layered_random_weights_equal_the_whole_draw():
    """``random_params`` draws block by block what a draw over the whole
    model makes (flax's init of each parameter, in the order of the model
    built whole), in the same order; ``place_block`` sees each block once,
    cast, in layer order, and what it returns is the model's block."""
    cfg = micro_config(qkv_bias=True, tied_embeddings=False)
    generator = torch.Generator().manual_seed(5)
    with torch.no_grad():
        reference = VideoLM(cfg)
        for name, param in reference.named_parameters():
            _init_param(name, param, generator)
    whole = cast_weights(reference, torch.bfloat16).state_dict()
    seen = []

    def place(block):
        seen.append((block.attn.layer_idx, {p.dtype for p in block.parameters()}))
        return block

    for place_block in (None, place):
        layered = random_params(cfg, torch.Generator().manual_seed(5), "cpu", torch.bfloat16,
                                place_block=place_block).state_dict()
        assert list(layered) == list(whole)
        assert all(torch.equal(layered[k], whole[k]) for k in whole)
    assert seen == [(i, {torch.bfloat16}) for i in range(cfg.decoder.num_layers)]


PLAN_GRID = [(h, kv, m) for h, kv in [(1, 1), (2, 1), (2, 2), (6, 2), (6, 3), (8, 2), (28, 4), (16, 16), (12, 4)]
             for m in (1, 2, 3, 4, 8) if m <= max(h, 2)]


@pytest.mark.parametrize("heads,kv_heads,model", PLAN_GRID, ids=[f"h{h}kv{kv}m{m}" for h, kv, m in PLAN_GRID])
def test_head_plan_covers_every_head_once_in_whole_groups(heads, kv_heads, model):
    """Each rank's q heads are a contiguous range whose heads map onto its
    kv heads as whole GQA groups (its local q head ``t`` attends its local
    kv head ``t // (Hq / Hkv)``, the global head's own kv head); the ranks'
    q heads are every head exactly once, their counts differ by at most one
    within a kv head's holders; every kv head has a holder; the MLP's units
    split into contiguous pairs, even +-1, covering ``mlp_dim`` once."""
    group = heads // kv_heads
    plans = [head_plan(heads, kv_heads, 256, model, r) for r in range(model)]
    seen = [h for p in plans for h in p.q_heads]
    assert seen == list(range(heads))
    for p in plans:
        local_q, local_kv = len(p.q_heads), len(p.kv_heads)
        if local_q:
            assert local_kv and local_q % local_kv == 0
            per = local_q // local_kv
            assert [p.kv_heads[t // per] for t in range(local_q)] == [h // group for h in p.q_heads]
    assert {j for p in plans for j in p.kv_heads} == set(range(kv_heads))
    if kv_heads % model == 0:
        assert all(len(p.q_heads) == heads // model and len(p.kv_heads) == kv_heads // model for p in plans)
        assert not kv_replicated(kv_heads, model)
    else:
        assert model == 1 or kv_replicated(kv_heads, model)
        counts = [len(p.q_heads) for p in plans]
        assert max(counts) - min(counts) <= 1 + (group if model % kv_heads else 0)
    units = [(p.mlp.start, p.mlp.stop) for p in plans]
    assert units[0][0] == 0 and units[-1][1] == 256 and all(a[1] == b[0] for a, b in zip(units, units[1:]))
    widths = [b - a for a, b in units]
    assert all(w % 2 == 0 for w in widths) and max(widths) - min(widths) <= 2


@pytest.mark.parametrize("heads,kv_heads,model,want", [
    (1, 1, 2, [([0], (0,)), ([], (0,))]),  # tiny at model 2: one rank holds the head, both the kv head
    (8, 2, 4, [([0, 1], (0,)), ([2, 3], (0,)), ([4, 5], (1,)), ([6, 7], (1,))]),  # base at model 4
    (28, 4, 8, [([0, 1, 2, 3], (0,)), ([4, 5, 6], (0,))] + [None] * 6),  # 7b at model 8: 4 + 3 a kv head
    (6, 3, 2, [([0, 1, 2], (0, 0, 1)), ([3, 4, 5], (1, 2, 2))]),  # neither divides: MHA on a rank
])
def test_head_plan_of_the_shapes_users_hit(heads, kv_heads, model, want):
    for r, expect in enumerate(want):
        if expect is not None:
            p = head_plan(heads, kv_heads, 256, model, r)
            assert (list(p.q_heads), p.kv_heads) == expect


def _k6_takes(k2: int, n: int) -> bool:
    """``ops/int4_matmul.py``'s shape conditions for K6 (at a decode M)."""
    return n % 128 == 0 and k2 % 128 == 0


@pytest.mark.parametrize("preset", ["7b", "qwen2vl-7b"])
@pytest.mark.parametrize("model", [2, 4, 8])
def test_head_plan_int4_shapes_meet_k6(preset, model):
    """The int4 presets' products on each rank of a model axis take K6: the
    MLP's gate/up (N) and down (K/2) in units of 256 hidden units, q and
    k/v whole heads. Only ``out`` of a rank with an odd number of q heads
    (K/2 = 64 x heads) leaves K6 for the unpacked route, by the JAX
    package's dispatch rule: every rank at ``model: 4`` (7 heads) and the
    3-head ranks at ``model: 8``."""
    dec = get_preset(preset).decoder
    d, hidden = dec.head_dim, dec.hidden_dim
    odd_out = []
    for r in range(model):
        plan = head_plan(dec.num_heads, dec.num_kv_heads, dec.mlp_dim, model, r)
        mlp, q, kv = len(plan.mlp), len(plan.q_heads) * d, len(plan.kv_heads) * d
        assert _k6_takes(hidden // 2, mlp) and _k6_takes(mlp // 2, hidden), (r, mlp)  # gate/up, down
        assert _k6_takes(hidden // 2, q) and _k6_takes(hidden // 2, kv), (r, q, kv)
        if not _k6_takes(q // 2, hidden):
            odd_out.append(r)
    assert odd_out == {2: [], 4: [0, 1, 2, 3], 8: [1, 3, 5, 7]}[model]


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("heads,kv_heads,model", [(1, 1, 2), (8, 2, 4), (6, 3, 2)], ids=["tiny_tp2", "8q2kv_tp4",
                                                                                       "6q3kv_tp2"])
def test_uneven_shard_is_the_plan_slice_of_the_whole_weights(quant, heads, kv_heads, model):
    """Where ``model`` does not divide the heads, each rank's q/k/v/out
    columns and rows are its plan's heads of the whole (quantized whole
    first; an int4 carrier in whole packed rows), its MLP its plan's units."""
    cfg = micro_config(qkv_bias=True)
    cfg = replace(cfg, decoder=replace(cfg.decoder, num_heads=heads, num_kv_heads=kv_heads, mlp_dim=96))
    whole = _model(cfg, quant).state_dict()
    d = cfg.decoder.head_dim
    for rank in range(model):
        plan = head_plan(heads, kv_heads, 96, model, rank)
        model_ = shard_model(_model(cfg, quant), _rank_mesh(rank, model=model))
        part = model_.state_dict()
        assert model_.decoder.kv_heads == len(plan.kv_heads)
        block = model_.decoder.layer_1
        assert (block.attn.heads, block.attn.kv_heads) == (len(plan.q_heads), len(plan.kv_heads))
        q_cols = torch.arange(plan.q_heads.start * d, plan.q_heads.stop * d)
        kv_cols = torch.cat([torch.arange(j * d, (j + 1) * d) for j in plan.kv_heads])
        mlp = torch.arange(plan.mlp.start, plan.mlp.stop)
        for name, tensor in whole.items():
            layer, leaf = name.split(".")[-2:]
            if not name.startswith("decoder.layer_") or "model" not in spec_for_path(tuple(name.split("."))):
                assert torch.equal(part[name], tensor), name
                continue
            cols = {"q": q_cols, "k": kv_cols, "v": kv_cols, "out": q_cols}.get(layer, mlp)
            if layer in ("out", "down"):  # rows; a packed carrier's rows are pairs
                rows = cols[0::2] // 2 if tensor.shape[0] * 2 == (heads * d if layer == "out" else 96) else cols
                want = tensor[rows]
            else:
                want = tensor[..., cols]
            assert part[name].dtype == tensor.dtype and torch.equal(part[name], want), (name, rank)
