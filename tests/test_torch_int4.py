"""Packed-int4 weights in the port against the JAX package, on the CPU.

K6's plain version (``int4_matmul_reference``) is held against the Pallas
kernel run in interpret mode; the unpacked route, the packing, the int4
quantization, the weight bridge and the int4 dense layer against their JAX
counterparts; the dispatch is decided on meta tensors. Inputs are made with
numpy from a seed. Tolerances: integer-valued x makes every partial sum an
integer below 2**24, exact in f32 in any order, so those comparisons are
bit for bit; with normal x two f32 sums of the same products in another
order differ by at most K * 2**-24 * sum|x * w|, and their bf16 roundings
by that plus one bf16 step (2**-7 of the value's binade).
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from video_transformer_tpu.models.config import get_preset as j_get_preset
from video_transformer_tpu.models.lm import QDense as JQDense
from video_transformer_tpu.models.quant import _quantize_kernel as j_quantize_kernel
from video_transformer_tpu.models.quant import pack_int4 as j_pack_int4
from video_transformer_tpu.models.quant import quantize_decoder as j_quantize_decoder
from video_transformer_tpu.models.quant import unpack_int4 as j_unpack_int4
from video_transformer_tpu.models.vlm import VideoLM as JVideoLM
from video_transformer_tpu.ops.int4_matmul import _int4_matmul_pallas
from video_transformer_tpu.ops.int4_matmul import int4_matmul as j_int4_matmul
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.lm import QDense, init_kv_cache
from video_transformer_tpu_torch.models.quant import pack_int4, quantize_decoder, quantize_kernel, unpack_int4
from video_transformer_tpu_torch.ops import int4_matmul as int4_module
from video_transformer_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_reference, int4_plan, int4_split_units
from video_transformer_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

F32_LOGIT_TOL = 1e-4  # as tests/test_torch_models.py: f32 compute, two layers
PALLAS_SHAPES = [(16, 512, 256), (8, 2816, 256), (3, 256, 128)]  # (M, K, N): one chunk, several, odd M
SHAPES_7B = [(1792, 3584), (1792, 512), (1792, 18944), (9472, 3584)]  # (K/2, N): q/out, k/v, gate/up, down


def make(m: int, k: int, n: int, seed: int, integer: bool):
    """bf16 x [M, K] (integers in [-4, 4], or normal) and packed [K/2, N]
    from uniform random bytes (every nibble value in both positions)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (m, k)) if integer else rng.standard_normal((m, k))
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    return x.astype(ml_dtypes.bfloat16), packed


def to_torch(array: np.ndarray) -> torch.Tensor:
    if array.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(array.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(array.copy())


def to_f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def reorder_tolerance(x: np.ndarray, packed: np.ndarray, want: np.ndarray) -> np.ndarray:
    """One bf16 step of |want| plus the bound on two f32 summation orders."""
    lo, hi = (np.asarray(a, np.float64) for a in j_unpack_int4(packed))
    xf = np.abs(x.astype(np.float64))
    magnitude = xf[:, 0::2] @ np.abs(lo) + xf[:, 1::2] @ np.abs(hi)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return step + x.shape[1] * 2.0**-24 * magnitude


@pytest.mark.parametrize("m,k,n", PALLAS_SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_reference_matches_pallas_kernel(m, k, n, integer):
    """K6's plain version against the Pallas kernel in interpret mode."""
    x, packed = make(m, k, n, seed=m + k, integer=integer)
    want = to_f32(_int4_matmul_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                      jnp.asarray(packed), interpret=True))
    got = int4_matmul_reference(to_torch(x), to_torch(packed))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    if integer:
        np.testing.assert_array_equal(to_f32(got), want)
    else:
        assert np.all(np.abs(to_f32(got) - want) <= reorder_tolerance(x, packed, want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lead", [(4,), (2, 3)])
@pytest.mark.parametrize("integer", [True, False])
def test_unpacked_route_matches_jax(dtype, lead, integer):
    """On the CPU ``int4_matmul`` takes the unpacked route, as JAX's does:
    the same result, in x's dtype and leading shape. Exact on integer x;
    on normal x bit-equal on this CPU, and the bound allows another
    summation order in f32, one bf16 step in bf16."""
    m = math.prod(lead)
    x, packed = make(m, 256, 128, seed=m, integer=integer)
    x = x.astype(np.float32).astype(dtype if dtype == "float32" else ml_dtypes.bfloat16)
    want = to_f32(j_int4_matmul(jnp.asarray(x.reshape(*lead, 256)), jnp.asarray(packed)))
    got = int4_matmul(to_torch(x).reshape(*lead, 256), to_torch(packed))
    assert got.shape == (*lead, 128) and got.dtype == getattr(torch, dtype)
    tol = 0.0 if integer else 1e-6 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(to_f32(got), want, rtol=tol, atol=tol * np.abs(want).max())


def test_pack_round_trips_every_nibble_pair():
    """All 256 (even, odd) pairs of values in [-8, 7]: the port packs the
    JAX package's bytes, and unpacks them to the values it packed."""
    pairs = np.array([(a, b) for a in range(-8, 8) for b in range(-8, 8)], np.int8).T  # [2, 256]
    q = np.concatenate([pairs, pairs[::-1]], axis=0)  # both orders, [4, 256]
    packed = pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (2, 256)
    np.testing.assert_array_equal(packed.numpy(), j_pack_int4(q))
    lo, hi = unpack_int4(packed)
    np.testing.assert_array_equal(lo.numpy(), q[0::2])
    np.testing.assert_array_equal(hi.numpy(), q[1::2])
    with pytest.raises(ValueError, match="even"):
        pack_int4(torch.zeros(3, 4, dtype=torch.int8))


@pytest.fixture(scope="module")
def jax_vars():
    j_cfg = replace(j_get_preset("tiny"), dtype="float32")
    variables = JVideoLM(j_cfg).init_variables(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, variables)


def bf16_tree(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16) if a.dtype == np.float32 else a, tree)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantize_decoder_int4_matches_jax(jax_vars):
    """Byte-equal packed kernels and equal scales from the same bf16 weights
    (the JAX engine casts, then quantizes); quantizing again changes nothing."""
    cfg = get_preset("tiny")
    variables = bf16_tree(jax_vars)
    want = from_jax_params(to_np(j_quantize_decoder(variables, "int4")), cfg, device="cpu").state_dict()
    model = quantize_decoder(from_jax_params(variables, cfg, device="cpu"), "int4")
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    kernels = [name for name, t in got.items() if t.dtype == torch.uint8]
    assert len(kernels) == 7 * cfg.decoder.num_layers
    assert tuple(got["decoder.layer_0.mlp.down.kernel"].shape) == (cfg.decoder.mlp_dim // 2, cfg.decoder.hidden_dim)
    for name, tensor in want.items():
        assert got[name].dtype == tensor.dtype, name
        torch.testing.assert_close(got[name], tensor, rtol=0, atol=0, msg=name)
    assert not any(p.requires_grad for n, p in model.named_parameters() if n in kernels)
    again = quantize_decoder(model, "int4").state_dict()
    assert all(torch.equal(again[name], got[name]) for name in got)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_qdense_int4_matches_jax(dtype, tol):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((256, 128)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, 256)).astype(np.float32)
    j_q, j_scale = j_quantize_kernel(w, qmax=7)
    q, scale = quantize_kernel(torch.from_numpy(w), qmax=7)
    np.testing.assert_array_equal(q.numpy(), j_q)
    packed = pack_int4(q)
    want = JQDense(128, dtype=jnp.dtype(dtype)).apply(
        {"params": {"kernel": jnp.asarray(j_pack_int4(j_q))}, "quant": {"scale": jnp.asarray(j_scale)}},
        jnp.asarray(x, dtype),
    )
    layer = QDense(256, 128)
    layer.kernel, layer.scale = torch.nn.Parameter(packed, requires_grad=False), scale
    got = layer(torch.from_numpy(x).to(getattr(torch, dtype)), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_f32(got), to_f32(want), rtol=tol, atol=tol)


def test_bridge_loads_int4_tree_with_jax_logits(jax_vars):
    """The JAX package's int4 tree (uint8 kernels [in/2, out] and scales)
    through ``from_jax_params``: prefill and one decode block give JAX's
    logits (f32 compute, int8 KV cache)."""
    j_cfg = replace(j_get_preset("tiny"), dtype="float32")
    cfg = replace(get_preset("tiny"), dtype="float32")
    j_vars = to_np(j_quantize_decoder(jax_vars, "int4"))
    model = from_jax_params(j_vars, cfg, device="cpu")
    assert model.decoder.layer_1.attn.k.kernel.dtype == torch.uint8
    assert not model.decoder.layer_1.attn.k.kernel.requires_grad
    rng = np.random.default_rng(2)
    patches = rng.standard_normal((2, cfg.encoder.tokens_per_clip, cfg.encoder.patch_dim)).astype(np.float32)
    tokens = rng.integers(0, 512, (2, 128)).astype(np.int32)
    block = rng.integers(0, 512, (2, 3)).astype(np.int32)
    lengths, pick = np.array([128, 100], np.int32), np.array([2, 1], np.int32)
    from video_transformer_tpu.models.lm import init_kv_cache as j_init_kv_cache

    j_model = JVideoLM(j_cfg)
    j_cache = j_init_kv_cache(j_cfg.decoder, 2, 512, jnp.float32, quant=True)
    j_logits, j_cache = j_model.apply(j_vars, jnp.asarray(patches), jnp.asarray(tokens), j_cache,
                                      jnp.asarray(lengths), method=JVideoLM.prefill)
    j_step, _ = j_model.apply(j_vars, jnp.asarray(block), j_cache, jnp.asarray(pick),
                              method=JVideoLM.decode_block_pick)
    cache = init_kv_cache(cfg.decoder, 2, 512, torch.float32, quant=True, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(patches), torch.from_numpy(tokens), cache,
                                      torch.from_numpy(lengths))
        step, _ = model.decode_block_pick(torch.from_numpy(block), cache, torch.from_numpy(pick))
    for got, want in ((logits, j_logits), (step, j_step)):
        np.testing.assert_allclose(to_f32(got), to_f32(want), atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)


@pytest.mark.parametrize("bad", ["odd_half", "full_shape_uint8", "wrong_scale", "wrong_norm"])
def test_bridge_rejects_misshapen_leaves(jax_vars, bad):
    cfg = get_preset("tiny")
    variables = to_np(j_quantize_decoder(jax_vars, "int4"))
    q_node = variables["params"]["decoder"]["layer_0"]["attn"]["q"]
    if bad == "odd_half":
        q_node["kernel"] = q_node["kernel"][:-1]
    elif bad == "full_shape_uint8":
        q_node["kernel"] = np.zeros((cfg.decoder.hidden_dim + 2, cfg.decoder.hidden_dim), np.uint8)
    elif bad == "wrong_scale":
        variables["quant"]["decoder"]["layer_0"]["attn"]["q"]["scale"] = np.ones((3,), np.float32)
    else:
        variables["params"]["decoder"]["final_norm"]["weight"] = np.ones((5,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(variables, cfg, device="cpu")


def routes(monkeypatch, m: int, k2: int, n: int, device: str = "meta", lead: tuple = ()) -> list[str]:
    """The kernels ``int4_matmul`` launches for x [*lead, M, 2 K/2] on
    ``device`` (the K6 launch recorded, not made)."""
    launched = []

    def record(x, packed):
        launched.append("K6")
        return torch.empty(*x.shape[:-1], packed.shape[1], dtype=torch.bfloat16, device=x.device)

    monkeypatch.setattr(int4_module, "_int4_matmul_cuda", record)
    x = torch.empty(*lead, m, 2 * k2, dtype=torch.bfloat16, device=device)
    packed = torch.zeros(k2, n, dtype=torch.uint8, device=device)
    y = int4_matmul(x, packed)
    assert y.shape == (*lead, m, n) and y.dtype == torch.bfloat16
    return launched


@pytest.mark.parametrize(
    "m,k2,n,lead,takes_k6",
    [
        (256, 128, 128, (), True),  # the top of the dispatch
        (257, 128, 128, (), False),
        (3, 1792, 512, (2,), True),  # a 7b decode step: batch 2 x width 3
        (129, 128, 128, (2,), False),  # 258 rows in all
        (6, 128, 192, (), False),  # N not a multiple of 128
        (6, 192, 128, (), False),  # K/2 not a multiple of 128
    ],
)
def test_dispatch_follows_the_shapes(monkeypatch, m, k2, n, lead, takes_k6):
    assert routes(monkeypatch, m, k2, n, lead=lead) == (["K6"] if takes_k6 else [])


def test_cpu_never_takes_the_kernel(monkeypatch):
    before = int4_matmul.launches
    assert routes(monkeypatch, 6, 128, 128, device="cpu") == []
    assert int4_matmul.launches == before


@pytest.mark.parametrize("m", [1, 3, 6, 24, 256])
@pytest.mark.parametrize("k2,n", SHAPES_7B)
def test_kernel_grid_covers_the_product(m, k2, n):
    """K6's plan: one tile of x rows (a wgmma width that holds all M rows, so
    the weight is read once), splits that cover K/2 exactly once in stages
    of 64 rows, and enough blocks for 132 SMs where the cluster's 8 splits
    and K/2 allow it."""
    width, splits = int4_plan(m, k2, n)
    assert width == min(w for w in (8, 16, 24, 32, 64, 128, 256) if w >= m)
    rows = int4_split_units(k2, splits)
    assert [j for r in rows for j in r] == list(range(k2)) and all(len(r) % 64 == 0 and len(r) for r in rows)
    assert 1 <= splits <= 8 and (n // 128) * splits >= min(132, (n // 128) * min(8, k2 // 64))
