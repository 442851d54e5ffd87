"""Decoder-only language model (pre-norm, RoPE, GQA, SwiGLU) with a KV cache.

The cache is a dict of per-layer k/v lists [B, Hkv, S, D] plus a per-row
``index`` [B] (int32); with ``quant=True`` k/v are int8 with per-(layer,
head) f32 scales that the prefill block calibrates. Prefill writes the whole
block through K2 (quantizing it for an int8 cache) and attends the
full-precision k/v through K1; each decode step writes its rows through K2
and attends the valid prefix through K3 (``ops/decode_attention.py``), or
does both through K5 when the cache is bf16. A ``rows`` entry [B] int32
maps each logical row to its physical cache row (the batcher's paged pool);
an ``active`` entry [B] bool leaves padding rows out of the int8 scales'
calibration. On a mesh (``parallel/sharding.py::shard_model``) a block
attends over its rank's heads (the plan's, which need not be an even share:
a rank with no q heads adds zeros and launches no attention kernel) and
all-reduces the products of ``out`` and
``down`` over the ``model`` axis, an int8 cache's scales take the MAX of
every data group's amax (the global batch's, as in JAX), and an untied
head's vocab shards are all-gathered. Those collectives are the
differentiable ones of ``parallel/mesh.py``: each block's normed input
enters its column-parallel q/k/v and gate/up through ``copy_to_axis`` (the
backward sums the ranks' partial gradients), ``out`` and ``down`` leave
through ``reduce_from_axis``, and the head's vocab shards through
``gather_from_axis`` after a ``copy_to_axis``, so that a replicated leaf's
gradient is whole on every model rank. Without a cache (training) the
blocks attend causally through ``ops/attention.py`` (K7a-c under autograd),
and ``remat`` recomputes each block in the backward pass. Parameter names
follow the JAX package's parameter paths (``layer_0.attn.q.kernel``). A
served model may carry each block's q/k/v and gate/up as one fused dense
(``models/fuse.py``: ``attn.qkv``, ``mlp.gateup``), whose product the block
splits.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention
from ..ops.decode_attention import decode_attention_update, write_cache_rows
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_angles
from ..parallel.mesh import MODEL_AXIS, copy_to_axis, gather_from_axis, reduce_from_axis
from .config import DecoderConfig
from .vit import Dense

__all__ = ["Decoder", "init_kv_cache", "QDense"]

Cache = dict[str, Any]

# The dense layers of a decoder block; weight-only int8 or int4 applies to these.
QDense = Dense


def init_kv_cache(
    config: DecoderConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype,
    quant: bool = False,
    device: str | torch.device = "cuda",
    kv_heads: int | None = None,
) -> Cache:
    """An empty KV cache: per-layer k/v lists of [B, Hkv, max_len, D];
    ``kv_heads`` is a mesh rank's count of kv heads (default: all)."""
    kv_heads = config.num_kv_heads if kv_heads is None else kv_heads
    shape = (batch, kv_heads, max_len, config.head_dim)
    kv_dtype = torch.int8 if quant else dtype
    cache: Cache = {
        "k": [torch.zeros(shape, dtype=kv_dtype, device=device) for _ in range(config.num_layers)],
        "v": [torch.zeros(shape, dtype=kv_dtype, device=device) for _ in range(config.num_layers)],
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = [
                torch.full((kv_heads,), 1e-6, dtype=torch.float32, device=device)
                for _ in range(config.num_layers)
            ]
    return cache


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig, layer_idx: int):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        # This rank's heads and the mesh (parallel/sharding.py::shard_block).
        self.heads, self.kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.mesh = None
        q_dim = cfg.num_heads * cfg.head_dim
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        # Qwen2 decoders carry q/k/v biases, added after the quantization
        # scale and before RoPE: the k-bias is rotated per position.
        self.q = QDense(cfg.hidden_dim, q_dim, bias=cfg.qkv_bias)
        self.k = QDense(cfg.hidden_dim, kv_dim, bias=cfg.qkv_bias)
        self.v = QDense(cfg.hidden_dim, kv_dim, bias=cfg.qkv_bias)
        self.out = QDense(q_dim, cfg.hidden_dim)

    def forward(self, x, positions, rope, cache: Cache | None, prefill: bool = False):
        cfg = self.cfg
        b, s, _ = x.shape
        dtype = x.dtype
        heads, kv_heads, mesh = self.heads, self.kv_heads, self.mesh
        x = copy_to_axis(x, mesh, MODEL_AXIS)
        if heads == 0:
            # No q heads on this rank: zeros into out's all-reduce, which
            # every rank joins (the empty slice keeps x's gradient path).
            out = x.new_zeros(b, s, cfg.hidden_dim, dtype=dtype) + x.narrow(-1, 0, 0).sum(-1, keepdim=True)
            return reduce_from_axis(out, mesh, MODEL_AXIS), cache
        if "qkv" in self._modules:
            # Serve-time fused projection (models/fuse.py): one product, split.
            kv_dim = kv_heads * cfg.head_dim
            q, k, v = self.qkv(x, dtype).split([heads * cfg.head_dim, kv_dim, kv_dim], dim=-1)
        else:
            q, k, v = self.q(x, dtype), self.k(x, dtype), self.v(x, dtype)
        q = q.reshape(b, s, heads, cfg.head_dim).transpose(1, 2)
        k = k.reshape(b, s, kv_heads, cfg.head_dim).transpose(1, 2)
        v = v.reshape(b, s, kv_heads, cfg.head_dim).transpose(1, 2)
        cos, sin = rope
        q = apply_rope(q, positions, cos, sin).contiguous()
        k = apply_rope(k, positions, cos, sin).contiguous()
        v = v.contiguous()

        if cache is None:
            out = flash_attention(q, k, v, causal=True)
        else:
            i = self.layer_idx
            index = cache["index"]
            rows = cache.get("rows")
            k_layer, v_layer = cache["k"][i], cache["v"][i]
            quantized = k_layer.dtype == torch.int8
            k_scale = cache["k_scale"][i] if quantized else None
            v_scale = cache["v_scale"][i] if quantized else None
            if prefill:
                if quantized:
                    # In-program calibration: the prefill block's batch-wide
                    # amax per head, with a 1.5x margin, max'ed with the
                    # running scale (arithmetic in the compute dtype, as the
                    # JAX package does it). Rows marked inactive (batch
                    # padding) take no part, so that padding a batch does
                    # not move the real rows' scales.
                    k_abs, v_abs = k.abs(), v.abs()
                    active = cache.get("active")
                    if active is not None:
                        k_abs = torch.where(active[:, None, None, None], k_abs, 0)
                        v_abs = torch.where(active[:, None, None, None], v_abs, 0)
                    k_amax, v_amax = k_abs.amax(dim=(0, 2, 3)), v_abs.amax(dim=(0, 2, 3))
                    if mesh is not None and mesh.data > 1:
                        # Every data group's rows: the global batch's amax (exact).
                        k_amax, v_amax = mesh.all_reduce(torch.stack([k_amax, v_amax]), "data", op="max")
                    k_scale = torch.maximum(k_scale, 1.5 * k_amax / 127.0)
                    v_scale = torch.maximum(v_scale, 1.5 * v_amax / 127.0)
                    cache["k_scale"][i] = k_scale
                    cache["v_scale"][i] = v_scale
                # K2 writes the block in one launch (on the CPU its plain
                # version), quantized under the new scales for an int8 cache.
                write_cache_rows(k_layer, v_layer, k, v, index, rows, k_scale=k_scale, v_scale=v_scale)
                out = flash_attention(q, k, v, causal=True)
            else:
                out = decode_attention_update(q, k_layer, v_layer, k, v, index, rows, k_scale, v_scale)
        out = self.out(out.transpose(1, 2).reshape(b, s, heads * cfg.head_dim), dtype)
        return reduce_from_axis(out, mesh, MODEL_AXIS), cache  # row-parallel partial sums


class SwiGLU(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.gate = QDense(cfg.hidden_dim, cfg.mlp_dim)
        self.up = QDense(cfg.hidden_dim, cfg.mlp_dim)
        self.down = QDense(cfg.mlp_dim, cfg.hidden_dim)
        self.mesh = None  # parallel/sharding.py::shard_block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = copy_to_axis(x, self.mesh, MODEL_AXIS)
        if "gateup" in self._modules:  # fused (models/fuse.py)
            gate, up = self.gateup(x, dtype).chunk(2, dim=-1)
        else:
            gate, up = self.gate(x, dtype), self.up(x, dtype)
        return reduce_from_axis(self.down(F.silu(gate) * up, dtype), self.mesh, MODEL_AXIS)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, layer_idx: int):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_dim)
        self.attn = Attention(cfg, layer_idx)
        self.mlp_norm = RMSNorm(cfg.hidden_dim)
        self.mlp = SwiGLU(cfg)

    def forward(self, x, positions, rope, cache, prefill=False):
        attn_out, cache = self.attn(self.attn_norm(x), positions, rope, cache, prefill)
        x = x + attn_out
        return x + self.mlp(self.mlp_norm(x)), cache


class Decoder(nn.Module):
    """Token- or embedding-input decoder producing f32 logits.

    Setting ``remat`` rematerializes each block in the backward pass of a
    cache-free forward (activation memory O(layers) -> O(1) for one extra
    forward), the JAX package's ``nn.remat(DecoderBlock)``.
    """

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.remat = False
        # A mesh rank's kv heads and mesh, and whether its lm_head is a
        # vocab shard (parallel/sharding.py::shard_model).
        self.kv_heads = cfg.num_kv_heads
        self.mesh = None
        self.head_sharded = False
        self.embed = nn.Module()
        self.embed.embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_dim))
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", DecoderBlock(cfg, i))
        self.final_norm = RMSNorm(cfg.hidden_dim)
        if not cfg.tied_embeddings:
            self.lm_head = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_dim))
        cos, sin = rope_angles(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, device="cpu")
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def embed_tokens(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.embed.embedding[tokens.long()].to(dtype)

    def forward(
        self,
        inputs: torch.Tensor,
        cache: Cache | None = None,
        dtype: torch.dtype = torch.bfloat16,
        prefill: bool = False,
        logits_at: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, Cache | None]:
        """``logits_at`` [B] narrows the logits head to one position per row."""
        cfg = self.cfg
        x = self.embed_tokens(inputs, dtype) if inputs.dim() == 2 else inputs.to(dtype)
        b, s, _ = x.shape
        steps = torch.arange(s, device=x.device)
        positions = cache["index"].long()[:, None] + steps if cache is not None else steps.expand(b, s)
        rope = (self.rope_cos, self.rope_sin)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                # The blocks draw no random numbers, so the recompute needs no
                # saved generator state (and a captured training step reads none).
                x, _ = checkpoint(block, x, positions, rope, None, use_reentrant=False, preserve_rng_state=False)
            else:
                x, cache = block(x, positions, rope, cache, prefill)
        x = self.final_norm(x)
        if logits_at is not None:
            x = x[torch.arange(b, device=x.device), logits_at.long()][:, None, :]
        head = self.embed.embedding if cfg.tied_embeddings else self.lm_head
        if self.head_sharded:
            x = copy_to_axis(x, self.mesh, MODEL_AXIS)
        logits = torch.einsum("bsh,vh->bsv", x.float(), head.float())
        if self.head_sharded:
            logits = gather_from_axis(logits, self.mesh, MODEL_AXIS, -1)
        if cache is not None:
            cache["index"] = cache["index"] + s
        return logits, cache
