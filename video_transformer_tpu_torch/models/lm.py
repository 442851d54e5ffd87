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
calibration. Without a cache (training) the
blocks attend causally through ``ops/attention.py`` (K7a-c under autograd),
and ``remat`` recomputes each block in the backward pass. Parameter names
follow the JAX package's parameter paths (``layer_0.attn.q.kernel``).
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
) -> Cache:
    """An empty KV cache: per-layer k/v lists of [B, Hkv, max_len, D]."""
    shape = (batch, config.num_kv_heads, max_len, config.head_dim)
    kv_dtype = torch.int8 if quant else dtype
    cache: Cache = {
        "k": [torch.zeros(shape, dtype=kv_dtype, device=device) for _ in range(config.num_layers)],
        "v": [torch.zeros(shape, dtype=kv_dtype, device=device) for _ in range(config.num_layers)],
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = [
                torch.full((config.num_kv_heads,), 1e-6, dtype=torch.float32, device=device)
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
        q = self.q(x, dtype).reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)
        k = self.k(x, dtype).reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        v = self.v(x, dtype).reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
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
                    k_scale = torch.maximum(k_scale, 1.5 * k_abs.amax(dim=(0, 2, 3)) / 127.0)
                    v_scale = torch.maximum(v_scale, 1.5 * v_abs.amax(dim=(0, 2, 3)) / 127.0)
                    cache["k_scale"][i] = k_scale
                    cache["v_scale"][i] = v_scale
                # K2 writes the block in one launch (on the CPU its plain
                # version), quantized under the new scales for an int8 cache.
                write_cache_rows(k_layer, v_layer, k, v, index, rows, k_scale=k_scale, v_scale=v_scale)
                out = flash_attention(q, k, v, causal=True)
            else:
                out = decode_attention_update(q, k_layer, v_layer, k, v, index, rows, k_scale, v_scale)
        out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
        return self.out(out, dtype), cache


class SwiGLU(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.gate = QDense(cfg.hidden_dim, cfg.mlp_dim)
        self.up = QDense(cfg.hidden_dim, cfg.mlp_dim)
        self.down = QDense(cfg.mlp_dim, cfg.hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        return self.down(F.silu(self.gate(x, dtype)) * self.up(x, dtype), dtype)


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
                x, _ = checkpoint(block, x, positions, rope, None, use_reentrant=False)
            else:
                x, cache = block(x, positions, rope, cache, prefill)
        x = self.final_norm(x)
        if logits_at is not None:
            x = x[torch.arange(b, device=x.device), logits_at.long()][:, None, :]
        head = self.embed.embedding if cfg.tied_embeddings else self.lm_head
        logits = torch.einsum("bsh,vh->bsv", x.float(), head.float())
        if cache is not None:
            cache["index"] = cache["index"] + s
        return logits, cache
