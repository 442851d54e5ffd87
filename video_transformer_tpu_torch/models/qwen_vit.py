"""The Qwen2-VL vision tower: this package's counterpart of the JAX package's
``models/qwen_vit.py``.

Qwen2-VL's ViT as HF transformers' ``Qwen2VisionTransformerPretrainedModel``
defines it, so that real vision weights port without loss
(``models/port.py``): the conv3d patch embedding as one product over the
flattened tubelets (stride == kernel makes them the same), pre-LayerNorm
blocks with a fused qkv under 2D rotary embeddings, a QuickGELU MLP, and the
2x2 PatchMerger that projects into the decoder's width.

Attention is segmented per temporal group (each pair of frames attends
within itself): the groups fold into the batch, so the flash kernel (K1,
``ops/attention.py``) sees ``[B * T', heads, h * w, head_dim]`` non-causally;
at ``qwen2vl-7b`` that is ``[B * 8, 16, 256, 80]``. Every dense layer has a
bias and none is quantized. Parameter names follow the JAX package's paths
under ``visual/`` (``block_0.qkv.kernel`` for ``visual/block_0/qkv/kernel``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from .vit import Dense

__all__ = ["QwenVisionConfig", "QwenVisionEncoder", "qwen_patchify"]

_LN_EPS = 1e-6


@dataclass(frozen=True)
class QwenVisionConfig:
    """Geometry of the Qwen2-VL vision tower (HF Qwen2VLVisionConfig)."""

    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_size: int = 3584  # the decoder width the merger projects into
    in_channels: int = 3
    # Clip geometry (frames are resized so that H == W == image_size).
    image_size: int = 224
    num_frames: int = 8

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def grid(self) -> tuple[int, int, int]:
        side = self.image_size // self.patch_size
        return (self.num_frames // self.temporal_patch_size, side, side)

    @property
    def tokens_per_clip(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def merged_tokens_per_clip(self) -> int:
        return self.tokens_per_clip // self.spatial_merge_size**2

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


def qwen_patchify(frames: torch.Tensor, config: QwenVisionConfig) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B, N, C * Tp * P * P] in Qwen2-VL's patch order.

    A patch vector is (channel, time, row, column)-ordered, the conv3d
    kernel's flattening, and patches run in 2x2 merge-block order within
    each temporal group (the order the rotary table and the merger assume).
    """
    b, t, h, w, c = frames.shape
    p = config.patch_size
    tp = config.temporal_patch_size
    m = config.spatial_merge_size
    gh, gw = h // p, w // p
    x = frames.reshape(b, t // tp, tp, gh // m, m, p, gw // m, m, p, c)
    # -> [B, T', GH/m, GW/m, m, m, C, tp, p, p]
    x = x.permute(0, 1, 3, 6, 4, 7, 9, 2, 5, 8)
    return x.reshape(b, (t // tp) * gh * gw, c * tp * p * p)


def _rotary_table(config: QwenVisionConfig) -> np.ndarray:
    """Per-patch rotary angles [N, head_dim // 2]: row frequencies, then
    column frequencies, in ``qwen_patchify``'s merge-block patch order."""
    gt, gh, gw = config.grid
    m = config.spatial_merge_size
    dim = config.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))

    hpos = np.broadcast_to(np.arange(gh)[:, None], (gh, gw))
    wpos = np.broadcast_to(np.arange(gw)[None, :], (gh, gw))

    def block_order(grid: np.ndarray) -> np.ndarray:
        return grid.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = block_order(hpos), block_order(wpos)
    freqs = np.concatenate([hpos[:, None] * inv_freq[None, :], wpos[:, None] * inv_freq[None, :]], axis=1)
    return np.tile(freqs, (gt, 1)).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_vision_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D], cos/sin [N, D]: the rotation in f32, x's dtype back."""
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with eps 1e-6, computed in f32, x's dtype back."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + _LN_EPS)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, frame_tokens: int):
        super().__init__()
        self.cfg = cfg
        self.frame_tokens = frame_tokens  # patches a temporal group: the attention segment
        d = cfg.embed_dim
        self.norm1_scale = nn.Parameter(torch.ones(d))
        self.norm1_bias = nn.Parameter(torch.zeros(d))
        self.qkv = Dense(d, 3 * d, bias=True)
        self.proj = Dense(d, d, bias=True)
        self.norm2_scale = nn.Parameter(torch.ones(d))
        self.norm2_bias = nn.Parameter(torch.zeros(d))
        self.fc1 = Dense(d, cfg.mlp_dim, bias=True)
        self.fc2 = Dense(cfg.mlp_dim, d, bias=True)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, n, d = x.shape
        dtype = x.dtype
        heads, head_dim = cfg.num_heads, cfg.head_dim
        q, k, v = self.qkv(_layer_norm(x, self.norm1_scale, self.norm1_bias), dtype).split(d, dim=-1)

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, n, heads, head_dim).transpose(1, 2)

        q = _apply_vision_rope(split_heads(q), cos, sin)
        k = _apply_vision_rope(split_heads(k), cos, sin)
        v = split_heads(v)
        groups = n // self.frame_tokens

        def fold(t: torch.Tensor) -> torch.Tensor:  # temporal groups into the batch
            t = t.reshape(b, heads, groups, self.frame_tokens, head_dim).transpose(1, 2)
            return t.reshape(b * groups, heads, self.frame_tokens, head_dim).contiguous()

        attn = flash_attention(fold(q), fold(k), fold(v), causal=False)
        # [B * T', H, F, D] -> [B, H, T', F, D] -> [B, N, H * D]
        attn = attn.reshape(b, groups, heads, self.frame_tokens, head_dim).transpose(1, 2)
        attn = attn.reshape(b, heads, n, head_dim).transpose(1, 2).reshape(b, n, d)
        x = x + self.proj(attn, dtype)
        h = self.fc1(_layer_norm(x, self.norm2_scale, self.norm2_bias), dtype)
        return x + self.fc2(_quick_gelu(h), dtype)


class QwenVisionEncoder(nn.Module):
    """Patch embedding -> ``depth`` blocks -> 2x2 PatchMerger -> the decoder's width."""

    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = Dense(cfg.patch_dim, cfg.embed_dim)
        _, gh, gw = cfg.grid
        for i in range(cfg.depth):
            setattr(self, f"block_{i}", _VisionBlock(cfg, frame_tokens=gh * gw))
        group = cfg.spatial_merge_size**2
        self.merger_ln_scale = nn.Parameter(torch.ones(cfg.embed_dim))
        self.merger_ln_bias = nn.Parameter(torch.zeros(cfg.embed_dim))
        self.merger_fc1 = Dense(group * cfg.embed_dim, group * cfg.embed_dim, bias=True)
        self.merger_fc2 = Dense(group * cfg.embed_dim, cfg.hidden_size, bias=True)
        angles = torch.from_numpy(_rotary_table(cfg))
        emb = torch.cat([angles, angles], dim=-1)  # [N, head_dim]
        self.register_buffer("rope_cos", torch.cos(emb), persistent=False)
        self.register_buffer("rope_sin", torch.sin(emb), persistent=False)

    def forward(self, patches: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """patches [B, N, patch_dim] (``qwen_patchify`` order) -> [B, N / 4, hidden_size]."""
        cfg = self.cfg
        x = self.patch_embed(patches.to(dtype), dtype)
        cos, sin = self.rope_cos.float(), self.rope_sin.float()
        for i in range(cfg.depth):
            x = getattr(self, f"block_{i}")(x, cos, sin)
        # The merger: LayerNorm, each 2x2 block of patches (consecutive in
        # qwen_patchify's order) as one vector, then an MLP with exact GELU.
        x = _layer_norm(x, self.merger_ln_scale, self.merger_ln_bias)
        b, n, d = x.shape
        group = cfg.spatial_merge_size**2
        x = self.merger_fc1(x.reshape(b, n // group, group * d), dtype)
        return self.merger_fc2(F.gelu(x, approximate="none"), dtype)
