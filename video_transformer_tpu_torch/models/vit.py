"""Video ViT encoder: tubelet embedding + bidirectional transformer.

Frames are split into non-overlapping (t, p, p) tubelets (a pure reshape and
transpose) followed by one matrix product; factorized 3D sincos positions.
Attention runs through ``ops/attention.py`` non-causally (K1 when serving,
K7a-c or K1 with the reference backward when training). Parameter names
follow the JAX package's parameter paths (``layer_0.q.kernel`` for
``encoder/layer_0/q/kernel``), so ``weights.from_jax_params`` maps one onto
the other by name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..ops.int4_matmul import int4_matmul
from ..ops.norms import rms_norm
from .config import EncoderConfig

__all__ = ["Dense", "VideoEncoder", "tubelet_patchify", "sincos_3d_positions"]


def tubelet_patchify(frames: torch.Tensor, patch: int, tubelet_t: int) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B, N, tubelet_t * patch * patch * 3].

    N = (T / tubelet_t) * (H / patch) * (W / patch), time-major then raster
    within each frame group, matching sincos_3d_positions.
    """
    b, t, h, w, c = frames.shape
    tt = tubelet_t
    gh, gw = h // patch, w // patch
    x = frames.reshape(b, t // tt, tt, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # [B, T', GH, GW, tt, p, p, C]
    return x.reshape(b, (t // tt) * gh * gw, tt * patch * patch * c)


def sincos_3d_positions(config: EncoderConfig) -> np.ndarray:
    """Factorized (t, y, x) sincos position table [N, hidden_dim].

    hidden_dim is split 1/4 time, 3/8 row, 3/8 col (rounded to even sizes).
    """
    dim = config.hidden_dim
    t_dim = (dim // 4) // 2 * 2
    y_dim = ((dim - t_dim) // 2) // 2 * 2
    x_dim = dim - t_dim - y_dim
    grid_t = config.num_frames // config.tubelet_t
    grid_s = config.image_size // config.patch_size

    def table(length: int, d: int) -> np.ndarray:
        pos = np.arange(length, dtype=np.float64)[:, None]
        freq = np.exp(-np.log(10000.0) * np.arange(0, d, 2, dtype=np.float64) / d)
        angles = pos * freq[None, :]
        return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)

    out = np.zeros((grid_t, grid_s, grid_s, dim), dtype=np.float32)
    out[..., :t_dim] = table(grid_t, t_dim)[:, None, None, :]
    out[..., t_dim : t_dim + y_dim] = table(grid_s, y_dim)[None, :, None, :]
    out[..., t_dim + y_dim :] = table(grid_s, x_dim)[None, None, :, :]
    return out.reshape(grid_t * grid_s * grid_s, dim)


class Dense(nn.Module):
    """x @ kernel with the kernel kept in flax's [in, out] layout.

    ``dtype`` is the compute type; None promotes the input's type with the
    kernel's (flax ``nn.Dense`` with ``dtype=None``). A quantized kernel
    carries a per-output-channel ``scale`` buffer that multiplies the
    product (weight-only quantization, ``models/quant.py``): an int8 kernel
    [in, out], or a uint8 carrier [in/2, out] of packed int4 pairs, which
    ``ops/int4_matmul.py`` multiplies in the compute type (K6 at decode
    row counts on the card). A quantized kernel is a parameter without grad.
    """

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.register_buffer("scale", None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        if self.kernel.dtype == torch.uint8:  # packed int4
            dtype = dtype or x.dtype
            y = int4_matmul(x.to(dtype), self.kernel).to(dtype)
        else:
            dtype = dtype or torch.promote_types(x.dtype, self.kernel.dtype)
            y = x.to(dtype) @ self.kernel.to(dtype)
        if self.scale is not None:
            y = y * self.scale.to(dtype)
        return y


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        qkv_dim = cfg.num_heads * cfg.head_dim
        self.attn_norm = nn.Parameter(torch.ones(cfg.hidden_dim))
        self.mlp_norm = nn.Parameter(torch.ones(cfg.hidden_dim))
        self.q = Dense(cfg.hidden_dim, qkv_dim)
        self.k = Dense(cfg.hidden_dim, qkv_dim)
        self.v = Dense(cfg.hidden_dim, qkv_dim)
        self.out = Dense(qkv_dim, cfg.hidden_dim)
        self.gate = Dense(cfg.hidden_dim, cfg.mlp_dim)
        self.up = Dense(cfg.hidden_dim, cfg.mlp_dim)
        self.down = Dense(cfg.mlp_dim, cfg.hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = x.dtype
        b, n, _ = x.shape
        h = rms_norm(x, self.attn_norm)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, n, cfg.num_heads, cfg.head_dim).transpose(1, 2).contiguous()

        q, k, v = heads(self.q(h, dtype)), heads(self.k(h, dtype)), heads(self.v(h, dtype))
        attn = flash_attention(q, k, v, causal=False)
        attn = attn.transpose(1, 2).reshape(b, n, cfg.num_heads * cfg.head_dim)
        x = x + self.out(attn, dtype)
        h = rms_norm(x, self.mlp_norm)
        return x + self.down(F.silu(self.gate(h, dtype)) * self.up(h, dtype), dtype)


class VideoEncoder(nn.Module):
    """Tubelet-embedded bidirectional transformer over video tokens."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = Dense(cfg.patch_dim, cfg.hidden_dim)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", EncoderBlock(cfg))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden_dim))
        self.register_buffer(
            "positions", torch.from_numpy(sincos_3d_positions(cfg)), persistent=False
        )

    def forward(self, patches: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """patches [B, N, patch_dim] (normalized) -> [B, N, hidden]."""
        x = self.patch_embed(patches.to(dtype), dtype)
        x = x + self.positions.to(dtype)[None, : x.shape[1], :]
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return rms_norm(x, self.final_norm)
