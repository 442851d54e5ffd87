"""Frame preprocessing on the device: resize -> normalize -> tubelet patchify.

uint8 frames go to the device once; the separable bilinear resize is two
matrix products (height, then width) with precomputed weight matrices, then
``x / 127.5 - 1``, then the patch layout of the encoder: the tubelet order
of ``models/vit.py``, or Qwen2-VL's channel-major merge-block order for a
ported tower (``models/qwen_vit.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.config import EncoderConfig
from ..models.qwen_vit import qwen_patchify
from ..models.vit import tubelet_patchify

__all__ = ["preprocess_frames", "resize_weights"]


@functools.lru_cache(maxsize=64)
def resize_weights(src: int, dst: int) -> np.ndarray:
    """Bilinear interpolation matrix [src, dst] (align_corners=False)."""
    weights = np.zeros((src, dst), dtype=np.float32)
    if src == dst:
        np.fill_diagonal(weights, 1.0)
        return weights
    scale = src / dst
    for j in range(dst):
        center = (j + 0.5) * scale - 0.5
        lo = int(np.floor(center))
        frac = center - lo
        weights[np.clip(lo, 0, src - 1), j] += 1.0 - frac
        weights[np.clip(lo + 1, 0, src - 1), j] += frac
    return weights


def preprocess_frames(
    frames: torch.Tensor,  # uint8 [B, T, H, W, 3]
    config,  # EncoderConfig | QwenVisionConfig
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 frames -> normalized patches [B, N, patch_dim]."""
    _, _, h, w, _ = frames.shape
    size = config.image_size
    x = frames.float()
    wy = torch.from_numpy(resize_weights(h, size)).to(x.device)  # [H, S]
    wx = torch.from_numpy(resize_weights(w, size)).to(x.device)  # [W, S]
    x = torch.einsum("bthwc,hy->btywc", x, wy)
    x = torch.einsum("btywc,wx->btyxc", x, wx)
    x = x * (1.0 / 127.5) - 1.0
    if isinstance(config, EncoderConfig):
        return tubelet_patchify(x, config.patch_size, config.tubelet_t).to(dtype)
    return qwen_patchify(x, config).to(dtype)
