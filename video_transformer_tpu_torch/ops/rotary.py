"""Rotary position embeddings (RoPE), half-split form, in float32.

Angles are tabulated once per model and gathered by absolute position, so the
same code serves prefill (positions 0..S) and decode (position = cache index).
"""

from __future__ import annotations

import torch

__all__ = ["rope_angles", "apply_rope"]


def rope_angles(
    max_seq_len: int, head_dim: int, theta: float = 10000.0, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_seq_len, head_dim // 2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    freqs = 1.0 / (theta**exponent)
    positions = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(positions, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, H, S, D] by the angles at ``positions`` [B, S] or [S]."""
    if positions.dim() == 1:
        positions = positions[None, :]
    cos_g = cos[positions][:, None]  # [B, 1, S, D/2]
    sin_g = sin[positions][:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos_g - x2 * sin_g, x2 * cos_g + x1 * sin_g], dim=-1)
    return rotated.to(x.dtype)
