"""RMS normalization, computed in float32 (eps 1e-6) and cast back."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization over the last axis, computed in fp32."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)
