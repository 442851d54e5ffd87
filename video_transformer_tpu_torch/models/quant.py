"""Weight-only int8 quantization of the decoder blocks' dense layers.

Per-output-channel symmetric: scale[j] = max_i |W[i, j]| / 127 (f32, floor
1e-8), Q = round(W / scale) in int8 (round half to even, as numpy), and the
layer computes (x @ Q) * scale in the compute type. Embedding, logits head
and the vision tower stay full precision.
"""

from __future__ import annotations

import torch
from torch import nn

from .vit import Dense

__all__ = ["quantize_kernel", "quantize_decoder_int8", "QUANTIZED_DENSE_NAMES"]

QUANTIZED_DENSE_NAMES = ("q", "k", "v", "out", "gate", "up", "down")


def quantize_kernel(kernel: torch.Tensor, qmax: int = 127) -> tuple[torch.Tensor, torch.Tensor]:
    """[in, out] kernel -> (int8 kernel, f32 scale [out])."""
    w = kernel.float()
    scale = w.abs().amax(dim=0).clamp(min=1e-8) / qmax
    q = torch.round(w / scale[None, :]).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantize_decoder_int8(model: nn.Module) -> nn.Module:
    """Quantize, in place, every block dense layer of ``model.decoder``.

    Idempotent: layers whose kernel is already int8 are left alone. The
    int8 kernel stays a parameter (without grad) under its name.
    """
    for name, module in model.decoder.named_modules():
        if not isinstance(module, Dense) or name.rsplit(".", 1)[-1] not in QUANTIZED_DENSE_NAMES:
            continue
        if module.kernel.dtype == torch.int8:
            continue
        kernel, module.scale = quantize_kernel(module.kernel)
        module.kernel = nn.Parameter(kernel, requires_grad=False)
    return model
