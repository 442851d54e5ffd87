"""Weight-only int8 and int4 quantization of the decoder blocks' dense layers.

Per-output-channel symmetric: scale[j] = max_i |W[i, j]| / qmax (f32, floor
1e-8; qmax 127 for int8, 7 for int4), Q = round(W / scale) clipped to
[-qmax, qmax] (round half to even, as numpy), and the layer computes
(x @ Q) * scale in the compute type. An int8 kernel stays [in, out] int8;
an int4 kernel is packed two weights a byte into a uint8 carrier
[in/2, out] (``pack_int4``), which ``ops/int4_matmul.py`` unpacks
(``unpack_int4``, re-exported here) and multiplies.
Embedding, logits head and the vision tower stay full precision.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.int4_matmul import unpack_int4
from .vit import Dense

__all__ = [
    "QUANTIZED_DENSE_NAMES",
    "pack_int4",
    "quantize_decoder",
    "quantize_decoder_int4",
    "quantize_decoder_int8",
    "quantize_kernel",
    "quantize_module",
    "unpack_int4",
]

QUANTIZED_DENSE_NAMES = ("q", "k", "v", "out", "gate", "up", "down")

_QUANT_QMAX = {"int8": 127, "int4": 7}


def quantize_kernel(kernel: torch.Tensor, qmax: int = 127) -> tuple[torch.Tensor, torch.Tensor]:
    """[in, out] kernel -> (int8 kernel, f32 scale [out])."""
    w = kernel.float()
    scale = w.abs().amax(dim=0).clamp(min=1e-8) / qmax
    q = torch.round(w / scale[None, :]).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [in, out] -> uint8 nibble pairs [in/2, out].

    Row 2k lands in the low nibble, row 2k+1 in the high nibble (two's
    complement). The nibble is masked in a signed type before the cast to
    uint8: converting a negative int8 to uint8 directly is not portable
    between builds."""
    if q.shape[0] % 2:
        raise ValueError(f"pack_int4 needs an even row count, got {tuple(q.shape)}")
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


@torch.no_grad()
def quantize_module(module: nn.Module, mode: str = "int8") -> nn.Module:
    """Quantize, in place, every dense layer of ``module`` named in
    ``QUANTIZED_DENSE_NAMES`` (a decoder, or one of its blocks).

    ``mode`` "int8" keeps an int8 kernel [in, out], "int4" a packed uint8
    kernel [in/2, out]; either stays a parameter (without grad) under its
    name, beside an f32 ``scale`` [out]. The scale comes from the kernel as
    it is stored (after any ``param_dtype`` cast), as the JAX engine casts
    before it quantizes, and from the whole kernel: a mesh shards after it
    quantizes (``parallel/sharding.py``). Idempotent: int8 and uint8
    kernels are left alone.
    """
    qmax = _QUANT_QMAX[mode]
    for name, dense in module.named_modules():
        if not isinstance(dense, Dense) or name.rsplit(".", 1)[-1] not in QUANTIZED_DENSE_NAMES:
            continue
        if dense.kernel.dtype in (torch.int8, torch.uint8):
            continue
        kernel, dense.scale = quantize_kernel(dense.kernel, qmax)
        if mode == "int4":
            kernel = pack_int4(kernel)
        dense.kernel = nn.Parameter(kernel, requires_grad=False)
    return module


def quantize_decoder(model: nn.Module, mode: str = "int8") -> nn.Module:
    """Quantize, in place, every block dense layer of ``model.decoder``
    (``quantize_module``); returns ``model``."""
    quantize_module(model.decoder, mode)
    return model


def quantize_decoder_int8(model: nn.Module) -> nn.Module:
    return quantize_decoder(model, "int8")


def quantize_decoder_int4(model: nn.Module) -> nn.Module:
    return quantize_decoder(model, "int4")
