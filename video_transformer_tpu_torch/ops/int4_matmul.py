"""Packed-int4 weight matmul: K6 and its plain version.

``models/quant.py`` stores an int4 kernel as two's-complement nibble pairs in
a uint8 carrier [K/2, N]: row 2k in the low nibble, row 2k+1 in the high one.
The product of x [..., K] with it is

    y = x[..., 0::2] @ sext(lo P) + x[..., 1::2] @ sext(hi P)

unscaled (the per-channel scale multiplies outside, ``models/vit.py::Dense``).

``int4_matmul`` dispatches as the JAX package's ``ops/int4_matmul.py::
int4_matmul`` does, on the flattened row count M = prod(leading dims):

- K6 (``csrc/int4_matmul.cu``, replacing the Pallas ``_kernel``) for a CUDA
  tensor when M <= 256, N % 128 == 0 and (K/2) % 128 == 0: the decode step,
  where streaming the packed weight dominates. It launches or raises.
- Otherwise, and always on the CPU, the unpacked route: two products in the
  compute dtype over ``unpack_int4``, summed in that dtype (prefill and
  training matmuls, which the JAX package leaves to XLA).

``int4_matmul_reference`` is K6's plain version, with the Pallas kernel's
arithmetic: f32 accumulation, one rounding to bf16.
"""

from __future__ import annotations

import math

import torch

from . import _lib

__all__ = ["int4_matmul", "int4_matmul_reference", "int4_splits", "unpack_int4"]

_MAX_M = 256  # beyond this row count the product is compute-bound (JAX _MAX_M)
_BLOCK_N = 128  # output columns per K6 block (csrc/int4_matmul.cu kBlockN)
_MAX_ROWS = 8  # x rows per K6 block (kMaxRows)
_SPLIT_ALIGN = 16  # K/2 rows per split are a multiple of this (kWarps * kGroup)
_MIN_SPLIT_ROWS = 64
_TARGET_BLOCKS = 528  # four 128-thread blocks per SM on 132 SMs


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 nibble pairs [in/2, out] -> (even rows, odd rows) int8.

    ``(v ^ 8) - 8`` sign-extends a two's-complement nibble; it is computed in
    int16, never in uint8 arithmetic."""
    p = packed.to(torch.int16)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return lo.to(torch.int8), hi.to(torch.int8)


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """K6's plain version: x [M, K] @ packed [K/2, N] -> bf16 [M, N], both
    half-products in f32, rounded to bf16 once."""
    lo, hi = unpack_int4(packed)
    xf = x.float()
    return (xf[:, 0::2] @ lo.float() + xf[:, 1::2] @ hi.float()).to(torch.bfloat16)


def int4_splits(m: int, k2: int, n: int) -> tuple[int, int, int]:
    """K6's grid: (rows per block, K/2 rows per split, splits). The K/2 range
    splits until about ``_TARGET_BLOCKS`` blocks fill the card, no split
    shorter than ``_MIN_SPLIT_ROWS`` rows; the last split may be shorter."""
    m_tiles = math.ceil(m / _MAX_ROWS)
    rows = math.ceil(m / m_tiles)
    wanted = max(1, math.ceil(_TARGET_BLOCKS / (m_tiles * (n // _BLOCK_N))))
    split_rows = math.ceil(math.ceil(k2 / wanted) / _SPLIT_ALIGN) * _SPLIT_ALIGN
    split_rows = min(max(split_rows, _MIN_SPLIT_ROWS), k2)
    return rows, split_rows, math.ceil(k2 / split_rows)


def _int4_matmul_cuda(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """K6: x bf16 [M, K] @ packed uint8 [K/2, N] -> bf16 [M, N]."""
    m, k = x.shape
    k2, n = packed.shape
    for name, t, dtype in (("x", x, torch.bfloat16), ("packed", packed, torch.uint8)):
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"int4_matmul: {name} must be a contiguous {dtype} CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be 16-byte aligned")
    if k != 2 * k2 or m > _MAX_M or n % 128 or k2 % 128:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} @ packed {tuple(packed.shape)} unsupported")
    rows, split_rows, splits = int4_splits(m, k2, n)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    code = _lib.library().vtx_int4_matmul(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(), _lib.ptr(partial),
        m, k2, n, rows, split_rows, splits, _lib.stream(x),
    )
    _lib.check("vtx_int4_matmul", code)
    int4_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ packed int4 [K/2, N] -> [..., N] in x's dtype (unscaled)."""
    lead = x.shape[:-1]
    m = math.prod(lead)
    k2, n = packed.shape
    xf = x.reshape(m, x.shape[-1])
    # The JAX dispatch's conditions (its ``_pick`` of N and K/2 tiles), off the CPU.
    if x.device.type != "cpu" and m <= _MAX_M and n % 128 == 0 and k2 % 128 == 0:
        y = _int4_matmul_cuda(xf.to(torch.bfloat16).contiguous(), packed)
    else:
        w_even, w_odd = unpack_int4(packed)
        y = xf[:, 0::2] @ w_even.to(x.dtype) + xf[:, 1::2] @ w_odd.to(x.dtype)
    return y.reshape(*lead, n).to(x.dtype)


int4_matmul.launches = 0
