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

import functools
import math

import torch

from . import _lib

__all__ = ["INT4_WIDTHS", "int4_matmul", "int4_matmul_reference", "int4_plan", "int4_split_units", "unpack_int4"]

_MAX_M = 256  # beyond this row count the product is compute-bound (JAX _MAX_M)
_BLOCK_N = 128  # output channels per K6 block (csrc/int4_matmul.cu kBlockN)
_UNIT_ROWS = 64  # K/2 rows per stage of the weight ring (kUnitRows)
INT4_WIDTHS = (8, 16, 24, 32, 64, 128, 256)  # the wgmma widths K6 is built for: rows of x, padded
_MAX_SPLITS = 8  # blocks of one cluster that split K/2 (kMaxSplits)
_SMS = 132  # H100 SXM
_FILL_UNITS = 4  # a block's fixed cost (ring fill, fold) in stages, for the plan


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


@functools.lru_cache(maxsize=None)
def int4_plan(m: int, k2: int, n: int) -> tuple[int, int]:
    """K6's grid for x [m, 2 k2] @ packed [k2, n]: (width, splits).

    ``width`` is the wgmma N that holds all m rows of x (one tile of rows,
    so each weight byte is read once). A block owns 128 output channels, and
    ``splits`` blocks of one cluster share its K/2 rows (``int4_split_units``).
    Where no count gives a block per SM, the plan takes the most splits;
    otherwise, among the counts that do, the one that minimises waves x
    (stages per block + a fixed cost), where a wave is 132 SMs times the
    blocks an SM holds (three up to width 32, two at 64, one above:
    ``kBlocksPerSm``); ties go to fewer splits."""
    width = next(w for w in INT4_WIDTHS if w >= m)
    tiles, units = n // _BLOCK_N, k2 // _UNIT_ROWS
    slots = _SMS * (3 if width <= 32 else 2 if width <= 64 else 1)
    counts = [s for s in range(1, min(_MAX_SPLITS, units) + 1) if tiles * s >= _SMS]
    if not counts:
        return width, min(_MAX_SPLITS, units)

    def cost(splits: int) -> int:
        return math.ceil(tiles * splits / slots) * (math.ceil(units / splits) + _FILL_UNITS)

    return width, min(counts, key=cost)


def int4_split_units(k2: int, splits: int) -> list[range]:
    """The K/2 rows each of ``splits`` blocks multiplies, in rank order
    (the kernel's ``first`` and ``count``): stages of 64 rows, shared out as
    evenly as integers allow."""
    units = k2 // _UNIT_ROWS
    return [range(_UNIT_ROWS * (r * units // splits), _UNIT_ROWS * ((r + 1) * units // splits))
            for r in range(splits)]


def _int4_matmul_cuda(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """K6: x bf16 [..., K] @ packed uint8 [K/2, N] -> bf16 [..., N]. The
    leading dims of x are its M rows; no Python work beyond the checks."""
    k2, n = packed.shape
    k = x.shape[-1]
    m = x.numel() // k if k else 0
    if (x.dtype != torch.bfloat16 or packed.dtype != torch.uint8 or x.get_device() != packed.get_device()
            or not (x.is_contiguous() and packed.is_contiguous()) or (x.data_ptr() | packed.data_ptr()) % 16):
        raise ValueError("int4_matmul: x and packed must be contiguous, 16-byte aligned bfloat16 and uint8"
                         " tensors on one CUDA device")
    if k != 2 * k2 or not 0 < m <= _MAX_M or n % 128 or k2 % 128:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} @ packed {tuple(packed.shape)} unsupported")
    width, splits = int4_plan(m, k2, n)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=x.device)
    code = _lib.library().vtx_int4_matmul(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(), m, k2, n, width, splits, _lib.stream(x))
    _lib.check("vtx_int4_matmul", code)
    int4_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ packed int4 [K/2, N] -> [..., N] in x's dtype (unscaled)."""
    k2, n = packed.shape
    # The JAX dispatch's conditions (its ``_pick`` of N and K/2 tiles), off the CPU.
    if x.device.type != "cpu" and x.numel() <= _MAX_M * x.shape[-1] and n % 128 == 0 and k2 % 128 == 0:
        xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
        y = _int4_matmul_cuda(xb if xb.is_contiguous() else xb.contiguous(), packed)
        return y if x.dtype == torch.bfloat16 else y.to(x.dtype)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    w_even, w_odd = unpack_int4(packed)
    y = xf[:, 0::2] @ w_even.to(x.dtype) + xf[:, 1::2] @ w_odd.to(x.dtype)
    return y.reshape(*lead, n).to(x.dtype)


int4_matmul.launches = 0
