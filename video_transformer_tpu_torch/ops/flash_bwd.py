"""Flash-attention training kernels K7a-c and their plain versions.

The forward saves only (O, LSE); the backward recomputes the attention
probabilities tile by tile, the FlashAttention-2 recipe:

    P  = exp(QK^T * scale - LSE)
    dV = P^T dO
    dP = dO V^T
    dS = P * (dP - D) * scale,   D = rowsum(dO * O)
    dQ = dS K ,  dK = dS^T Q

Layouts: q [B, Hq, S, D], k/v [B, Hkv, S, D] (GQA, Hq % Hkv == 0), LSE f32
[B, Hq, S] (the JAX package's trailing singleton was a TPU tiling need).
Queries and keys have the same length, a multiple of 128
(``supports_flash_bwd``), and the causal mask has no Sq - Sk offset.

``flash_fwd_lse`` wraps K7a, ``flash_bwd_dq`` K7b and ``flash_bwd_dkv`` K7c
(``csrc/flash_bwd.cu``, replacing the Pallas ``_fwd_lse_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` of the JAX package's
``ops/flash_bwd.py``). Each takes its plain version for CPU tensors only; on
a CUDA tensor it launches its kernel or raises. ``flash_bwd`` computes D and
sums K7c's per-q-head dK/dV partials over the GQA group with torch
elementwise ops, as the JAX package leaves both to XLA.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from . import _lib

__all__ = [
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dkv_reference",
    "flash_bwd_dq",
    "flash_bwd_dq_reference",
    "flash_bwd_reference",
    "flash_fwd_lse",
    "flash_fwd_lse_reference",
    "supports_flash_bwd",
]

_NEG_INF = -1e30
_ALIGN = 128  # the JAX package's smallest flash-backward block
_LOG2E = math.log2(math.e)


def supports_flash_bwd(s_q: int, s_k: int) -> bool:
    """The JAX rule: equal lengths (no causal offset), a multiple of 128."""
    return s_q == s_k and s_q > 0 and s_q % _ALIGN == 0


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled, masked f32 logits [B, Hkv, G, S, S] (G = Hq // Hkv)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = logits.masked_fill(pos[None, :] > pos[:, None], _NEG_INF)
    return logits


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) as exp2(x log2(e)), one extra rounding (about |x| 2^-24 of the
    result). On CPU tensors torch.exp and torch.logsumexp of float32 run
    MKL's vector exp, which has returned values off by up to 1e-4 of
    themselves on the second OpenMP thread, in the first call after an MKL
    matrix product in a loaded process; torch.exp2 runs ATen's own
    vectorized code."""
    return torch.exp2(x * _LOG2E)


def _grouped(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, S, ...] -> [B, Hkv, G, S, ...] in f32."""
    return t.float().reshape(t.shape[0], hkv, t.shape[1] // hkv, *t.shape[2:])


def flash_fwd_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K7a: (O in q's dtype, LSE f32 [B, Hq, S]), all arithmetic in f32."""
    b, hq, s, d = q.shape
    logits = _logits(q, k, causal)
    row_max = logits.amax(dim=-1, keepdim=True)
    lse = row_max + torch.log(_exp(logits - row_max).sum(dim=-1, keepdim=True))
    out = torch.einsum("bhgqk,bhkd->bhgqd", _exp(logits - lse), v.float())
    return out.reshape(b, hq, s, d).to(q.dtype), lse.reshape(b, hq, s)


def _grad_scores(q, k, v, dout, lse, dsum, causal):
    """f32 (P, dS) [B, Hkv, G, S, S], recomputed from LSE and D."""
    hkv = k.shape[1]
    p = _exp(_logits(q, k, causal) - _grouped(lse, hkv)[..., None])
    dp = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(dout, hkv), v.float())
    ds = p * (dp - _grouped(dsum, hkv)[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    return p, ds


def flash_bwd_dq_reference(q, k, v, dout, lse, dsum, causal: bool = True) -> torch.Tensor:
    """Plain K7b: dQ = dS K in f32, returned in q's dtype."""
    _, ds = _grad_scores(q, k, v, dout, lse, dsum, causal)
    return torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()).reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, dsum, causal: bool = True):
    """Plain K7c: per-q-head f32 partials (dK, dV) [B, Hq, S, D]."""
    hkv = k.shape[1]
    p, ds = _grad_scores(q, k, v, dout, lse, dsum, causal)
    dk = torch.einsum("bhgqk,bhgqd->bhgkd", ds, _grouped(q, hkv))
    dv = torch.einsum("bhgqk,bhgqd->bhgkd", p, _grouped(dout, hkv))
    return dk.reshape(q.shape), dv.reshape(q.shape)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple[int, ...]) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **rows: torch.Tensor) -> tuple[int, ...]:
    """Validate the kernels' inputs; returns (B, Hq, Hkv, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if d != 128 or hq % hkv or not supports_flash_bwd(s, k.shape[2]):
        raise ValueError(f"flash kernels take head_dim 128, Sq == Sk % 128 == 0: q {tuple(q.shape)} k {tuple(k.shape)}")
    _check("q", q, torch.bfloat16, (b, hq, s, d))
    _check("k", k, torch.bfloat16, (b, hkv, s, d))
    _check("v", v, torch.bfloat16, (b, hkv, s, d))
    for name, t in rows.items():
        if name == "dout":
            _check(name, t, torch.bfloat16, (b, hq, s, d))
        else:
            _check(name, t, torch.float32, (b, hq, s))
    return b, hq, hkv, s, d


def flash_fwd_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) through K7a on CUDA tensors; plain on CPU ones."""
    if q.device.type == "cpu":
        return flash_fwd_lse_reference(q, k, v, causal)
    b, hq, hkv, s, d = _check_qkv(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    code = _lib.library().vtx_flash_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, hq, hkv, s, d, int(causal), 1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_flash_fwd_lse", code)
    flash_fwd_lse.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, dsum, causal: bool = True) -> torch.Tensor:
    """dQ through K7b on CUDA tensors; plain on CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, dout, lse, dsum, causal)
    b, hq, hkv, s, d = _check_qkv(q, k, v, dout=dout, lse=lse, dsum=dsum)
    dq = torch.empty_like(q)
    code = _lib.library().vtx_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dq.data_ptr(), b, hq, hkv, s, d, int(causal), 1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_flash_bwd_dq", code)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, dsum, causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-q-head f32 (dK, dV) partials through K7c on CUDA tensors; plain on CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, dsum, causal)
    b, hq, hkv, s, d = _check_qkv(q, k, v, dout=dout, lse=lse, dsum=dsum)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    code = _lib.library().vtx_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, s, d, int(causal), 1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_flash_bwd_dkv", code)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd_lse.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _flash_bwd(q, k, v, o, lse, grad_out, causal: bool, dq_fn: Callable, dkv_fn: Callable):
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dsum = (grad_out.float() * o.float()).sum(dim=-1)  # D [B, Hq, S]
    dq = dq_fn(q, k, v, grad_out, lse, dsum, causal)
    dk_part, dv_part = dkv_fn(q, k, v, grad_out, lse, dsum, causal)
    dk = dk_part.reshape(b, hkv, hq // hkv, s, d).sum(dim=2).to(k.dtype)
    dv = dv_part.reshape(b, hkv, hq // hkv, s, d).sum(dim=2).to(v.dtype)
    return dq, dk, dv


def flash_bwd_reference(q, k, v, o, lse, grad_out, causal: bool = True):
    """Plain (dQ, dK, dV) from the saved (O, LSE); dK/dV in k's and v's dtype."""
    return _flash_bwd(q, k, v, o, lse, grad_out, causal, flash_bwd_dq_reference, flash_bwd_dkv_reference)


def flash_bwd(q, k, v, o, lse, grad_out, causal: bool = True):
    """(dQ, dK, dV) through K7b and K7c on CUDA tensors; plain on CPU ones."""
    return _flash_bwd(q, k, v, o, lse, grad_out, causal, flash_bwd_dq, flash_bwd_dkv)
