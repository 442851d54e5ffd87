"""Multi-head attention: the K1 flash-attention kernel and its plain version.

Layouts: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], GQA via Hq % Hkv == 0. When
Sq != Sk the causal mask aligns queries to the LAST Sq key positions. The
kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
``ops/attention.py::_flash_kernel``; ``mha_reference`` is the plain version,
which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import math

import torch

from . import _lib

__all__ = ["flash_attention", "mha_reference"]

_NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Plain attention: f32 logits and softmax, weights cast to v's dtype."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, s_q, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        q_pos = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        logits = logits.masked_fill(k_pos > q_pos, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights.to(v.dtype), v)
    return out.reshape(b, hq, s_q, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Attention through the K1 kernel on CUDA tensors; plain on CPU ones."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal)
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous bf16 CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d != 128:
        raise ValueError(f"flash_attention: head_dim {d} unsupported (the kernel takes 128)")
    if causal and s_q > s_k:
        raise ValueError("flash_attention: causal attention needs Sq <= Sk")
    out = torch.empty_like(q)
    code = _lib.library().vtx_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, s_q, s_k, d, int(causal), 1.0 / math.sqrt(d), _lib.stream(q),
    )
    _lib.check("vtx_flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
