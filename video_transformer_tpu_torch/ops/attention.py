"""Multi-head attention: the K1 flash-attention kernel and its plain version.

Layouts: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], GQA via Hq % Hkv == 0. When
Sq != Sk the causal mask aligns queries to the LAST Sq key positions. The
kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
``ops/attention.py::_flash_kernel``; ``mha_reference`` is the plain version,
which the wrapper takes for CPU tensors only. The kernel takes head_dim 128
(the decoders and the native encoders) and 80 (the Qwen2-VL vision tower,
which the JAX package sends to its XLA reference); any other head_dim on a
CUDA tensor raises.

``flash_attention`` is differentiable, with the dispatch of the JAX
package's ``custom_vjp`` (``_flash_diff_fwd`` / ``_flash_diff_bwd``): when
autograd records, head_dim is 128 and ``supports_flash_bwd`` holds, the
forward is K7a and the backward K7b + K7c (``ops/flash_bwd.py``) from the
saved O and LSE. Otherwise, when it records, the forward is K1 and the
backward recomputes through ``mha_reference`` (counted in
``flash_attention.reference_backwards``): the shapes the JAX package sends
to its XLA reference, ``Sq != Sk`` and head_dim 80 (training through the
Qwen2-VL tower). Without grad, K1 alone.
"""

from __future__ import annotations

import math

import torch

from . import _lib
from .flash_bwd import flash_bwd, flash_fwd_lse, supports_flash_bwd

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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
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
    if d not in (80, 128):
        raise ValueError(f"flash_attention: head_dim {d} unsupported (the kernel takes 80 or 128)")
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


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash_attention_diff`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        # Chosen by shape before any launch, head_dim first: K7a-c take 128 only.
        if q.shape[3] == 128 and supports_flash_bwd(q.shape[2], k.shape[2]):
            out, lse = flash_fwd_lse(q, k, v, causal)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _forward(q, k, v, causal)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors  # read once: remat's recompute unpacks each tensor once
        if len(saved) == 5:
            q, k, v, out, lse = saved
            dq, dk, dv = flash_bwd(q, k, v, out, lse, grad_out.contiguous(), ctx.causal)
            return dq, dk, dv, None
        # Recompute through the plain version (exact, O(S^2) transient memory).
        flash_attention.reference_backwards += 1
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in saved]
            out = mha_reference(*inputs, causal=ctx.causal)
        return (*torch.autograd.grad(out, inputs, grad_out), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Attention, differentiable; kernels on CUDA tensors, plain versions on CPU ones."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


flash_attention.launches = 0
flash_attention.reference_backwards = 0
