"""Context parallelism: ring attention over a sequence-sharded mesh axis.

The port's counterpart of the JAX package's ``parallel/context_parallel.py``.
Each rank of a ``("cp",)`` mesh (``build_cp_mesh``) takes a contiguous block
of the sequence's queries, keys and values; the key/value blocks rotate
around the ring (``permute_on_axis``) while every rank folds each visiting
block into its online-softmax accumulator (running max, sum and weighted
value: the flash kernel's arithmetic, so the result is exact, not an
approximation). Causality uses global positions, so the rotation order
never changes the math; a block that masks a query row entirely is zeroed
explicitly (``exp(-1e30 - (-1e30))`` would be 1).

JAX computes this in plain ``jnp`` (no Pallas kernel), and so does the
port: plain PyTorch on each rank's blocks. The gradients go through the
differentiable rotation, whose backward sends them back around the ring.
"""

from __future__ import annotations

import math

import torch

from .mesh import CP_AXIS, Mesh, build_cp_mesh, copy_to_axis, gather_from_axis, permute_on_axis

__all__ = ["CP_AXIS", "build_cp_mesh", "ring_attention"]

_NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, scale, causal, acc, m_prev, l_prev):
    """Fold one key/value block into the online-softmax accumulator.

    q [B, Hq, Sq, D]; k/v [B, Hkv, Sk, D] (GQA by grouping); positions are
    global, so causality survives the rotation."""
    b, hq, s_q, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s_q, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]  # [Sq, Sk]
        logits = torch.where(mask, logits, _NEG_INF)
    m_cur = logits.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.where(logits <= _NEG_INF / 2, 0.0, torch.exp(logits - m_new))
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return acc_new, m_new, l_new


def _ring(ql, kl, vl, mesh: Mesh, causal: bool) -> torch.Tensor:
    """One rank's output block, from its own query block and the key/value
    blocks that visit it."""
    n, idx = mesh.axis_size(CP_AXIS), mesh.axis_index(CP_AXIS)
    b, hq, block, d = ql.shape
    hkv = kl.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = ql.device
    q_pos = idx * block + torch.arange(block, device=dev)
    acc = torch.zeros((b, hkv, hq // hkv, block, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, hq // hkv, block, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_blk, v_blk = kl, vl
    # After r rotations a rank holds the block that started at (idx - r) mod n.
    for r in range(n):
        src = (idx - r) % n
        k_pos = src * block + torch.arange(block, device=dev)
        acc, m, l = _block_attend(ql, k_blk, v_blk, q_pos, k_pos, scale, causal, acc, m, l)
        if r + 1 < n:
            k_blk = permute_on_axis(k_blk, mesh, CP_AXIS, perm)
            v_blk = permute_on_axis(v_blk, mesh, CP_AXIS, perm)
    out = acc / l.clamp(min=1e-30)
    return out.reshape(b, hq, block, d).to(ql.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
) -> torch.Tensor:
    """Exact attention with the sequence split over the ``cp`` axis.

    q/k/v are the whole tensors, the same on every rank (JAX's global
    arrays); each rank attends with its block of the sequence, and the
    output [B, Hq, S, D] is gathered back on every rank. The sequence must
    divide by the axis size. Differentiable: the whole gradient of a
    replicated loss reaches q/k/v on every rank."""
    n = mesh.axis_size(CP_AXIS)
    s = q.shape[2]
    if s % n:
        raise ValueError(f"sequence {s} must divide over {n} cp shards")
    block, idx = s // n, mesh.axis_index(CP_AXIS)
    ql, kl, vl = (copy_to_axis(t, mesh, CP_AXIS)[:, :, idx * block:(idx + 1) * block].contiguous()
                  for t in (q, k, v))
    return gather_from_axis(_ring(ql, kl, vl, mesh, causal), mesh, CP_AXIS, 2)
