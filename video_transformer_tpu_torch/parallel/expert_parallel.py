"""Expert parallelism: a top-2 MoE SwiGLU block, its experts split over ranks.

The port's counterpart of the JAX package's ``parallel/expert_parallel.py``.
No shipped preset uses experts; this is the framework's seam for one that
would. Each rank of an ``("expert",)`` mesh (``build_expert_mesh``)
computes its ``E / N`` experts over every token (a dense dispatch, no
all-to-all), weighted by the router's combine weights for those experts,
and ``reduce_from_axis`` sums the ranks' parts (one all-reduce of the
activations). The router, its softmax and the load-balance loss run
replicated on every rank; the tokens and the combine weights enter the
expert region through ``copy_to_axis``, so that their gradients (and the
router's) are whole on every rank. JAX computes this in plain ``jnp``, and
so does the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights import from_jax_moe_params
from .mesh import EXPERT_AXIS, Mesh, build_expert_mesh, copy_to_axis, reduce_from_axis

__all__ = ["EXPERT_AXIS", "build_expert_mesh", "from_jax_moe_params", "init_moe_params", "moe_swiglu"]


def init_moe_params(generator: torch.Generator, hidden: int, mlp_dim: int, n_experts: int,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Router [H, E] and stacked expert weights [E, ...] (the leading dim
    splits over ``expert``), at JAX's scales (normal, times H^-1/2, and
    mlp_dim^-1/2 for ``down``), drawn from ``generator`` (on ``device``)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    scale = hidden ** -0.5
    return {
        "router": normal(hidden, n_experts) * scale,
        "gate": normal(n_experts, hidden, mlp_dim) * scale,
        "up": normal(n_experts, hidden, mlp_dim) * scale,
        "down": normal(n_experts, mlp_dim, hidden) * mlp_dim ** -0.5,
    }


def _top2_routing(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, E] router logits -> (combine weights [T, E], aux loss scalar).

    Each token keeps the experts whose probability is at least its second
    largest (``probs >= threshold``: a tie keeps more than two, as in JAX);
    the Switch load-balance loss counts each token's primary expert."""
    probs = torch.softmax(logits.float(), dim=-1)
    threshold = probs.topk(2, dim=-1).values[:, 1:2]
    weights = probs * (probs >= threshold).float()
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    n_experts = logits.shape[-1]
    fraction = F.one_hot(probs.argmax(dim=-1), n_experts).float().mean(dim=0)
    aux = n_experts * (fraction * probs.mean(dim=0)).sum()
    return weights, aux


def _expert(tokens, gate_w, up_w, down_w, w_col, dtype):
    hidden = F.silu(tokens @ gate_w.to(dtype)) * (tokens @ up_w.to(dtype))
    return (hidden @ down_w.to(dtype)) * w_col[:, None].to(dtype)


def moe_swiglu(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, S, H]
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-2 MoE SwiGLU: (output [B, S, H], load-balance aux loss).

    ``mesh=None`` evaluates densely on one device (the oracle). On a mesh
    each rank computes its experts ``[i * E/N, (i + 1) * E/N)``: ``gate``,
    ``up`` and ``down`` are either every expert's [E, ...] (the same on
    every rank; each takes its slice and its gradient is whole on every
    rank) or this rank's [E/N, ...] alone (the weights stay resident where
    they are used: the point of expert parallelism)."""
    b, s, h = x.shape
    dtype = x.dtype
    tokens = x.reshape(b * s, h)
    logits = tokens.float() @ params["router"].float()
    weights, aux = _top2_routing(logits)  # [T, E]
    n_experts = params["router"].shape[1]
    if mesh is None:
        out = torch.zeros_like(tokens)
        for e in range(n_experts):
            out = out + _expert(tokens, params["gate"][e], params["up"][e], params["down"][e], weights[:, e], dtype)
        return out.reshape(b, s, h), aux
    n = mesh.axis_size(EXPERT_AXIS)
    if n_experts % n:
        raise ValueError(f"{n_experts} experts do not split over {n} expert ranks")
    per = n_experts // n
    lo = mesh.axis_index(EXPERT_AXIS) * per
    local = {}
    for name in ("gate", "up", "down"):
        w = params[name]
        if w.shape[0] == n_experts and per != n_experts:
            w = copy_to_axis(w, mesh, EXPERT_AXIS)[lo:lo + per]
        elif w.shape[0] != per:
            raise ValueError(f"{name} holds {w.shape[0]} experts: every expert's ({n_experts}) or this rank's ({per})")
        local[name] = w
    toks = copy_to_axis(tokens, mesh, EXPERT_AXIS)
    cols = copy_to_axis(weights, mesh, EXPERT_AXIS)[:, lo:lo + per]
    part = torch.zeros_like(tokens)
    for e in range(per):
        part = part + _expert(toks, local["gate"][e], local["up"][e], local["down"][e], cols[:, e], dtype)
    return reduce_from_axis(part, mesh, EXPERT_AXIS).reshape(b, s, h), aux
