"""Tensor-parallel shards of the served model, by parameter path.

The port's counterpart of the JAX package's ``parallel/sharding.py``:
Megatron-style column-parallel q/k/v/gate/up (output dim split over the
``model`` axis) and row-parallel out/down (input dim split), so that each
decoder block needs one all-reduce per sub-layer (``models/lm.py``).
``PARTITION_RULES`` and ``spec_for_path`` are JAX's rules in JAX's order,
keyed by the port's parameter names (the JAX paths joined by dots); a spec
is a tuple of axis names (None: not split), JAX's ``PartitionSpec`` as a
tuple.

``shard_model`` applies them to this rank's copy of a ``VideoLM``, in place,
cutting each split leaf by the rank's ``HeadPlan`` (``head_plan``):

- column shards: q/k/v/gate/up kernels, their biases and their int8 or int4
  per-output-channel scales;
- row shards: out/down kernels (a packed int4 kernel [K/2, N] splits in
  whole packed rows), whose scales, taken over all K rows before the split,
  stay whole;
- the vocab dim of an untied ``lm_head`` (its logits are all-gathered), when
  the axis divides it; otherwise the head stays whole;
- everything else replicated: the embedding (tied or not), the norms, the
  projector and the vision encoder. JAX's rules also split the encoder's
  and the projector's dense layers, but the result does not depend on that
  layout, and the encoder's heads (1 in the shipped presets) cannot be
  split by head, so the port keeps them whole on every rank.

The serving transform runs in this order: cast, quantize the full kernel,
then shard (``InferenceEngine._place``); quantizing a shard would change a
row-parallel kernel's scales, and the tokens.

The plan of heads. The ``model`` axis need not divide the heads. A rank's
q heads always form whole GQA groups over the kv heads it holds (K1, K2, K3
and K5 take ``Hq % Hkv == 0``):

- ``model`` divides ``num_kv_heads``: an even split of both;
- ``num_kv_heads`` divides ``model``: each kv head is replicated on the
  ``model / num_kv_heads`` ranks in a row, which split its group of q heads
  as evenly as the count allows (7b's 7 q heads a kv head at ``model: 8``:
  4 and 3; the tiny preset's one head at ``model: 2``: 1 and 0);
- neither: a contiguous, even +-1 range of q heads a rank, and one copy of
  the matching kv head for each (an MHA layout on the rank).

``mlp_dim`` splits even +-1 in units of 256 (K6 takes gate/up and down at
N and K/2 multiples of 128: 7b at ``model: 8`` gets 2,560 and 2,304), in
pairs (a packed int4 row) where it has fewer than one such unit a rank. A rank
with no q heads attends to nothing: its part of ``out``'s all-reduce is
zeros (``models/lm.py``). When a kv head has more than one holder
(``kv_replicated``), the training step sums its gradient over them
(``train/trainer.py``). JAX's layout differs (its GSPMD splits the columns
evenly and its engine replicates the KV cache when ``model`` does not
divide the kv heads); the sums are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from .mesh import MODEL_AXIS, Mesh

__all__ = [
    "PARTITION_RULES",
    "HeadPlan",
    "MLP_UNITS",
    "head_plan",
    "kv_replicated",
    "leaf_ranges",
    "shard_block",
    "shard_model",
    "shard_tensor",
    "spec_for_path",
    "unshard_tensor",
]

Spec = tuple[Any, ...]

# (trailing path components, spec); the first rule that matches wins.
PARTITION_RULES: list[tuple[tuple[str, ...], Spec]] = [
    # Column-parallel projections: [in, out] with out split.
    (("q", "kernel"), (None, MODEL_AXIS)),
    (("k", "kernel"), (None, MODEL_AXIS)),
    (("v", "kernel"), (None, MODEL_AXIS)),
    (("gate", "kernel"), (None, MODEL_AXIS)),
    (("up", "kernel"), (None, MODEL_AXIS)),
    # Row-parallel projections: [in, out] with in split.
    (("out", "kernel"), (MODEL_AXIS, None)),
    (("down", "kernel"), (MODEL_AXIS, None)),
    # Column-parallel biases (Qwen2 q/k/v): one per output channel.
    (("q", "bias"), (MODEL_AXIS,)),
    (("k", "bias"), (MODEL_AXIS,)),
    (("v", "bias"), (MODEL_AXIS,)),
    # Untied logits head [V, H]: the vocab dim.
    (("lm_head",), (MODEL_AXIS, None)),
    # Projector between encoder and decoder.
    (("projector_up", "kernel"), (None, MODEL_AXIS)),
    (("projector_down", "kernel"), (MODEL_AXIS, None)),
    # Patch embedding: the output dim.
    (("patch_embed", "kernel"), (None, MODEL_AXIS)),
    # Quantization scales: one per output channel, so column-parallel scales
    # split with the output dim and row-parallel ones stay whole.
    (("q", "scale"), (MODEL_AXIS,)),
    (("k", "scale"), (MODEL_AXIS,)),
    (("v", "scale"), (MODEL_AXIS,)),
    (("gate", "scale"), (MODEL_AXIS,)),
    (("up", "scale"), (MODEL_AXIS,)),
    (("out", "scale"), ()),
    (("down", "scale"), ()),
]


def spec_for_path(path: tuple[str, ...]) -> Spec:
    """The spec of one parameter path (a tuple of names); () replicates."""
    for needles, spec in PARTITION_RULES:
        if len(path) >= len(needles) and tuple(path[-len(needles):]) == needles:
            return spec
    return ()


@dataclass(frozen=True)
class HeadPlan:
    """One model rank's share of a decoder block (global indices)."""

    q_heads: range
    kv_heads: tuple[int, ...]
    """The global kv head of each of the rank's kv heads, in order."""
    mlp: range


# The MLP's split units, the first that divides ``mlp_dim`` into at least one
# a rank: 256 hidden units (K6's 128 output channels of gate/up, 128 packed
# rows of down), else a packed int4 row pair, else one unit.
MLP_UNITS = (256, 2, 1)


def _even(n: int, parts: int, i: int) -> range:
    """Part ``i`` of ``range(n)`` cut into ``parts`` contiguous ranges whose
    lengths differ by at most one (the longer ones first)."""
    per, extra = divmod(n, parts)
    start = i * per + min(i, extra)
    return range(start, start + per + (i < extra))


def head_plan(num_heads: int, num_kv_heads: int, mlp_dim: int, size: int, index: int) -> HeadPlan:
    """Rank ``index`` of ``size`` model ranks: its q heads, kv heads and MLP
    units (see the module docstring)."""
    group = num_heads // num_kv_heads
    if num_kv_heads % size == 0:
        q_heads = _even(num_heads, size, index)
        kv_heads = tuple(_even(num_kv_heads, size, index))
    elif size % num_kv_heads == 0:
        share = size // num_kv_heads
        kv = index // share
        part = _even(group, share, index % share)
        q_heads = range(kv * group + part.start, kv * group + part.stop)
        kv_heads = (kv,)
    else:
        q_heads = _even(num_heads, size, index)
        kv_heads = tuple(h // group for h in q_heads)
    unit = next(u for u in MLP_UNITS if mlp_dim % u == 0 and mlp_dim // u >= size)
    units = _even(mlp_dim // unit, size, index)
    return HeadPlan(q_heads, kv_heads, range(units.start * unit, units.stop * unit))


def kv_replicated(num_kv_heads: int, size: int) -> bool:
    """Whether some kv head has more than one holder on ``size`` model ranks."""
    return size > 1 and num_kv_heads % size != 0


def leaf_ranges(path: tuple[str, ...], shape: tuple[int, ...], cfg, plan: HeadPlan) -> list[tuple[int, int]] | None:
    """The ranges of the model-split dim of a decoder block's leaf that
    ``plan``'s rank holds (their parts concatenated in order), or None for
    a leaf that the model axis does not split. ``shape`` is the whole
    leaf's; a packed int4 kernel's rows count pairs of input units."""
    spec = spec_for_path(path)
    if MODEL_AXIS not in spec:
        return None
    d = cfg.head_dim
    layer = path[-2]
    if layer in ("q", "out"):
        ranges = [(plan.q_heads.start * d, plan.q_heads.stop * d)]
    elif layer in ("k", "v"):
        ranges = [(j * d, (j + 1) * d) for j in plan.kv_heads]
    else:  # gate, up, down
        ranges = [(plan.mlp.start, plan.mlp.stop)]
    full = {"q": cfg.num_heads * d, "out": cfg.num_heads * d, "k": cfg.num_kv_heads * d,
            "v": cfg.num_kv_heads * d}.get(layer, cfg.mlp_dim)
    packed = shape[spec.index(MODEL_AXIS)] * 2 == full
    return [(a // 2, b // 2) for a, b in ranges] if packed else ranges


def shard_tensor(tensor: torch.Tensor, spec: Spec, ranges: list[tuple[int, int]] | None) -> torch.Tensor:
    """The parts ``ranges`` of ``tensor`` along the dim that ``spec`` puts on
    the model axis, concatenated (a contiguous copy, so that the whole
    tensor can be freed); the tensor itself when ``ranges`` is None."""
    if ranges is None:
        return tensor
    dim = spec.index(MODEL_AXIS)
    parts = [tensor.narrow(dim, start, stop - start) for start, stop in ranges]
    return torch.cat(parts, dim=dim).contiguous().clone() if parts else tensor.narrow(dim, 0, 0).clone()


def unshard_tensor(parts: list[torch.Tensor], ranges: list[list[tuple[int, int]]], dim: int,
                   whole: torch.Tensor) -> torch.Tensor:
    """``shard_tensor``'s inverse: every rank's part (``parts[r]`` holding
    ``ranges[r]``) written into ``whole`` (a replicated range is written by
    each holder, with equal values)."""
    for part, rank_ranges in zip(parts, ranges):
        at = 0
        for start, stop in rank_ranges:
            whole.narrow(dim, start, stop - start).copy_(part.narrow(dim, at, stop - start))
            at += stop - start
    return whole


@torch.no_grad()
def _shard_leaves(block: nn.Module, cfg, plan: HeadPlan) -> None:
    """Replace each of a decoder block's parameters and buffers by this
    rank's part, by the spec of its path and ``plan``."""
    for name, tensor in list(block.state_dict(keep_vars=True).items()):
        path = tuple(name.split("."))
        ranges = leaf_ranges(path, tuple(tensor.shape), cfg, plan)
        if ranges is None:
            continue
        part = shard_tensor(tensor.detach(), spec_for_path(path), ranges)
        owner_name, _, leaf = name.rpartition(".")
        owner = block.get_submodule(owner_name)
        if leaf in owner._parameters:
            part = nn.Parameter(part, requires_grad=tensor.requires_grad)
        setattr(owner, leaf, part)


def shard_block(block: nn.Module, mesh: Mesh) -> nn.Module:
    """This rank's part of one decoder block, in place: its attention over
    the plan's q and kv heads, its MLP over the plan's hidden units, and the
    mesh on which the block reduces ``out`` and ``down`` (and, for an int8
    cache, the KV scales over ``data``). Idempotent."""
    if getattr(block, "_mesh_sharded", False) or mesh.size == 1:
        return block
    cfg = block.attn.cfg
    plan = head_plan(cfg.num_heads, cfg.num_kv_heads, cfg.mlp_dim, mesh.model, mesh.model_index)
    if mesh.model > 1:
        _shard_leaves(block, cfg, plan)
    block.attn.heads = len(plan.q_heads)
    block.attn.kv_heads = len(plan.kv_heads)
    block.attn.mesh = mesh
    block.mlp.mesh = mesh
    block._mesh_sharded = True
    return block


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """This rank's part of a ``VideoLM``, in place (see the module
    docstring); the blocks through ``shard_block``. Idempotent."""
    decoder = model.decoder
    if getattr(decoder, "_mesh_sharded", False) or mesh.size == 1:
        return model
    cfg = decoder.cfg
    for i in range(cfg.num_layers):
        shard_block(getattr(decoder, f"layer_{i}"), mesh)
    decoder.kv_heads = decoder.layer_0.attn.kv_heads
    decoder.mesh = mesh
    if not cfg.tied_embeddings and cfg.vocab_size % mesh.model == 0 and mesh.model > 1:
        per = cfg.vocab_size // mesh.model
        decoder.lm_head = nn.Parameter(
            shard_tensor(decoder.lm_head.detach(), spec_for_path(("lm_head",)),
                         [(mesh.model_index * per, (mesh.model_index + 1) * per)]),
            requires_grad=decoder.lm_head.requires_grad,
        )
        decoder.head_sharded = True
    decoder._mesh_sharded = True
    return model

