"""Tensor-parallel shards of the served model, by parameter path.

The port's counterpart of the JAX package's ``parallel/sharding.py``:
Megatron-style column-parallel q/k/v/gate/up (output dim split over the
``model`` axis) and row-parallel out/down (input dim split), so that each
decoder block needs one all-reduce per sub-layer (``models/lm.py``).
``PARTITION_RULES`` and ``spec_for_path`` are JAX's rules in JAX's order,
keyed by the port's parameter names (the JAX paths joined by dots); a spec
is a tuple of axis names (None: not split), JAX's ``PartitionSpec`` as a
tuple.

``shard_model`` applies them to this rank's copy of a ``VideoLM``, in place:

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
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .mesh import MODEL_AXIS, Mesh

__all__ = ["PARTITION_RULES", "check_divisible", "shard_block", "shard_model", "shard_tensor", "spec_for_path"]

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


def shard_tensor(tensor: torch.Tensor, spec: Spec, index: int, size: int) -> torch.Tensor:
    """Part ``index`` of ``size`` of ``tensor`` along the dim that ``spec``
    puts on the model axis (a contiguous copy, so that the whole tensor can
    be freed); the tensor itself when the spec splits nothing."""
    if size == 1 or MODEL_AXIS not in spec:
        return tensor
    dim = spec.index(MODEL_AXIS)
    if tensor.shape[dim] % size:
        raise ValueError(f"dim {dim} of a {tuple(tensor.shape)} tensor does not split over {size} model ranks")
    return tensor.chunk(size, dim=dim)[index].contiguous().clone()


def check_divisible(cfg, size: int) -> None:
    """Raise ``ValueError`` unless the model axis divides the decoder's
    heads, kv heads and MLP width. JAX replicates the KV cache when the
    axis does not divide the kv heads (its ``engine.py:676-678``); the port
    splits the cache by head and does not yet (ROADMAP.md §1 item 12)."""
    for what, count in (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads), ("mlp_dim", cfg.mlp_dim)):
        if count % size:
            raise ValueError(
                f"{what} = {count} does not divide the model axis ({size}): the port splits the KV cache by "
                "head and does not replicate it yet (ROADMAP.md §1 item 12)"
            )


@torch.no_grad()
def _shard_leaves(module: nn.Module, mesh: Mesh) -> None:
    """Replace each of ``module``'s parameters and buffers by this rank's
    part, by the spec of its path."""
    index, size = mesh.model_index, mesh.model
    for name, tensor in list(module.state_dict(keep_vars=True).items()):
        spec = spec_for_path(tuple(name.split(".")))
        part = shard_tensor(tensor.detach(), spec, index, size)
        if part is tensor:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if leaf in owner._parameters:
            part = nn.Parameter(part, requires_grad=tensor.requires_grad)
        setattr(owner, leaf, part)


def shard_block(block: nn.Module, mesh: Mesh) -> nn.Module:
    """This rank's part of one decoder block, in place: its attention over
    ``num_heads / model`` heads and ``num_kv_heads / model`` kv heads, its
    MLP over ``mlp_dim / model`` hidden units, and the mesh on which the
    block reduces ``out`` and ``down`` (and, for an int8 cache, the KV
    scales over ``data``). Idempotent."""
    if getattr(block, "_mesh_sharded", False) or mesh.size == 1:
        return block
    cfg = block.attn.cfg
    size = mesh.model
    check_divisible(cfg, size)
    _shard_leaves(block, mesh)
    block.attn.heads = cfg.num_heads // size
    block.attn.kv_heads = cfg.num_kv_heads // size
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
    decoder.kv_heads = cfg.num_kv_heads // mesh.model
    decoder.mesh = mesh
    if not cfg.tied_embeddings and cfg.vocab_size % mesh.model == 0 and mesh.model > 1:
        decoder.lm_head = nn.Parameter(
            shard_tensor(decoder.lm_head.detach(), spec_for_path(("lm_head",)), mesh.model_index, mesh.model),
            requires_grad=decoder.lm_head.requires_grad,
        )
        decoder.head_sharded = True
    decoder._mesh_sharded = True
    return model

