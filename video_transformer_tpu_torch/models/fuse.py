"""Serve-time horizontal fusion of the decoder's projection matmuls.

The counterpart of the JAX package's ``models/fuse.py``. Each decoder
block's q/k/v dense layers become one ``qkv`` dense [H, q + 2 kv] and its
gate/up layers one ``gateup`` dense [H, 2 mlp]: 4 products a block (qkv,
out, gateup, down) instead of 7, with the same values, since every output
column of a dense product is its own dot product and concatenation along
the output axis changes neither the values nor the order of any sum.

Kernels concatenate along the output axis (axis 1), which holds for f32 and
bf16 [in, out], int8 [in, out] and packed int4 [in/2, out] carriers alike;
biases and per-channel ``scale`` buffers concatenate along axis 0. An int8
product stays ``x @ kernel`` in the compute type, and an int4 one goes
through ``ops/int4_matmul.py`` (K6 at decode row counts on the card), as
``models/vit.py::Dense`` computes any other. ``models/lm.py``'s
``Attention`` and ``SwiGLU`` read the fused dense when it is present.

A serving transform only (``parallel/engine.py::_place`` applies it after
the cast and quantization): checkpoints and training keep the unfused
layout.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .vit import Dense

__all__ = ["fuse_projections"]


def _skeleton(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s tree whose modules and name tables are new and
    whose tensors are shared: edits to the copy's structure never reach the
    caller's module (the JAX version's ``tree_map(identity)``)."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._non_persistent_buffers_set = set(module._non_persistent_buffers_set)
    new._modules = {name: None if child is None else _skeleton(child) for name, child in module._modules.items()}
    return new


@torch.no_grad()
def _concat(owner: nn.Module, names: tuple[str, ...], fused_name: str) -> None:
    """Replace ``owner``'s dense layers ``names`` with one dense
    ``fused_name`` whose kernel, scale and bias are theirs concatenated."""
    parts = [owner._modules.pop(name) for name in names]
    kernels = [p.kernel for p in parts]
    out_dim = sum(k.shape[1] for k in kernels)
    with torch.device("meta"):
        fused = Dense(kernels[0].shape[0], out_dim, bias=all(p.bias is not None for p in parts))
    fused.kernel = nn.Parameter(torch.cat(kernels, dim=1), requires_grad=kernels[0].requires_grad)
    if all(p.scale is not None for p in parts):
        fused.scale = torch.cat([p.scale for p in parts], dim=0)
    if fused.bias is not None:
        fused.bias = nn.Parameter(torch.cat([p.bias for p in parts], dim=0), requires_grad=parts[0].bias.requires_grad)
    owner.add_module(fused_name, fused)


def fuse_projections(model: nn.Module) -> nn.Module:
    """A new ``VideoLM`` in which every decoder block's q/k/v dense layers
    are one ``attn.qkv`` and its gate/up layers one ``mlp.gateup``; the
    other tensors are shared with ``model``, which keeps its separate
    projections. Idempotent: a block already fused is left alone."""
    new = _skeleton(model)
    for block in new.decoder.children():
        attn, mlp = getattr(block, "attn", None), getattr(block, "mlp", None)
        if attn is None or mlp is None:
            continue
        if all(name in attn._modules for name in ("q", "k", "v")):
            _concat(attn, ("q", "k", "v"), "qkv")
        if all(name in mlp._modules for name in ("gate", "up")):
            _concat(mlp, ("gate", "up"), "gateup")
    return new
