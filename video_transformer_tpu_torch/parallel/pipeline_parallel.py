"""Pipeline parallelism over the decoder's blocks (GPipe and 1F1B).

The port's counterpart of the JAX package's ``parallel/pipeline_parallel.py``.
Each rank of a ``("pipe",)`` mesh (``build_pipe_mesh``) is a stage and holds
a contiguous ``L / S`` of the decoder's blocks (``shard_stages``); the
batch splits into ``n_micro`` microbatches that stream through the stages,
the activations moving to the next stage after each tick
(``Mesh.ppermute``). Stage ``i`` runs microbatch ``t - i`` at tick ``t``, so
a pass takes ``n_micro + S - 1`` ticks (the GPipe bubble, a fraction
``(S - 1) / (n_micro + S - 1)``); where JAX runs every stage at every tick
and masks the bubble, a port stage skips the ticks it has no microbatch
for. The last stage's outputs are all-reduced to every stage: the vision
encoder, the embedding, the final norm and the logits head run replicated
on every rank, as in JAX, so every rank computes the same loss.

The staged block stack is one ``torch.autograd.Function`` whose backward
runs a tick loop of its own, so that every rank issues its collectives in
one order:

- ``schedule="gpipe"``: the forward keeps each microbatch's graph of its
  stage (activation memory O(n_micro) a stage; ``remat`` recomputes each
  block in the backward instead); the backward runs the microbatches from
  the last stage to the first, each stage's input gradient moving to the
  previous stage after each tick.
- ``schedule="1f1b"``: JAX's ``_pipeline_1f1b``. The forward keeps nothing
  but its input. The backward runs two waves in one tick loop: a recompute
  wave (the forward again, each stage stashing its input in a ring of
  ``2S - 1`` slots) and, ``S - 1`` ticks behind it, the backward wave, in
  which stage ``i`` recomputes its blocks with grad from the input in slot
  ``(t - offset - last + 2i) mod depth`` and takes their VJP against the
  gradient from stage ``i + 1``. Activation memory O(stages); ``remat`` is
  dropped, as in JAX.

The input's gradient (stage 0's) is all-reduced to every stage, so the
replicated encoder and embedding take the same, whole gradient on every
rank; a stage's blocks take gradients on that stage only. A tied
embedding, read at the input and as the head, sums both contributions on
every rank.

Both tick loops branch only on Python ints (the stage count, ``n_micro``,
the stage, the schedule), and an idle tick still sends zeros, so every
stage issues the same collectives in the same order on every step. The
trainer's step (``train/trainer.py``) therefore captures the whole
pipelined step, forward ticks, backward ticks, norm and update, as one CUDA
graph on each stage over NCCL and replays them in lockstep, as JAX jits its
pipeline inside the step; on gloo the same step runs eagerly.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.norms import rms_norm
from .mesh import PIPE_AXIS, Mesh, build_pipe_mesh

__all__ = [
    "PIPE_AXIS",
    "block_forward",
    "build_pipe_mesh",
    "pipeline_blocks_forward",
    "pipeline_decoder_apply",
    "pipeline_vlm_logits",
    "shard_stages",
    "stack_block_params",
    "stage_blocks",
    "stage_range",
]

SCHEDULES = ("gpipe", "1f1b")


def stack_block_params(decoder: nn.Module, num_layers: int) -> dict[str, torch.Tensor]:
    """``layer_0 .. layer_{L-1}`` -> one tensor a parameter name with a
    leading layer dim [L, ...] (JAX's layout of the staged stack: stage
    ``s`` holds rows ``s * L / S`` to ``(s + 1) * L / S``)."""
    blocks = [dict(getattr(decoder, f"layer_{i}").named_parameters()) for i in range(num_layers)]
    return {name: torch.stack([block[name] for block in blocks]) for name in blocks[0]}


def stage_range(num_layers: int, mesh: Mesh) -> range:
    """The layers of this rank's stage. Raises unless the stages divide them."""
    n_stages = mesh.axis_size(PIPE_AXIS)
    if num_layers % n_stages:
        raise ValueError(f"decoder layers {num_layers} must divide into {n_stages} pipeline stages")
    per = num_layers // n_stages
    stage = mesh.axis_index(PIPE_AXIS)
    return range(stage * per, (stage + 1) * per)


def stage_blocks(decoder: nn.Module, mesh: Mesh) -> list[nn.Module]:
    """This rank's blocks, in layer order (of a whole decoder, or of one
    that ``shard_stages`` cut to its stage)."""
    return [getattr(decoder, f"layer_{i}") for i in stage_range(decoder.cfg.num_layers, mesh)]


def shard_stages(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's stage of a ``VideoLM``'s (or a ``Decoder``'s)
    blocks, in place; everything else stays whole. Idempotent."""
    decoder = getattr(model, "decoder", model)
    keep = stage_range(decoder.cfg.num_layers, mesh)
    for i in range(decoder.cfg.num_layers):
        if i not in keep and hasattr(decoder, f"layer_{i}"):
            delattr(decoder, f"layer_{i}")
    decoder.stage_layers = keep
    return model


def block_forward(block: nn.Module, x: torch.Tensor, positions: torch.Tensor, rope, remat: bool = False):
    """One decoder block on the training path (no cache); ``remat``
    recomputes it in the backward. The blocks draw no random numbers, so
    the recompute needs no saved generator state (and a captured step reads
    none)."""
    if remat:
        return checkpoint(block, x, positions, rope, None, use_reentrant=False, preserve_rng_state=False)[0]
    return block(x, positions, rope, None)[0]


class _Stage:
    """One rank's share of a pipelined pass: its blocks and the schedule."""

    def __init__(self, blocks, mesh: Mesh, n_micro: int, positions: torch.Tensor, rope, remat: bool):
        self.blocks, self.mesh, self.n_micro = blocks, mesh, n_micro
        self.positions, self.rope, self.remat = positions, rope, remat
        self.n_stages = mesh.axis_size(PIPE_AXIS)
        self.stage = mesh.axis_index(PIPE_AXIS)
        self.last = self.n_stages - 1
        self.params = [p for block in blocks for p in block.parameters() if p.requires_grad]

    def run(self, h: torch.Tensor, m: int, remat: bool) -> torch.Tensor:
        for block in self.blocks:
            h = block_forward(block, h, self.positions[m], self.rope, remat)
        return h

    def send(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Every stage's ``x`` to stage ``i + step`` (mod S)."""
        n = self.n_stages
        return self.mesh.ppermute(x, PIPE_AXIS, [(i, (i + step) % n) for i in range(n)])

    def vjp(self, inp: torch.Tensor, out: torch.Tensor, grad: torch.Tensor, acc: list) -> torch.Tensor:
        """The input's gradient; the parameters' are added into ``acc``."""
        grads = torch.autograd.grad(out, [inp, *self.params], grad)
        for total, g in zip(acc, grads[1:]):
            total.add_(g)
        return grads[0]

    def replicate(self, x: torch.Tensor, owner: int) -> torch.Tensor:
        """Stage ``owner``'s ``x`` on every stage (a sum with zeros: exact)."""
        return self.mesh.all_reduce(x if self.stage == owner else torch.zeros_like(x), PIPE_AXIS)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st: _Stage, schedule: str, xm: torch.Tensor, *params):
        ctx.st, ctx.schedule = st, schedule
        n_micro, stage, last = st.n_micro, st.stage, st.last
        ticks = n_micro + st.n_stages - 1
        state = torch.zeros_like(xm[0])
        outputs = torch.zeros_like(xm)
        stash = {}
        for t in range(ticks):
            m = t - stage
            if stage == 0 and t < n_micro:
                state = xm[t]
            if 0 <= m < n_micro:
                if schedule == "gpipe":
                    with torch.enable_grad():
                        inp = state.detach().requires_grad_()
                        out = st.run(inp, m, st.remat)
                    stash[m] = (inp, out)
                    state = out.detach()
                else:
                    state = st.run(state, m, False)
                if stage == last:
                    outputs[m] = state
            if t + 1 < ticks:
                state = st.send(state, 1)
        ctx.stash = stash
        if schedule == "1f1b":
            ctx.save_for_backward(xm)
        return st.replicate(outputs, last)

    @staticmethod
    def backward(ctx, grad_out):
        st = ctx.st
        acc = [torch.zeros_like(p) for p in st.params]
        if ctx.schedule == "gpipe":
            dx = _gpipe_backward(st, ctx.stash, grad_out, acc)
        else:
            (xm,) = ctx.saved_tensors
            dx = _1f1b_backward(st, xm, grad_out, acc)
        ctx.stash = None
        return (None, None, st.replicate(dx, 0), *acc)


def _gpipe_backward(st: _Stage, stash: dict, grad_out: torch.Tensor, acc: list) -> torch.Tensor:
    """Microbatches from the last stage to the first, through the graphs
    the forward kept: stage ``i`` runs microbatch ``t - (last - i)`` at tick
    ``t``."""
    n_micro, stage, last = st.n_micro, st.stage, st.last
    ticks = n_micro + last
    dx = torch.zeros_like(grad_out)
    cot = torch.zeros_like(grad_out[0])
    for t in range(ticks):
        m = t - (last - stage)
        da = torch.zeros_like(cot)
        if 0 <= m < n_micro:
            inp, out = stash.pop(m)
            da = st.vjp(inp, out, grad_out[m] if stage == last else cot, acc)
            if stage == 0:
                dx[m] = da
        if t + 1 < ticks:
            cot = st.send(da, -1)
    return dx


def _1f1b_backward(st: _Stage, xm: torch.Tensor, grad_out: torch.Tensor, acc: list) -> torch.Tensor:
    """JAX's two-wave tick loop (see the module docstring): the recompute
    wave stashes each stage's input in a ring of ``2S - 1`` slots; the
    backward wave, ``offset = last`` ticks behind, recomputes stage ``i``'s
    blocks with grad on microbatch ``t - offset - last + i`` and takes its
    VJP."""
    n_micro, stage, last = st.n_micro, st.stage, st.last
    depth, offset = 2 * st.n_stages - 1, last
    ticks, wave = n_micro + 2 * last, n_micro + last
    dx = torch.zeros_like(xm)
    fwd_state = torch.zeros_like(xm[0])
    cot = torch.zeros_like(xm[0])
    acts: list[Any] = [None] * depth
    for t in range(ticks):
        # The recompute wave (the forward, replayed).
        if t < wave:
            if stage == 0 and t < n_micro:
                fwd_state = xm[t]
            acts[t % depth] = fwd_state
            mf = t - stage
            new_fwd = st.run(fwd_state, mf, False) if 0 <= mf < n_micro else fwd_state
        # The backward wave.
        m = t - offset - last + stage
        da = torch.zeros_like(cot)
        if 0 <= m < n_micro:
            a = acts[(t - offset - last + 2 * stage) % depth]
            with torch.enable_grad():
                inp = a.detach().requires_grad_()
                out = st.run(inp, m, False)
            da = st.vjp(inp, out, grad_out[t - offset] if stage == last else cot, acc)
            if stage == 0:
                dx[m] = da
        if t + 1 < wave:
            fwd_state = st.send(new_fwd, 1)
        if t + 1 < ticks:
            cot = st.send(da, -1)
    return dx


def pipeline_blocks_forward(
    blocks: list[nn.Module],  # this rank's stage (stage_blocks)
    x: torch.Tensor,  # [B, S, H] the block stack's input (post-embedding), the same on every rank
    positions: torch.Tensor,  # [B, S]
    rope,
    mesh: Mesh,
    n_micro: int,
    remat: bool = False,
    schedule: str = "gpipe",
) -> torch.Tensor:
    """The staged block stack over ``x`` in ``n_micro`` microbatches:
    [B, S, H], the last stage's output on every rank. Differentiable (see
    the module docstring for the two schedules)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} must divide into {n_micro} microbatches")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule: {schedule!r}")
    mb = b // n_micro
    st = _Stage(blocks, mesh, n_micro, positions.reshape(n_micro, mb, -1), rope, remat)
    out = _Pipeline.apply(st, schedule, x.reshape(n_micro, mb, *x.shape[1:]).contiguous(), *st.params)
    return out.reshape(x.shape)


def _head(decoder: nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, decoder.final_norm.weight)
    head = decoder.embed.embedding if decoder.cfg.tied_embeddings else decoder.lm_head
    return torch.einsum("bsh,vh->bsv", x.float(), head.float())


def _staged(decoder: nn.Module, x: torch.Tensor, mesh: Mesh, n_micro: int, remat: bool, schedule: str):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = (decoder.rope_cos, decoder.rope_sin)
    return pipeline_blocks_forward(stage_blocks(decoder, mesh), x, positions, rope, mesh, n_micro, remat, schedule)


def pipeline_vlm_logits(
    model: nn.Module,  # VideoLM
    patches: torch.Tensor,  # [B, N, patch_dim]
    tokens: torch.Tensor,  # [B, St]
    mesh: Mesh,
    n_micro: int,
    remat: bool = False,
    schedule: str = "gpipe",
) -> torch.Tensor:
    """The VLM's training forward with the decoder's blocks pipelined:
    logits [B, Nv + St, V] on every rank. The vision encoder, the embedding
    and the head run replicated (the Trainer's pipeline path)."""
    decoder = model.decoder
    x = torch.cat([model.encode_video(patches), decoder.embed_tokens(tokens, model.compute_dtype)], dim=1)
    return _head(decoder, _staged(decoder, x, mesh, n_micro, remat, schedule))


def pipeline_decoder_apply(
    decoder: nn.Module,
    tokens: torch.Tensor,  # [B, S]
    mesh: Mesh,
    n_micro: int,
    remat: bool = False,
    schedule: str = "gpipe",
) -> torch.Tensor:
    """The decoder's forward (embed -> staged blocks -> norm -> logits) with
    the blocks pipelined, in the embedding's dtype (JAX's
    ``pipeline_decoder_apply``): equal to ``Decoder.forward`` without a
    cache. ``decoder`` is whole or cut to this rank's stage."""
    x = decoder.embed_tokens(tokens, decoder.embed.embedding.dtype)
    return _head(decoder, _staged(decoder, x, mesh, n_micro, remat, schedule))
