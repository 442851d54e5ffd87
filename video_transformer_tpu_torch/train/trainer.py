"""Distillation training on one device or over a mesh.

The counterpart of the JAX package's ``train/trainer.py``: (clip, teacher
note) pairs train the VideoLM with next-token cross-entropy on the text
tokens (video tokens condition only). Parameters are f32 and the forward
computes in the config's dtype (bf16 for the presets); every attention call
goes through ``ops/attention.py``, so on the card the step's forward runs
K7a and its backward K7b + K7c (K1 plus the reference backward where a
sequence is not a multiple of 128).

The optimizer reproduces optax's chain ``clip_by_global_norm ->
adamw(warmup_cosine_decay_schedule)``, wrapped in ``MultiSteps`` for
gradient accumulation: the schedule starts at 0 (the first update moves
nothing but the moments), ``decay_steps`` counts the warmup, the clip has
no epsilon, and accumulation averages the micro-gradients before the clip.
The ``grad_norm`` metric is the raw micro-step norm. Checkpoints are
``params_{step}/params.pt`` state dicts (orbax is not available on the
card machine).

One device runs JAX's jitted step (``make_train_step``) as one body on a
fixed carry (``Trainer._step_body``): the key's static buffers of the batch,
the loss, ``torch.autograd.grad``, the global norm and the optimizer's
update, whose count, learning rate, bias corrections and Welford divisor
live in device tensors, and the metrics written into a static tensor. The
body reads nothing on the host; ``step`` copies the batch in, runs it and
reads the metrics once. On one card it runs as a replayed CUDA graph
(``parallel/graphs.py``): a key's first step runs eagerly on the graphs'
side stream, then one step is captured. With accumulation the host picks
the body ("accumulate" or "accumulate and apply") from its own micro-step
count, as ``MultiSteps`` picks with ``lax.cond``; each has its graph. A
mesh, ``(data, model)`` or ``("pipe",)``, runs the same body on every rank,
its collectives inside it: as a graph where the mesh's training steps may
be captured (``Mesh.trains_on_graphs``: NCCL), eagerly on gloo (whose
collectives run on the host). On a pipe mesh the body's forward is the
pipeline's tick loop and its ``torch.autograd.grad`` runs the schedule's
backward (GPipe or 1F1B), as JAX jits ``pipeline_vlm_logits`` inside its
step; every stage issues the same collectives in the same order, so the
stages capture and replay in lockstep. The CPU and a trainer whose private
``_eager_step`` is set run the body eagerly too (``stats``).

On a mesh (``parallel/mesh.py``), JAX's two layouts:

- ``(data, model)``: each rank holds its ``PARTITION_RULES`` shard of the
  model, cut by its plan of heads (``parallel/sharding.py::shard_model``;
  the blocks' collectives are the differentiable ones of ``models/lm.py``)
  and its data group's rows of the batch. The loss divides by the masked
  token count of the whole batch (all-reduced over ``data``), and the
  gradients are summed over ``data`` in buckets of ``GRAD_BUCKET_BYTES``,
  so a step equals the 1-rank step on the whole batch. Where ``model`` does
  not divide the kv heads, a kv head's k/v columns live on several ranks,
  each of which computes only its own q heads' share of their gradient:
  one all-reduce over ``model`` sums the shares (each rank adds its copies
  into a buffer of every kv head, zeros elsewhere), so every copy takes the
  whole gradient.
- ``("pipe",)``: each rank holds its stage's blocks
  (``parallel/pipeline_parallel.py``) and the whole batch, split into
  ``pp_microbatches`` microbatches, under ``pp_schedule``.

The global norm sums a split leaf's squares over its axis and counts a
replicated leaf once (a replicated kv head's columns on their first holder
only); a replicated leaf's gradient is whole and the same on every rank, so
the replicas stay bit-equal. Every rank makes its own
weights (a seeded draw that it then cuts, a ``model`` function that it
calls, or ``restore_checkpoint``); ``step``, ``save_checkpoint`` and
``restore_checkpoint`` replay on every rank (``parallel/mesh.py::
replicated``); a checkpoint holds the whole model in the 1-rank layout,
written once.
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..models.config import VLMConfig
from ..models.tokenizer import ByteTokenizer
from ..models.vlm import VideoLM
from ..ops.attention import flash_attention
from ..ops.flash_bwd import flash_bwd_dkv, flash_bwd_dq, flash_fwd_lse
from ..parallel.graphs import GraphPool, StepGraph
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, replicated
from ..parallel.pipeline_parallel import SCHEDULES, pipeline_vlm_logits, shard_stages, stage_range
from ..parallel.sharding import (
    head_plan,
    kv_replicated,
    leaf_ranges,
    shard_block,
    shard_model,
    spec_for_path,
    unshard_tensor,
)
from ..weights import from_state_dict, random_params

__all__ = [
    "AdamW",
    "STEP_KEYS",
    "StepStats",
    "TRAIN_COUNTERS",
    "TrainConfig",
    "Trainer",
    "distillation_loss",
    "global_norm",
    "lr_schedule",
]


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    accum_steps: int = 1
    """Gradient accumulation: the optimizer applies every accum_steps
    micro-steps (effective batch = batch * accum_steps)."""
    remat: bool = False
    """Rematerialize decoder blocks (activation memory for FLOPs)."""
    prompt_len: int = 0
    """Width of the serving prompt block at the start of each sequence
    (masked out of the loss; aligns train positions with inference)."""
    pp_microbatches: int = 4
    """Microbatches a step on a "pipe" mesh (the batch must divide by it;
    utilization n_micro / (n_micro + stages - 1))."""
    pp_schedule: str = "gpipe"
    """Pipeline backward schedule: "gpipe" (each microbatch's graph kept,
    O(n_micro) activations a stage) or "1f1b" (the recompute and backward
    waves, O(stages))."""


GRAD_BUCKET_BYTES = 64 << 20
"""Gradients summed over ``data`` a bucket at a time (one all-reduce each)."""

STEP_KEYS = 4
"""Step keys (batch shapes and dtypes, accumulation) whose carries and
graphs a trainer keeps; the least recently used past this is dropped."""

METRICS = ("loss", "accuracy", "tokens", "grad_norm")

TRAIN_COUNTERS = (flash_attention, (flash_attention, "reference_backwards"), flash_fwd_lse, flash_bwd_dq,
                  flash_bwd_dkv)
"""The counts that a training step moves (``StepGraph``'s ``counters``)."""


def lr_schedule(config: TrainConfig) -> Callable[[torch.Tensor | int], torch.Tensor]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1),
    0.1 * lr) as a function of the optimizer's update count, evaluated in
    float32 as optax evaluates it: a count tensor gives a 0-d float32 tensor
    on its device (an int, one on the CPU), and nothing is read on the host."""
    peak, warmup = config.learning_rate, config.warmup_steps
    decay = max(config.total_steps, warmup + 1) - warmup
    end = peak * 0.1
    alpha = end / peak if peak else 0.0

    def schedule(count: torch.Tensor | int) -> torch.Tensor:
        count = torch.as_tensor(count).float()
        # optax.cosine_decay_schedule(peak, decay, alpha) at count - warmup.
        t = (count - warmup).clamp(max=float(decay))
        cosine = 0.5 * (1 + torch.cos(math.pi * t / decay))
        decayed = (1 - alpha) * cosine + alpha
        lr = decayed * peak
        if warmup <= 0:
            return lr
        # optax.linear_schedule(0, peak, warmup), joined at the warmup boundary.
        frac = 1 - count.clamp(0, warmup) / warmup
        return torch.where(count < warmup, frac * (0.0 - peak) + peak, lr)

    return schedule


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the f32 L2 norm over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class AdamW:
    """The JAX package's ``make_optimizer``: optax's
    ``MultiSteps(chain(clip_by_global_norm, adamw(schedule)))`` over
    ``params``.

    ``update(grads)`` takes one micro-step's gradients. With
    ``accum_steps = k`` it averages k of them (Welford, as MultiSteps does)
    and applies on the k-th; the learning rate is the schedule at the count
    of updates applied so far. The update is optax's ``adamw`` written out
    in a few in-place list ops: bias-corrected first and second moments,
    ``m_hat / (sqrt(v_hat) + eps)``, plus the decoupled weight decay
    ``weight_decay * p``, the sum scaled by the scheduled learning rate.

    Its state lives on the parameters' device, allocated once: the moments,
    the accumulated mean (k > 1), optax's count of updates (``count``) and
    MultiSteps' count of micro-steps accumulated (``mini``), from which
    ``run`` computes the learning rate, the bias corrections and the
    Welford divisor without a host read. The host keeps its own micro-step
    count (``mini_step``), which picks ``run``'s body.
    """

    eps = 1e-8

    def __init__(self, params, config: TrainConfig, norm: Callable | None = None):
        self.params = [p for p in params if p.requires_grad]
        self.config = config
        self.norm = norm or global_norm
        """The clip's global norm (a mesh's sums split leaves over their axis)."""
        self.schedule = lr_schedule(config)
        device = self.params[0].device if self.params else None
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if config.accum_steps > 1 else []
        self.count = torch.zeros((), dtype=torch.int32, device=device)  # updates applied
        self.mini = torch.zeros((), dtype=torch.int32, device=device)  # micro-steps in ``acc``
        self.mini_step = 0  # the same on the host

    @property
    def applies(self) -> bool:
        """Whether the next micro-step applies an update (MultiSteps' ``emit``)."""
        return self.mini_step == max(self.config.accum_steps, 1) - 1

    def update(self, grads: list[torch.Tensor], norm: torch.Tensor | None = None) -> bool:
        """One micro-step; returns whether the parameters were updated.
        ``norm`` is the gradients' global norm when the caller has it (used
        without accumulation, where the clip's norm is the micro-step's)."""
        apply = self.applies
        self.run(grads, norm, apply)
        self.advance()
        return apply

    def advance(self) -> None:
        """The host's micro-step count after a micro-step."""
        self.mini_step = (self.mini_step + 1) % max(self.config.accum_steps, 1)

    @torch.no_grad()
    def run(self, grads: list[torch.Tensor], norm: torch.Tensor | None, apply: bool) -> None:
        """A micro-step's device work, which reads nothing on the host:
        with accumulation, ``grads`` into the mean, then (``apply``) the
        clip and the update on the mean; without, the clip and the update
        on ``grads``."""
        config = self.config
        if config.accum_steps > 1:
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, (self.mini + 1).float())
            torch._foreach_add_(self.acc, delta)
            if not apply:
                self.mini.add_(1)
                return
            grads, norm = self.acc, self.norm(self.acc)
        elif norm is None:
            norm = self.norm(grads)
        factor = torch.where(norm < config.max_grad_norm, 1.0, config.max_grad_norm / norm)
        grads = torch._foreach_mul([g.float() for g in grads], factor.float())
        lr, t = self.schedule(self.count), (self.count + 1).float()
        torch._foreach_mul_(self.mu, config.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - config.b1)
        torch._foreach_mul_(self.nu, config.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - config.b2)
        denom = torch._foreach_div(self.nu, 1 - config.b2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, 1 - config.b1**t)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(step, self.params, alpha=config.weight_decay)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(self.params, step)
        if self.acc:
            torch._foreach_zero_(self.acc)
            self.mini.zero_()
        self.count.add_(1)


def distillation_loss(
    model: VideoLM,
    patches: torch.Tensor,  # [B, Nv, patch_dim]
    tokens: torch.Tensor,  # [B, St] teacher text (BOS ... EOS PAD*)
    pad_id: int = ByteTokenizer.PAD,
    prompt_lens: torch.Tensor | None = None,  # [B] per-row prompt block widths
    logits_fn: Callable | None = None,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token CE on text positions; video tokens condition only.

    ``prompt_lens`` masks each row's serving prompt block (positions
    0..prompt_lens[i]) out of the loss, per row, as the serving engine sizes
    each prompt's block to its own bucket. ``logits_fn(model, patches,
    tokens)`` overrides the forward (the pipeline's). On a mesh with a
    ``data`` axis the rows are this data group's: the loss divides by the
    masked count of every group's rows, so that the groups' gradients sum
    to the whole batch's, and the metrics are the whole batch's.
    """
    video_tokens = model.config.video_tokens
    logits = logits_fn(model, patches, tokens) if logits_fn else model(patches, tokens)  # [B, Nv + St, V]
    # Position Nv + k - 1 predicts text token k (inputs are [video, text]).
    text_logits = logits[:, video_tokens - 1 : -1, :]
    mask = (tokens != pad_id).float()
    if prompt_lens is not None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        mask = mask * (positions >= prompt_lens[:, None]).float()
    log_probs = torch.log_softmax(text_logits.float(), dim=-1)
    token_ll = log_probs.gather(-1, tokens.long()[..., None])[..., 0]
    correct = ((text_logits.argmax(dim=-1) == tokens) * mask).sum()
    ll_sum = (token_ll * mask).sum()
    if mesh is not None and mesh.axis_size(DATA_AXIS) > 1:
        count, ll_total, correct = mesh.all_reduce(torch.stack([mask.sum(), ll_sum.detach(), correct]), DATA_AXIS)
        denom = count.clamp(min=1.0)
        loss = -ll_sum / denom
        return loss, {"loss": -ll_total / denom, "accuracy": correct / denom, "tokens": count}
    denom = mask.sum().clamp(min=1.0)
    loss = -ll_sum / denom
    return loss, {"loss": loss.detach(), "accuracy": correct / denom, "tokens": mask.sum()}


@dataclass
class StepStats:
    """How ``Trainer.step`` ran: ``step_route`` "graph" (a replayed CUDA
    graph of the whole step) or "eager" (the step's ops launched from
    Python), the graphs captured and the seconds their capture took, and
    the replays."""

    step_route: str = ""
    graphs_captured: int = 0
    capture_seconds: float = 0.0
    replays: int = 0


@dataclass
class _StepEntry:
    """A step key's static carry: the batch's buffers, which ``step``
    copies each batch into, the metrics that the body writes
    (``METRICS``), and a graph a body (keyed by whether it applies)."""

    patches: torch.Tensor
    tokens: torch.Tensor
    prompt_lens: torch.Tensor
    metrics: torch.Tensor
    graphs: dict[bool, StepGraph] = field(default_factory=dict)


class Trainer:
    """Owns the model (or a mesh rank's share of it), the optimizer and the
    step count.

    ``model`` defaults to seeded random f32 weights (``weights.random_params``
    with a generator seeded by ``seed``); a VideoLM, or on a mesh a function
    of no arguments that each rank calls (a VideoLM would cross to every
    rank whole). ``mesh`` is JAX's trainer's: a (data, model) mesh or a
    ("pipe",) mesh (``build_pipe_mesh``); each rank takes its mesh device,
    whatever ``device`` says. A mesh of one rank is no mesh.

    ``stats`` (``StepStats``) says how ``step`` ran: "graph" on one card
    and on an NCCL ``(data, model)`` or pipe mesh, "eager" on the CPU, on a
    gloo mesh, or where the private ``_eager_step`` asks for the step's
    plain version (the tests and the smoke set it).
    """

    def __init__(
        self,
        model_config: VLMConfig,
        train_config: TrainConfig | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        model: VideoLM | Callable[[], VideoLM] | None = None,
        mesh: Mesh | None = None,
    ):
        args = {name: value for name, value in locals().items() if name not in ("self", "__class__")}
        mesh = mesh if mesh is not None and mesh.size > 1 else None
        train_config = train_config or TrainConfig()
        if mesh is not None:
            if isinstance(model, torch.nn.Module):
                raise ValueError("on a mesh, model is a function each rank calls (or None: seeded weights), "
                                 "not a model")
            if PIPE_AXIS in mesh.shape:
                stage_range(model_config.decoder.num_layers, mesh)  # raises unless the stages divide the layers
                if train_config.pp_schedule not in SCHEDULES:
                    raise ValueError(f"unknown pipeline schedule: {train_config.pp_schedule!r}")
        self.mesh = mesh
        with mesh.controlled(("new", type(self), (), args)) if mesh else contextlib.nullcontext():
            self._init(model_config, train_config, seed, device, model)
            if mesh:
                mesh.register(self)

    def _init(self, model_config, train_config, seed, device, model):
        mesh = self.mesh
        self.config = model_config
        self.train_config = train_config
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.use_pp = mesh is not None and PIPE_AXIS in mesh.shape
        if model is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            model = random_params(model_config, generator, device=self.device, dtype=torch.float32,
                                  place_block=self._place_block if mesh is not None else None)
        elif not isinstance(model, torch.nn.Module):
            model = model()
        self.model = self._place(model).to(self.device)
        # On a pipe mesh the stages apply per-block remat themselves.
        self.model.decoder.remat = train_config.remat and not self.use_pp
        self._logits_fn = None
        if self.use_pp:
            n_micro = max(train_config.pp_microbatches, 1)
            self._logits_fn = lambda m, patches, tokens: pipeline_vlm_logits(
                m, patches, tokens, mesh, n_micro, remat=train_config.remat, schedule=train_config.pp_schedule)
        with torch.device("meta"):
            whole = {name: tuple(p.shape) for name, p in VideoLM(model_config).named_parameters()}
        named = [(name, p) for name, p in self.model.named_parameters() if p.requires_grad]
        # The leaves that a mesh axis splits (their squares sum over it).
        self._split = [self._split_axis(name, whole) for name, _ in named]
        # The leaves whose kv heads have several holders: {index: (dim, own)},
        # ``own`` the local heads whose squares this rank counts.
        self._kv = {}
        if mesh is not None and not self.use_pp and kv_replicated(model_config.decoder.num_kv_heads, mesh.model):
            own = self._own_kv_heads()
            self._kv = {i: (spec_for_path(tuple(name.split("."))).index(MODEL_AXIS), own)
                        for i, (name, _) in enumerate(named)
                        if name.startswith("decoder.layer_") and name.split(".")[-2] in ("k", "v")}
        self.optimizer = AdamW(self.model.parameters(), train_config, norm=self._global_norm)
        self.step_count = 0
        self.stats = StepStats()
        self._steps: OrderedDict[tuple, _StepEntry] = OrderedDict()
        self._graph_pool = GraphPool(self.device) if self.device.type == "cuda" else None
        self._eager_step = False

    # -- placement -------------------------------------------------------------

    def _place_block(self, block):
        """A mesh rank's share of one freshly drawn block: its shard, or on
        a pipe mesh the block if it is this stage's (None otherwise)."""
        if self.use_pp:
            keep = stage_range(self.config.decoder.num_layers, self.mesh)
            return block if block.attn.layer_idx in keep else None
        return shard_block(block, self.mesh)

    def _place(self, model: VideoLM) -> VideoLM:
        """This rank's share of a whole (or already placed) model, in place."""
        if self.mesh is None:
            return model
        return shard_stages(model, self.mesh) if self.use_pp else shard_model(model, self.mesh)

    def _plan(self, index: int | None = None):
        """The plan of heads of model rank ``index`` (default: this rank's)."""
        cfg, mesh = self.config.decoder, self.mesh
        index = mesh.model_index if index is None else index
        return head_plan(cfg.num_heads, cfg.num_kv_heads, cfg.mlp_dim, mesh.model, index)

    def _own_kv_heads(self) -> list[int]:
        """This rank's local kv heads that no earlier holder holds (the
        copies whose squares the global norm counts)."""
        first: dict[int, tuple[int, int]] = {}
        for r in range(self.mesh.model):
            for t, j in enumerate(self._plan(r).kv_heads):
                first.setdefault(j, (r, t))
        me = self.mesh.model_index
        return [t for t, j in enumerate(self._plan().kv_heads) if first[j] == (me, t)]

    def _model_ranges(self, name: str, shape: tuple) -> list | None:
        """Every model rank's ranges of a leaf split over ``model`` (None:
        a leaf the axis does not split)."""
        if self.mesh.model == 1:
            return None
        if name == "decoder.lm_head":
            if not self.model.decoder.head_sharded:
                return None
            per = shape[0] // self.mesh.model
            return [[(r * per, (r + 1) * per)] for r in range(self.mesh.model)]
        if not name.startswith("decoder.layer_"):
            return None
        path, cfg = tuple(name.split(".")), self.config.decoder
        if leaf_ranges(path, shape, cfg, self._plan()) is None:
            return None
        return [leaf_ranges(path, shape, cfg, self._plan(r)) for r in range(self.mesh.model)]

    def _split_axis(self, name: str, whole: dict) -> str | None:
        if self.mesh is None:
            return None
        if self.use_pp:
            return PIPE_AXIS if name.startswith("decoder.layer_") else None
        return MODEL_AXIS if self._model_ranges(name, whole[name]) is not None else None

    # -- the step ----------------------------------------------------------------

    def _tensor(self, array) -> torch.Tensor:
        if isinstance(array, torch.Tensor):  # patches preprocessed on the device
            return array.to(self.device)
        return torch.as_tensor(np.asarray(array)).to(self.device)

    def _global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the whole model's gradients: a split leaf's
        squares summed over its axis, a replicated leaf's once."""
        if self.mesh is None:
            return global_norm(grads)
        squares = {None: torch.zeros((), device=self.device)}
        d = self.config.decoder.head_dim
        for i, (g, axis) in enumerate(zip(grads, self._split)):
            if i in self._kv:
                dim, own = self._kv[i]
                g = torch.cat([g.narrow(dim, t * d, d) for t in own], dim=dim) if own else g.narrow(dim, 0, 0)
            squares[axis] = squares.get(axis, 0.0) + torch.linalg.vector_norm(g.float()).square()
        total = squares.pop(None)
        for axis, part in squares.items():
            total = total + self.mesh.all_reduce(part, axis)
        return total.sqrt()

    def _sum_over_data(self, grads: tuple[torch.Tensor, ...]) -> list[torch.Tensor]:
        """Every data group's gradients summed, in buckets of
        ``GRAD_BUCKET_BYTES`` (one all-reduce a bucket)."""
        out: list[torch.Tensor] = []
        bucket: list[torch.Tensor] = []
        size = 0
        for i, g in enumerate(grads):
            bucket.append(g)
            size += g.numel() * g.element_size()
            if size >= GRAD_BUCKET_BYTES or i == len(grads) - 1:
                flat = self.mesh.all_reduce(torch.cat([t.reshape(-1) for t in bucket]), DATA_AXIS)
                out.extend(part.view_as(t) for part, t in zip(flat.split([t.numel() for t in bucket]), bucket))
                bucket, size = [], 0
        return out

    def _sum_kv_replicas(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each kv head's gradient summed over its holders (one all-reduce
        over ``model`` of a buffer of every kv head), back into every copy."""
        if not self._kv:
            return grads
        d, heads = self.config.decoder.head_dim, self._plan().kv_heads
        bufs = []
        for i, (dim, _) in self._kv.items():
            g = grads[i]
            shape = list(g.shape)
            shape[dim] = self.config.decoder.num_kv_heads * d
            buf = g.new_zeros(shape)
            for t, j in enumerate(heads):
                buf.narrow(dim, j * d, d).add_(g.narrow(dim, t * d, d))
            bufs.append(buf)
        flat = self.mesh.all_reduce(torch.cat([b.reshape(-1) for b in bufs]), MODEL_AXIS)
        for (i, (dim, _)), part, buf in zip(self._kv.items(), flat.split([b.numel() for b in bufs]), bufs):
            whole = part.view_as(buf)
            grads[i] = torch.cat([whole.narrow(dim, j * d, d) for j in heads], dim=dim) if heads \
                else grads[i]
        return grads

    def loss_and_grads(self, patches, tokens, prompt_lens=None) -> tuple[dict, list[torch.Tensor]]:
        """The step's metrics (tensors) and this rank's gradients, summed
        over ``data``, before any update. On a mesh every rank calls it with
        the whole batch and takes its rows (``step`` replays it)."""
        tokens = self._tensor(tokens)
        if prompt_lens is None:
            prompt_lens = np.full((tokens.shape[0],), self.train_config.prompt_len, np.int32)
        return self._grads(self._tensor(patches), tokens, self._tensor(prompt_lens))

    def _grads(self, patches, tokens, prompt_lens) -> tuple[dict, list[torch.Tensor]]:
        """``loss_and_grads`` on tensors already on the device."""
        data = self.mesh.axis_size(DATA_AXIS) if self.mesh is not None else 1
        if data > 1:
            b = tokens.shape[0]
            if b % data:
                raise ValueError(f"batch {b} must divide over {data} data groups")
            rows = slice(self.mesh.data_index * (b // data), (self.mesh.data_index + 1) * (b // data))
            patches, tokens, prompt_lens = patches[rows], tokens[rows], prompt_lens[rows]
        loss, metrics = distillation_loss(self.model, patches, tokens, ByteTokenizer.PAD, prompt_lens,
                                          logits_fn=self._logits_fn, mesh=self.mesh)
        params = self.optimizer.params
        # A rank with no q heads uses none of its attention leaves: zeros.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
        grads = self._sum_over_data(grads) if data > 1 else grads
        return metrics, self._sum_kv_replicas(grads)

    @replicated
    def step(self, patches, tokens, prompt_lens=None) -> dict[str, float]:
        """One optimization micro-step; returns host-side metrics.

        ``prompt_lens`` [B] = per-row prompt block widths to mask from the
        loss; defaults to the uniform TrainConfig.prompt_len. On a mesh the
        metrics are the whole batch's. One device, and every rank of a
        mesh, copies the batch into its key's buffers, runs ``_step_body`` on
        them (on the graph route a key's first step eagerly on the graphs'
        stream, then as a captured graph) and reads the metrics once.
        """
        if prompt_lens is None:
            prompt_lens = np.full((len(tokens),), self.train_config.prompt_len, np.int32)
        entry = self._step_entry(patches, tokens, prompt_lens)
        apply = self.optimizer.applies
        route = self._step_route()
        self.stats.step_route = route

        def body() -> None:
            self._step_body(entry, apply)

        graph = entry.graphs.get(apply)
        if route == "eager":
            body()
        elif graph is None:
            self._graph_pool.warm(body)
            entry.graphs[apply] = StepGraph(body, 1, self._graph_pool, TRAIN_COUNTERS, mesh=self.mesh)
            self.stats.graphs_captured += 1
            self.stats.capture_seconds += entry.graphs[apply].seconds
        else:
            graph.replay()
            self.stats.replays += 1
        self.optimizer.advance()
        self.step_count += 1
        return dict(zip(METRICS, entry.metrics.tolist()))  # the one host read a step

    def _step_route(self) -> str:
        """"graph" on one card and on a mesh whose training steps may be
        captured (``Mesh.trains_on_graphs``: NCCL over ``(data, model)`` or
        ``pipe``); "eager" on the CPU, on a gloo mesh, or where
        ``_eager_step`` asks for the step's plain version."""
        if self._eager_step:
            return "eager"
        if self.mesh is not None:
            return "graph" if self.mesh.trains_on_graphs else "eager"
        return "graph" if self.device.type == "cuda" else "eager"

    def _step_entry(self, patches, tokens, prompt_lens) -> _StepEntry:
        """The batch's key's entry (made on first use: static buffers of the
        batch's shapes and dtypes, no graph yet), with the batch copied in;
        the least recently used key past ``STEP_KEYS`` is dropped."""
        arrays = [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
                  for a in (patches, tokens, prompt_lens)]
        key = (*((tuple(a.shape), a.dtype) for a in arrays), self.optimizer.config.accum_steps)
        entry = self._steps.get(key)
        if entry is None:
            buffers = [torch.empty(a.shape, dtype=a.dtype, device=self.device) for a in arrays]
            metrics = torch.zeros(len(METRICS), dtype=torch.float32, device=self.device)
            entry = self._steps[key] = _StepEntry(*buffers, metrics)
            while len(self._steps) > STEP_KEYS:
                self._steps.popitem(last=False)
        else:
            self._steps.move_to_end(key)
        for buffer, array in zip((entry.patches, entry.tokens, entry.prompt_lens), arrays):
            buffer.copy_(array)
        return entry

    def _step_body(self, entry: _StepEntry, apply: bool) -> None:
        """One micro-step on ``entry``'s buffers, which reads nothing on the
        host (JAX's ``train_step``): the loss and gradients, their global
        norm, the optimizer's body (``apply``: the update, else the
        accumulation only) and the metrics into ``entry.metrics``."""
        metrics, grads = self._grads(entry.patches, entry.tokens, entry.prompt_lens)
        norm = self._global_norm(grads)
        self.optimizer.run(grads, norm, apply)
        entry.metrics.copy_(torch.stack([metrics["loss"], metrics["accuracy"], metrics["tokens"], norm]).float())

    # -- checkpointing ---------------------------------------------------------

    def _whole_state(self) -> dict[str, torch.Tensor]:
        """The whole model's state in the 1-rank layout and order (on a mesh
        every rank gathers the split leaves)."""
        state = self.model.state_dict()
        if self.mesh is None:
            return {k: v.detach().cpu() for k, v in state.items()}
        with torch.device("meta"):
            names = list(VideoLM(self.config).state_dict())
        mesh = self.mesh
        if self.use_pp:
            keep = self.model.decoder.stage_layers
            per = len(keep)
            for j, i in enumerate(keep):
                prefix = f"decoder.layer_{i}."
                for name in [k for k in state if k.startswith(prefix)]:
                    parts = mesh.all_gather(state.pop(name)[None], PIPE_AXIS, dim=0)
                    for s in range(mesh.axis_size(PIPE_AXIS)):
                        state[f"decoder.layer_{s * per + j}.{name[len(prefix):]}"] = parts[s]
        else:
            with torch.device("meta"):
                whole = VideoLM(self.config).state_dict()
            for name, t in list(state.items()):
                shape = tuple(whole[name].shape)
                ranges = self._model_ranges(name, shape)
                if ranges is None:
                    continue
                # Parts of unequal widths: each padded to the widest, gathered, then placed.
                dim = spec_for_path(tuple(name.split("."))).index(MODEL_AXIS)
                padded = list(t.shape)
                padded[dim] = max(sum(b - a for a, b in r) for r in ranges)
                buf = t.new_zeros(padded)
                buf.narrow(dim, 0, t.shape[dim]).copy_(t)
                parts = mesh.all_gather(buf[None], MODEL_AXIS, dim=0)
                state[name] = unshard_tensor(list(parts), ranges, dim, t.new_empty(shape))
        return {k: state[k].detach().cpu() for k in names}

    @replicated
    def save_checkpoint(self, directory: str | Path) -> Path:
        """Write ``directory/params_{step}/params.pt`` (kept if it exists):
        the whole model, in the 1-rank layout, written once (by rank 0 of a
        mesh)."""
        target = Path(directory).resolve() / f"params_{self.step_count}"
        state = self._whole_state() if self.mesh is not None or not target.exists() else None
        if (self.mesh is None or self.mesh.rank == 0) and not target.exists():
            tmp = target.with_name(target.name + ".tmp")
            tmp.mkdir(parents=True, exist_ok=True)
            torch.save(state, tmp / "params.pt")
            tmp.rename(target)
        return target

    @replicated
    def restore_checkpoint(self, path: str | Path) -> None:
        """Load a ``params_N`` directory (a whole model; on a mesh each rank
        keeps its share) into the parameters' own tensors, so that the step
        graphs stay valid; the step count continues from N."""
        resolved = Path(path).resolve()
        state = torch.load(resolved / "params.pt", map_location="cpu", weights_only=True)
        placed = self._place(from_state_dict(state, self.config, device="cpu")).state_dict()
        own = self.model.state_dict()
        if set(placed) != set(own):
            raise KeyError(f"checkpoint {resolved} does not fit: {sorted(set(placed) ^ set(own))[:4]}")
        with torch.no_grad():
            for name, tensor in own.items():
                tensor.copy_(placed[name])
        name = resolved.name
        if name.startswith("params_") and name.split("_")[-1].isdigit():
            self.step_count = int(name.split("_")[-1])
