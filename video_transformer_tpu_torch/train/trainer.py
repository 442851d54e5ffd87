"""Distillation training on one device.

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
card machine). Mesh and pipeline parallelism are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..models.config import VLMConfig
from ..models.tokenizer import ByteTokenizer
from ..models.vlm import VideoLM
from ..weights import random_params

__all__ = [
    "AdamW",
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


def lr_schedule(config: TrainConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1),
    0.1 * lr) as a function of the optimizer's update count."""
    peak, warmup = config.learning_rate, config.warmup_steps
    decay = max(config.total_steps, warmup + 1) - warmup
    alpha = 0.1

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the f32 L2 norm over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class AdamW:
    """The JAX package's ``make_optimizer``: optax's
    ``MultiSteps(chain(clip_by_global_norm, adamw(schedule)))`` over
    ``params``, with ``torch.optim.AdamW`` doing the moment update.

    ``update(grads)`` takes one micro-step's gradients. With
    ``accum_steps = k`` it averages k of them (Welford, as MultiSteps does)
    and applies on the k-th; the learning rate is the schedule at the count
    of updates applied so far.
    """

    def __init__(self, params, config: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.config = config
        self.schedule = lr_schedule(config)
        self.inner = torch.optim.AdamW(
            self.params, lr=0.0, betas=(config.b1, config.b2), eps=1e-8,
            weight_decay=config.weight_decay,
        )
        self.count = 0  # updates applied (the inner optimizer's step count)
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> bool:
        """One micro-step; returns whether the parameters were updated."""
        k = self.config.accum_steps
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self.acc, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        norm = global_norm(grads)
        factor = torch.where(norm < self.config.max_grad_norm, 1.0, self.config.max_grad_norm / norm)
        for p, g in zip(self.params, grads):
            p.grad = g * factor.to(g.dtype)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        self.count += 1
        return True


def distillation_loss(
    model: VideoLM,
    patches: torch.Tensor,  # [B, Nv, patch_dim]
    tokens: torch.Tensor,  # [B, St] teacher text (BOS ... EOS PAD*)
    pad_id: int = ByteTokenizer.PAD,
    prompt_lens: torch.Tensor | None = None,  # [B] per-row prompt block widths
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token CE on text positions; video tokens condition only.

    ``prompt_lens`` masks each row's serving prompt block (positions
    0..prompt_lens[i]) out of the loss, per row, as the serving engine sizes
    each prompt's block to its own bucket.
    """
    video_tokens = model.config.video_tokens
    logits = model(patches, tokens)  # [B, Nv + St, V]
    # Position Nv + k - 1 predicts text token k (inputs are [video, text]).
    text_logits = logits[:, video_tokens - 1 : -1, :]
    mask = (tokens != pad_id).float()
    if prompt_lens is not None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        mask = mask * (positions >= prompt_lens[:, None]).float()
    log_probs = torch.log_softmax(text_logits.float(), dim=-1)
    token_ll = log_probs.gather(-1, tokens.long()[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    loss = -(token_ll * mask).sum() / denom
    accuracy = ((text_logits.argmax(dim=-1) == tokens) * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": accuracy, "tokens": mask.sum()}


class Trainer:
    """Owns the model, the optimizer and the step count on one device.

    ``model`` defaults to seeded random f32 weights (``weights.random_params``
    with a generator seeded by ``seed``). ``mesh`` is the JAX trainer's
    (data, model) or pipe mesh: not ported, so anything but None raises.
    """

    def __init__(
        self,
        model_config: VLMConfig,
        train_config: TrainConfig | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        model: VideoLM | None = None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("mesh and pipeline parallelism are not ported (ROADMAP: Parallelism)")
        self.device = torch.device(device)
        self.train_config = train_config or TrainConfig()
        if model is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            model = random_params(model_config, generator, device=self.device, dtype=torch.float32)
        self.model = model.to(self.device)
        self.model.decoder.remat = self.train_config.remat
        self.optimizer = AdamW(self.model.parameters(), self.train_config)
        self.step_count = 0

    def _tensor(self, array) -> torch.Tensor:
        if isinstance(array, torch.Tensor):  # patches preprocessed on the device
            return array.to(self.device)
        return torch.as_tensor(np.asarray(array)).to(self.device)

    def step(self, patches, tokens, prompt_lens=None) -> dict[str, float]:
        """One optimization micro-step; returns host-side metrics.

        ``prompt_lens`` [B] = per-row prompt block widths to mask from the
        loss; defaults to the uniform TrainConfig.prompt_len.
        """
        tokens = self._tensor(tokens)
        if prompt_lens is None:
            prompt_lens = np.full((tokens.shape[0],), self.train_config.prompt_len, np.int32)
        loss, metrics = distillation_loss(
            self.model, self._tensor(patches), tokens, ByteTokenizer.PAD, self._tensor(prompt_lens)
        )
        grads = torch.autograd.grad(loss, self.optimizer.params)
        metrics["grad_norm"] = global_norm(grads)
        self.optimizer.update(grads)
        self.step_count += 1
        names = list(metrics)
        values = torch.stack([metrics[n].float() for n in names]).tolist()
        return dict(zip(names, values))

    # -- checkpointing ---------------------------------------------------------

    def save_checkpoint(self, directory: str | Path) -> Path:
        """Write ``directory/params_{step}/params.pt`` (kept if it exists)."""
        target = Path(directory).resolve() / f"params_{self.step_count}"
        if not target.exists():
            tmp = target.with_name(target.name + ".tmp")
            tmp.mkdir(parents=True, exist_ok=True)
            state = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
            torch.save(state, tmp / "params.pt")
            tmp.rename(target)
        return target

    def restore_checkpoint(self, path: str | Path) -> None:
        """Load a ``params_N`` directory; the step count continues from N."""
        resolved = Path(path).resolve()
        state = torch.load(resolved / "params.pt", map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)
        name = resolved.name
        if name.startswith("params_") and name.split("_")[-1].isdigit():
            self.step_count = int(name.split("_")[-1])
