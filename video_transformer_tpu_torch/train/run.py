"""Training driver CLI.

Distills (clip, teacher-note) pairs into the VideoLM on one device, from
schema-valid synthetic samples (the JAX package's default data path):

  python -m video_transformer_tpu_torch.train.run --preset base \\
      --tokenizer data/tokenizers/bpe-zh-2048.json [--steps 100] [--remat]

The flags and defaults are those of ``python -m video_transformer_tpu.train.run``
plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain versions of
the kernels). Staged video pairs (``--data``), grounded pairs
(``--grounded``) and ``--tp``/``--pp`` above 1 are not ported and raise.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..analyzer.schema import note_dfa
from ..models.config import get_preset
from ..parallel.engine import resolve_params_dir
from .data import synthetic_batch
from .trainer import TrainConfig, Trainer

__all__ = ["build_parser", "main", "make_prompt_sampler", "prepare"]

LOGGER_NAME = "video_transformer_tpu_torch.train"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pack_row(tok, encode_note, text, text_len, prompt, prompt_len, rng):
    """One training row: [BOS + prompt block][note body][EOS], PAD-padded.

    The prompt block width is the serving bucket for this prompt,
    round_up(tokens + 1, 128) capped at ``prompt_len``, as the engine
    computes it, so train and serve positions line up per row. Returns
    (row, block_width).
    """
    prefix: list[int] = []
    block = 0
    if prompt and prompt_len > 0:
        text_prompt = prompt(rng) if callable(prompt) else prompt
        n_tokens = len(tok.encode(text_prompt)) + 1
        block = min(_round_up(n_tokens, 128), prompt_len)
        prefix = list(tok.encode_array(text_prompt, block, add_bos=True))
    body = encode_note(text)[: text_len - len(prefix) - 1] + [tok.EOS]
    if not prefix:
        body = [tok.BOS] + body[: text_len - 1]
    row = np.full((text_len,), tok.PAD, dtype=np.int32)
    ids = prefix + body
    row[: len(ids)] = ids[:text_len]
    return row, block


def make_prompt_sampler(prompt_profile: str):
    """Per-row serving-prompt sampler: the analysis and segment prompts the
    analyzer serves, with randomized duration labels; ``"mixed"`` draws the
    compact or spec profile 50/50 per row."""
    from ..analyzer.prompts import render_prompt
    from ..contracts.timefmt import format_seconds

    def sample_prompt(rng: np.random.Generator) -> str:
        profile = prompt_profile
        if profile == "mixed":
            profile = "spec" if rng.random() < 0.5 else "compact"
        if rng.random() < 0.7:
            return render_prompt(
                "analysis",
                {"duration_label": format_seconds(float(rng.integers(30, 7200)))},
                profile=profile,
            )
        start = float(rng.integers(0, 3600))
        return render_prompt(
            "segment_analysis",
            {
                "segment_index": int(rng.integers(1, 9)),
                "segment_total": int(rng.integers(2, 10)),
                "start_label": format_seconds(start),
                "end_label": format_seconds(start + float(rng.integers(60, 600))),
            },
            profile=profile,
        )

    return sample_prompt


def _synthetic_batches(config, batch, text_len, dfa, prompt, prompt_len):
    rng = np.random.default_rng(0)
    blocks = np.full((batch,), prompt_len if prompt else 0, np.int32)
    while True:
        patches, tokens = synthetic_batch(
            rng, config, batch, text_len, dfa=dfa, prompt=prompt, prompt_len=prompt_len,
        )
        yield patches, tokens, blocks


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="train/distill the VideoLM (PyTorch, one device)")
    parser.add_argument("--preset", default="tiny", choices=["tiny", "base", "7b", "qwen2vl-7b"])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--text-len", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--accum", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1, help="model-axis size (not ported: 1 only)")
    parser.add_argument("--pp", type=int, default=1, help="pipeline stages (not ported: 1 only)")
    parser.add_argument("--pp-micro", type=int, default=4, help="GPipe microbatches (read with --pp only)")
    parser.add_argument("--pp-schedule", default="gpipe", choices=["gpipe", "1f1b"],
                        help="pipeline backward schedule (read with --pp only)")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--data", help="staging dir of (video, note) pairs (not ported)")
    parser.add_argument("--grounded", action="store_true", help="grounded topic-signature pairs (not ported)")
    parser.add_argument("--grounded-composite", type=float, default=0.0)
    parser.add_argument("--grounded-hard-pairs", type=float, default=0.0)
    parser.add_argument("--grounded-attrs", type=float, default=0.0)
    parser.add_argument("--grounded-band", type=float, default=0.0)
    parser.add_argument("--grounded-cache", type=int, default=384)
    parser.add_argument(
        "--tokenizer",
        help="path to a trained BPE vocab (models/bpe.py); resizes the decoder vocab",
    )
    parser.add_argument(
        "--prompt-len", type=int, default=256,
        help="serving prompt block width prepended to each sequence (masked from the loss; 0 disables)",
    )
    parser.add_argument("--prompt-profile", default="compact", choices=["compact", "spec", "mixed"])
    parser.add_argument("--init-from", help="checkpoint (params_N dir or its parent) to initialize from")
    parser.add_argument("--out", default="./data/checkpoints")
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument("--log-dir", default="./data/output/logs")
    parser.add_argument("--device", default="cuda", help="torch device (cuda; cpu runs the plain versions)")
    return parser


def setup_logging(log_dir: str | Path) -> logging.Logger:
    """The training logger: ``log_dir/train.log`` and stderr (idempotent)."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        formatter = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
        for handler in (logging.FileHandler(path / "train.log", encoding="utf-8"), logging.StreamHandler()):
            handler.setFormatter(formatter)
            logger.addHandler(handler)
        logger.propagate = False
    return logger


def prepare(args: argparse.Namespace, logger: logging.Logger):
    """The CLI's set-up: config, trainer and the batch iterator. Adjusts
    ``args`` (prompt_len, text_len) as the JAX driver does."""
    if args.data:
        raise NotImplementedError("--data (staged video pairs) is not ported (ROADMAP: training, staged data)")
    if args.grounded:
        raise NotImplementedError("--grounded (train/grounded.py) is not ported (ROADMAP: training, grounded data)")
    if args.tp > 1 or args.pp > 1:
        raise NotImplementedError("--tp/--pp above 1 are not ported (ROADMAP: Parallelism)")
    if args.prompt_len >= args.text_len:
        args.prompt_len = args.text_len // 2
        logger.info(f"prompt_len clamped to {args.prompt_len} (text_len {args.text_len})")
    config = get_preset(args.preset)
    if args.tokenizer:
        # The synthetic path tokenizes with bytes; the BPE vocab sizes the
        # decoder (the grammar-aligned note encoding serves staged data only).
        from ..models.bpe import BpeTokenizer

        tok = BpeTokenizer.load(args.tokenizer)
        config = replace(config, decoder=replace(config.decoder, vocab_size=tok.vocab_size))
        logger.info(f"bpe tokenizer: {args.tokenizer} vocab={tok.vocab_size} merges={len(tok.merges)}")

    # Align the full sequence (video tokens + text) to 128 so the flash
    # backward kernels engage (other totals take the reference backward).
    total = config.video_tokens + args.text_len
    if total % 128:
        args.text_len += 128 - total % 128
        logger.info(f"text_len aligned to {args.text_len} (seq multiple of 128)")
    logger.info(f"device: {args.device} preset={args.preset}")

    trainer = Trainer(
        config,
        TrainConfig(
            learning_rate=args.lr,
            total_steps=args.steps,
            warmup_steps=max(args.steps // 20, 1),
            accum_steps=args.accum,
            remat=args.remat,
            prompt_len=args.prompt_len,
        ),
        device=args.device,
    )
    prompt = make_prompt_sampler(args.prompt_profile) if args.prompt_len > 0 else None
    logger.info("no --data given: training on schema-valid synthetic pairs")
    batches = _synthetic_batches(
        config, args.batch, args.text_len,
        note_dfa(min(config.decoder.vocab_size, 512)), prompt, args.prompt_len,
    )
    if args.init_from:
        path = resolve_params_dir(args.init_from)
        trainer.restore_checkpoint(path)
        logger.info(f"event=train_init_from checkpoint={path}")
    return config, trainer, batches


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logger = setup_logging(args.log_dir)
    _, trainer, batches = prepare(args, logger)

    start = time.perf_counter()
    tokens_seen = 0
    for step in range(1, args.steps + 1):
        patches, tokens, prompt_lens = next(batches)
        metrics = trainer.step(patches, tokens, prompt_lens)
        tokens_seen += int(metrics.get("tokens", 0))
        if step % 10 == 0 or step == 1:
            elapsed = time.perf_counter() - start
            logger.info(
                f"event=train_step step={step} loss={metrics['loss']:.4f} "
                f"acc={metrics['accuracy']:.3f} grad_norm={metrics['grad_norm']:.3f} "
                f"tokens_per_s={tokens_seen / max(elapsed, 1e-6):.0f}"
            )
        if args.checkpoint_every and step % args.checkpoint_every == 0:
            trainer.save_checkpoint(args.out)
            logger.info(f"event=checkpoint step={step} dir={args.out}")

    trainer.save_checkpoint(args.out)
    logger.info(
        f"event=train_complete steps={args.steps} "
        f"final_loss={metrics['loss']:.4f} checkpoint={args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
