"""Training driver CLI.

Distills (clip, teacher-note) pairs into the VideoLM, on one device or
over a mesh. Data
comes from a staging directory (``--data``: <id>.<ext> + <id>.note.json
pairs, see train/data.py), from grounded topic-signature pairs rendered on
the host (``--grounded``, train/grounded.py) or, when neither is given, from
schema-valid synthetic samples:

  python -m video_transformer_tpu_torch.train.run --preset base \\
      --tokenizer data/tokenizers/bpe-zh-2048.json [--grounded | --data DIR] \\
      [--steps 100] [--remat]

The flags and defaults are those of ``python -m video_transformer_tpu.train.run``
plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain versions of
the kernels). With ``--tokenizer``, notes are tokenized by the note grammar's
``encode_aligned``. For the same arguments the staged and grounded batches
equal the JAX training CLI's (patches preprocessed in float32 on the trainer's
device).

The mesh, as JAX's CLI builds it: ``--pp N`` trains on a ("pipe",) mesh of
N stages (``--pp-micro`` microbatches, the batch rounded up to them,
``--pp-schedule``); otherwise a (data, model) mesh with ``--tp`` on
``model`` and ``data`` over the remaining ranks (the batch rounded up to
``data``). The ranks are one a visible card on CUDA, and on ``--device
cpu`` as many CPU ranks as ``--tp`` or ``--pp`` name; this process is rank 0
and starts the others. Under ``torchrun`` every process joins the world and
the ranks other than 0 serve rank 0's calls. ``--pp`` with ``--tp`` exits.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..analyzer.schema import note_dfa
from ..models.config import get_preset
from ..models.tokenizer import ByteTokenizer
from ..ops.preprocess import preprocess_frames
from ..parallel.engine import resolve_params_dir
from ..parallel.mesh import (build_mesh, build_pipe_mesh, default_devices, maybe_initialize_distributed,
                             mesh_devices, serve)
from .data import distillation_records, synthetic_batch
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


def _frames_to_patches(frames, config, device="cpu") -> torch.Tensor:
    """uint8 frames [B, T, H, W, 3] -> float32 patches on ``device``."""
    frames_t = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    return preprocess_frames(frames_t, config.encoder, torch.float32)


def _staged_batches(data_dir, config, batch, text_len, logger, prompt=None,
                    prompt_len=0, tok=None, encode_note=None, device="cpu"):
    """Cycle over staged (video, note) pairs, yielding device-ready batches."""
    import json

    from ..video.containers import read_frames

    tok = tok or ByteTokenizer(config.decoder.vocab_size)
    encode_note = encode_note or (lambda text: tok.encode(text))
    records = list(distillation_records(data_dir))
    if not records:
        raise SystemExit(f"no (video, note) pairs found under {data_dir}")
    logger.info(f"staged records: {len(records)}")
    rng = np.random.default_rng(0)
    cursor = 0
    while True:
        patches_list, tokens_list, blocks = [], [], []
        for _ in range(batch):
            video, note = records[cursor % len(records)]
            cursor += 1
            frames = read_frames(video, config.encoder.num_frames)  # clips may differ in size
            patches_list.append(_frames_to_patches(frames[None], config, device)[0])
            text = json.dumps(note, ensure_ascii=False)
            row, block = _pack_row(tok, encode_note, text, text_len, prompt, prompt_len, rng)
            tokens_list.append(row)
            blocks.append(block)
        yield (
            torch.stack(patches_list),
            np.stack(tokens_list),
            np.asarray(blocks, np.int32),
        )


def _grounded_batches(config, batch, text_len, logger, prompt=None,
                      prompt_len=0, tok=None, encode_note=None, seed=0,
                      cache_size=384, composite_p=0.0, band_p=0.0,
                      attrs_p=0.0, hard_pairs_p=0.0, device="cpu"):
    """Grounded pairs: frames carry the note's topic signature.

    A pool of ``cache_size`` samples is rendered once and batches draw from
    it, each draw jittered anew (``augment``); cache_size=0 renders every
    sample. One ``np.random.default_rng(seed)`` stream feeds ``sample``,
    ``augment`` and the picks in the JAX training CLI's order, so a seed gives
    its batches.
    """
    import json

    from .grounded import (
        TOPIC_BANK,
        composite_note,
        grounded_note,
        render_band_clip,
        render_composite_clip,
        render_topic_clip,
    )

    tok = tok or ByteTokenizer(config.decoder.vocab_size)
    encode_note = encode_note or (lambda text: tok.encode(text))
    rng = np.random.default_rng(seed)

    def sample():
        idx = int(rng.integers(len(TOPIC_BANK)))
        draw = rng.random()
        if composite_p > 0 and draw < composite_p:
            # Compositional pair: two signatures in one clip, the note covers both.
            if hard_pairs_p > 0 and rng.random() < hard_pairs_p:
                # Hard negatives: a partner among the 4 nearest hues, so that
                # the band detector learns the fine hue margins.
                hues = (np.arange(len(TOPIC_BANK)) * 0.618034) % 1.0
                d = np.abs(hues - hues[idx])
                d = np.minimum(d, 1.0 - d)
                d[idx] = np.inf
                near = np.argsort(d)[:4]
                other = int(near[int(rng.integers(len(near)))])
            else:
                other = int(rng.integers(len(TOPIC_BANK) - 1))
                other += other >= idx
            frames = render_composite_clip(
                idx, other, config.encoder.num_frames, config.encoder.image_size, rng,
            )
            note = composite_note(TOPIC_BANK[idx], TOPIC_BANK[other], rng)
        elif band_p > 0 and draw < composite_p + band_p:
            # Curriculum: the band region alone carries the signature; the
            # note is the ordinary single-topic note.
            frames = render_band_clip(idx, config.encoder.num_frames, config.encoder.image_size, rng)
            note = grounded_note(TOPIC_BANK[idx], rng)
        else:
            attrs = None
            if attrs_p > 0 and rng.random() < attrs_p:
                # Frame attributes drawn independently of the topic and
                # stated in the note: only this clip's pixels predict them.
                attrs = (int(rng.integers(3)), int(rng.integers(1, 6)))
            frames = render_topic_clip(
                idx, config.encoder.num_frames, config.encoder.image_size, rng,
                orient=None if attrs is None else attrs[0],
                n_shapes=None if attrs is None else attrs[1],
            )
            note = grounded_note(TOPIC_BANK[idx], rng, attrs=attrs)
        text = json.dumps(note, ensure_ascii=False)
        row, block = _pack_row(tok, encode_note, text, text_len, prompt, prompt_len, rng)
        return frames, row, block

    def augment(frames: np.ndarray) -> np.ndarray:
        """Photometric and temporal jitter, so that a cached clip never
        repeats pixel for pixel; the signatures survive every change."""
        out = frames.astype(np.float32)
        out *= rng.uniform(0.82, 1.18)  # brightness
        out += rng.uniform(-12.0, 12.0)  # offset
        out += rng.normal(0.0, rng.uniform(0.0, 6.0), out.shape)  # sensor noise
        shift = int(rng.integers(0, frames.shape[0]))  # temporal phase
        out = np.roll(out, shift, axis=0)
        if rng.random() < 0.2:  # temporal reversal: the signatures are direction-free
            out = out[::-1]
        # Spatial translation with wrap-around, off the patch grid; small
        # vertically so that composite band boundaries barely smear.
        size = frames.shape[1]
        dy = int(rng.integers(-(size // 32), size // 32 + 1))
        dx = int(rng.integers(-(size // 8), size // 8 + 1))
        out = np.roll(out, (dy, dx), axis=(1, 2))
        return np.clip(out, 0.0, 255.0).astype(np.uint8)

    def to_batch(drawn):
        frames = np.stack([augment(d[0]) for d in drawn])
        return (
            _frames_to_patches(frames, config, device),
            np.stack([d[1] for d in drawn]),
            np.asarray([d[2] for d in drawn], np.int32),
        )

    if cache_size > 0:
        logger.info(
            f"grounded corpus: {len(TOPIC_BANK)} topics, caching "
            f"{cache_size} samples (per-draw jitter)"
        )
        pool = [sample() for _ in range(cache_size)]
        while True:
            picks = rng.integers(0, cache_size, size=batch)
            yield to_batch([pool[i] for i in picks])

    logger.info(f"grounded corpus: {len(TOPIC_BANK)} topics, on-the-fly")
    while True:
        yield to_batch([sample() for _ in range(batch)])


def _synthetic_batches(config, batch, text_len, dfa, prompt, prompt_len):
    rng = np.random.default_rng(0)
    blocks = np.full((batch,), prompt_len if prompt else 0, np.int32)
    while True:
        patches, tokens = synthetic_batch(
            rng, config, batch, text_len, dfa=dfa, prompt=prompt, prompt_len=prompt_len,
        )
        yield patches, tokens, blocks


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="train/distill the VideoLM (PyTorch)")
    parser.add_argument("--preset", default="tiny", choices=["tiny", "base", "7b", "qwen2vl-7b"])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--text-len", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--accum", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1, help="model-axis size (tensor parallelism)")
    parser.add_argument("--pp", type=int, default=1, help="pipeline stages (exclusive with --tp)")
    parser.add_argument("--pp-micro", type=int, default=4, help="pipeline microbatches (read with --pp only)")
    parser.add_argument("--pp-schedule", default="gpipe", choices=["gpipe", "1f1b"],
                        help="pipeline backward schedule (read with --pp only)")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--data", help="staging dir of (video, note) pairs")
    parser.add_argument(
        "--grounded", action="store_true",
        help="train on grounded topic-signature pairs (frames determine the note content; see train/grounded.py)",
    )
    parser.add_argument("--grounded-composite", type=float, default=0.0,
                        help="probability of two-signature pairs (the note covers both topics)")
    parser.add_argument("--grounded-hard-pairs", type=float, default=0.0,
                        help="within composite draws: probability that the partner is one of the 4 nearest hues")
    parser.add_argument("--grounded-attrs", type=float, default=0.0,
                        help="probability that a single-topic sample randomizes and states its frame attributes")
    parser.add_argument("--grounded-band", type=float, default=0.0,
                        help="probability of band-only curriculum samples")
    parser.add_argument("--grounded-cache", type=int, default=384,
                        help="size of the pre-rendered grounded sample pool (0 = render every sample)")
    parser.add_argument(
        "--tokenizer",
        help="path to a trained BPE vocab (models/bpe.py); resizes the decoder vocab and uses "
             "grammar-aligned note tokenization",
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


def build_train_mesh(args: argparse.Namespace, logger: logging.Logger):
    """The mesh of JAX's training CLI, and the batch rounded up to what it
    divides into (``args.batch`` is adjusted)."""
    if args.pp > 1:
        if args.tp > 1:
            raise SystemExit("--pp and --tp are mutually exclusive")
        devices = [args.device] * args.pp if torch.device(args.device).type == "cpu" else default_devices()
        mesh = build_pipe_mesh(args.pp, devices)
        round_to = args.pp_micro
    else:
        mesh = build_mesh({"model": args.tp}, mesh_devices(args.device, {"model": args.tp}))
        round_to = mesh.data
    if args.batch % round_to:
        args.batch = _round_up(args.batch, round_to)
        logger.info(f"batch rounded up to {args.batch} (divisor {round_to})")
    logger.info(f"mesh: {mesh.shape} preset={args.preset}")
    return mesh


def prepare(args: argparse.Namespace, logger: logging.Logger):
    """The CLI's set-up: config, mesh, trainer and the batch iterator.
    Adjusts ``args`` (prompt_len, text_len, batch) as the JAX training CLI
    does."""
    if args.prompt_len >= args.text_len:
        args.prompt_len = args.text_len // 2
        logger.info(f"prompt_len clamped to {args.prompt_len} (text_len {args.text_len})")
    config = get_preset(args.preset)
    # Optional BPE tokenizer: resize the decoder vocab and tokenize notes
    # with the grammar-aligned segmentation of the constrained decode loop.
    tok = None
    encode_note = None
    if args.tokenizer:
        from ..models.bpe import BpeTokenizer
        from ..ops.token_grammar import TokenGrammar

        tok = BpeTokenizer.load(args.tokenizer)
        config = replace(config, decoder=replace(config.decoder, vocab_size=tok.vocab_size))
        encode_note = TokenGrammar(note_dfa(512), tok).encode_aligned
        logger.info(f"bpe tokenizer: {args.tokenizer} vocab={tok.vocab_size} merges={len(tok.merges)}")

    # Align the full sequence (video tokens + text) to 128 so the flash
    # backward kernels engage (other totals take the reference backward).
    total = config.video_tokens + args.text_len
    if total % 128:
        args.text_len += 128 - total % 128
        logger.info(f"text_len aligned to {args.text_len} (seq multiple of 128)")
    logger.info(f"device: {args.device} preset={args.preset}")
    mesh = build_train_mesh(args, logger)

    trainer = Trainer(
        config,
        TrainConfig(
            learning_rate=args.lr,
            total_steps=args.steps,
            warmup_steps=max(args.steps // 20, 1),
            accum_steps=args.accum,
            remat=args.remat,
            prompt_len=args.prompt_len,
            pp_microbatches=args.pp_micro,
            pp_schedule=args.pp_schedule,
        ),
        device=args.device,
        mesh=mesh,
    )
    prompt = make_prompt_sampler(args.prompt_profile) if args.prompt_len > 0 else None
    if args.data:
        batches = _staged_batches(
            args.data, config, args.batch, args.text_len, logger,
            prompt=prompt, prompt_len=args.prompt_len,
            tok=tok, encode_note=encode_note, device=trainer.device,
        )
    elif args.grounded:
        batches = _grounded_batches(
            config, args.batch, args.text_len, logger,
            prompt=prompt, prompt_len=args.prompt_len,
            tok=tok, encode_note=encode_note,
            cache_size=args.grounded_cache,
            composite_p=args.grounded_composite,
            band_p=args.grounded_band,
            attrs_p=args.grounded_attrs,
            hard_pairs_p=args.grounded_hard_pairs,
            device=trainer.device,
        )
    else:
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
    if maybe_initialize_distributed() and torch.distributed.get_rank() != 0:
        serve()  # a torchrun worker: replay rank 0's calls until it stops the mesh
        return 0
    logger = setup_logging(args.log_dir)
    _, trainer, batches = prepare(args, logger)
    try:
        return _train(args, logger, trainer, batches)
    finally:
        if trainer.mesh is not None:
            trainer.mesh.close()


def _train(args, logger, trainer, batches) -> int:
    start = time.perf_counter()
    first_done = start
    tokens_seen = 0
    for step in range(1, args.steps + 1):
        patches, tokens, prompt_lens = next(batches)
        metrics = trainer.step(patches, tokens, prompt_lens)
        tokens_seen += int(metrics.get("tokens", 0))
        if step == 1:
            first_done = time.perf_counter()  # the first step sets up (on the card: warm-up and capture)
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

    # Every step but the first, batches included (0 for a run of one step).
    later_ms = (time.perf_counter() - first_done) * 1e3 / max(args.steps - 1, 1)
    trainer.save_checkpoint(args.out)
    logger.info(
        f"event=train_complete steps={args.steps} "
        f"final_loss={metrics['loss']:.4f} first_step_ms={(first_done - start) * 1e3:.1f} "
        f"later_step_ms={later_ms:.1f} step_route={trainer.stats.step_route} checkpoint={args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
