"""Real-footage note-faithfulness evaluation harness.

The port's counterpart of the JAX package's ``train/eval_real.py``, with the
same flags (plus ``--device``), scoring and JSON line. It scores any eval
set of (clip, truth) pairs:

    <eval-dir>/<name>.npzv (or .y4m)     the clip
    <eval-dir>/<name>.truth.json         ground truth:
        {
          "topic": "梯度下降",                 # headline topic (optional)
          "must_mention": ["学习率", ...],     # required keywords
          "should_mention": ["动量", ...],     # credit keywords (optional)
          "forbid": ["欢迎订阅", ...]          # content blacklist (optional)
        }

Per clip: a headline hit (the topic named in title, summary or takeaways),
must coverage (the fraction of must_mention anywhere in the note), should
coverage and forbid violations. One JSON line per run:

    python -m video_transformer_tpu_torch.train.eval_real --eval-dir DIR \
        --preset tiny --checkpoint data/torch_weights/tiny-zh-grounded-r5mix-params_4500.npz \
        --tokenizer data/tokenizers/bpe-zh-2048.json [--stage-out-of-bank 4] \
        [--temperature 0] [--device cpu]

``stage_out_of_bank`` stages a set with no egress from the synthetic banks
(held-out signature clips with their truths); real footage replaces its
files one for one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..analyzer.prompts import render_prompt
from ..analyzer.schema import note_dfa
from ..contracts.timefmt import format_seconds
from ..models.bpe import BpeTokenizer
from ..models.config import get_preset
from ..parallel.engine import InferenceEngine
from ..video.containers import read_frames, write_npzv
from .grounded import TOPIC_BANK, render_topic_clip

__all__ = ["main", "run_real_eval", "score_note", "stage_out_of_bank"]


def _note_fields(text: str) -> tuple[str, str] | None:
    """(headline blob, full note text) or None on parse failure."""
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        return None
    headline = (
        data.get("title", "")
        + data.get("one_sentence_summary", "")
        + " ".join(data.get("key_takeaways", []))
    )
    return headline, json.dumps(data, ensure_ascii=False)


def score_note(text: str, truth: dict) -> dict:
    """Faithfulness scores for one generated note against its truth."""
    fields = _note_fields(text)
    if fields is None:
        return {
            "parsed": False, "headline_hit": False,
            "must_coverage": 0.0, "should_coverage": 0.0, "violations": [],
        }
    headline, full = fields
    topic = truth.get("topic")
    must = truth.get("must_mention", [])
    should = truth.get("should_mention", [])
    forbid = truth.get("forbid", [])
    return {
        "parsed": True,
        "headline_hit": bool(topic) and topic in headline,
        "must_coverage": sum(k in full for k in must) / len(must) if must else 1.0,
        "should_coverage": sum(k in full for k in should) / len(should) if should else 1.0,
        "violations": [k for k in forbid if k in full],
    }


def run_real_eval(
    engine,
    eval_dir: str | Path,
    batch: int = 4,
    profile: str = "compact",
    duration_seconds: int = 120,
) -> dict:
    """Generate and score a note for every (clip, truth) pair in eval_dir."""
    eval_dir = Path(eval_dir)
    pairs = []
    for truth_path in sorted(eval_dir.glob("*.truth.json")):
        stem = truth_path.name[: -len(".truth.json")]
        for ext in (".npzv", ".y4m"):
            clip = eval_dir / f"{stem}{ext}"
            if clip.exists():
                pairs.append((stem, clip, truth_path))
                break
    if not pairs:
        raise FileNotFoundError(f"no (clip, truth) pairs under {eval_dir}")

    config = engine.config
    prompt = render_prompt("analysis", {"duration_label": format_seconds(duration_seconds)}, profile=profile)
    t_frames = config.encoder.num_frames
    size = config.encoder.image_size

    def load(clip: Path) -> np.ndarray:
        picked = read_frames(clip, t_frames)
        if picked.shape[1] != size or picked.shape[2] != size:
            rows = np.linspace(0, picked.shape[1] - 1, size).round().astype(int)
            cols = np.linspace(0, picked.shape[2] - 1, size).round().astype(int)
            picked = picked[:, rows][:, :, cols]
        return picked

    per_clip: dict[str, dict] = {}
    start = time.perf_counter()
    for i in range(0, len(pairs), batch):
        chunk = pairs[i : i + batch]
        frames = np.stack([load(clip) for _, clip, _ in chunk])
        texts = engine.generate(frames, [prompt] * len(chunk))
        for (stem, _, truth_path), text in zip(chunk, texts):
            truth = json.loads(truth_path.read_text(encoding="utf-8"))
            per_clip[stem] = score_note(text, truth)

    n = len(per_clip)
    scores = list(per_clip.values())
    return {
        "clips": n,
        "parse_rate": sum(s["parsed"] for s in scores) / n,
        "headline_hits": sum(s["headline_hit"] for s in scores),
        "must_coverage": round(float(np.mean([s["must_coverage"] for s in scores])), 3),
        "should_coverage": round(float(np.mean([s["should_coverage"] for s in scores])), 3),
        "violation_clips": sum(bool(s["violations"]) for s in scores),
        "wall_seconds": round(time.perf_counter() - start, 2),
        "per_clip": per_clip,
    }


def stage_out_of_bank(
    out_dir: str | Path, count: int, num_frames: int, size: int,
    seed: int = 123, fps: float = 2.0,
) -> list[Path]:
    """Stage an eval set with no egress: held-out signature clips + truths.

    The clips reuse the signature renderer with topic draws from a fresh
    rng, so the set drives the harness end to end and doubles as an
    unseen-clip check.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    # The topic draws come first, in one block, so that which topics a seed
    # selects depends only on (seed, count).
    indices = [int(i) for i in rng.integers(len(TOPIC_BANK), size=count)]
    paths = []
    for i, idx in enumerate(indices):
        topic = TOPIC_BANK[idx]
        clip = out_dir / f"oob_{i:03d}.npzv"
        write_npzv(clip, render_topic_clip(idx, num_frames, size, rng), fps=fps)
        truth = {
            "topic": topic.name,
            "must_mention": [topic.name],
            "should_mention": list(topic.terms),
            "forbid": ["欢迎订阅", "下节课"],
        }
        (out_dir / f"oob_{i:03d}.truth.json").write_text(json.dumps(truth, ensure_ascii=False), encoding="utf-8")
        paths.append(clip)
    return paths


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="real-footage note eval")
    parser.add_argument("--eval-dir", required=True)
    parser.add_argument("--preset", default="base")
    parser.add_argument(
        "--checkpoint",
        help="converted checkpoint (.npz from tools/orbax_to_npz.py), a params_N "
             "directory holding the port trainer's params.pt, or a parent of those",
    )
    parser.add_argument("--tokenizer", help="BPE vocab path (models/bpe.py)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--profile", default="compact", choices=["compact", "spec"])
    parser.add_argument("--quantize", default=None, choices=["int8", "int4"])
    parser.add_argument(
        "--stage-out-of-bank", type=int, default=0, metavar="N",
        help="first stage N held-out synthetic pairs into --eval-dir",
    )
    parser.add_argument("--device", default="cuda", help="torch device (cpu runs the plain kernel versions)")
    args = parser.parse_args(argv)

    config = get_preset(args.preset)
    tokenizer = None
    if args.tokenizer:
        tokenizer = BpeTokenizer.load(args.tokenizer)
        config = replace(config, decoder=replace(config.decoder, vocab_size=tokenizer.vocab_size))
    if args.stage_out_of_bank:
        stage_out_of_bank(args.eval_dir, args.stage_out_of_bank, config.encoder.num_frames, config.encoder.image_size)
    engine = InferenceEngine(
        config,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        tokenizer=tokenizer,
        param_dtype="bfloat16",
        quantize=args.quantize,
        seed=1,
        device=args.device,
    )
    engine.dfa = engine.wrap_grammar(note_dfa(engine.byte_vocab))
    if args.checkpoint:
        engine.restore(args.checkpoint)

    report = run_real_eval(engine, args.eval_dir, args.batch, args.profile)
    print(json.dumps(report, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
