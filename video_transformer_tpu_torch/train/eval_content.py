"""Note-content quality eval: does the note body carry the topic's content?

The port's counterpart of the JAX package's ``train/eval_content.py``, with
the same flags (plus ``--device``), seeds (clip rng 99, attribute rng 311)
and JSON line. Topic naming (``train/eval_grounding.py``) is shallow: a
note can name the right topic in its title while its deep_dive or glossary
carry another topic's content. Each topic of the bank determines the
content signature its teacher notes encode (``train/grounded.py``): the
name, two glossary terms, the action phrase and the gloss. This eval scores
each clip's coverage of that signature in the fields that should carry it,
plus the 100-point validator rubric (``pipeline/validator.py``) over the
rendered Markdown.

  python -m video_transformer_tpu_torch.train.eval_content --preset tiny \
      --checkpoint data/torch_weights/tiny-zh-grounded-r5mix-params_4500.npz \
      --tokenizer data/tokenizers/bpe-zh-2048.json [--topics 16] [--batch 4] \
      [--temperature 0] [--device cpu]

Prints one JSON line:
  {"content_coverage": mean, "rubric_mean": mean, "per_topic": {...}, ...}
Exit 0 when mean coverage >= --coverage-floor (default 0.75), else 1.

A contract or render failure scores the rubric 0, as in the JAX eval; a
device error raised while the model judges re-raises (the port's rule at
every such catch, ``utils/pacer.py::_is_device_error``).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from dataclasses import replace

import numpy as np

from ..analyzer.prompts import render_prompt
from ..analyzer.schema import note_dfa
from ..contracts.knowledge import AnalysisResult
from ..contracts.timefmt import format_seconds
from ..models.bpe import BpeTokenizer
from ..models.config import get_preset
from ..parallel.engine import InferenceEngine
from ..pipeline.validator import ConsistencyValidator
from ..utils.counter import APICounter
from ..utils.pacer import _is_device_error
from .grounded import COUNT_NAMES, ORIENT_NAMES, TOPIC_BANK, render_topic_clip

__all__ = ["main", "content_checks", "run_content_eval", "run_attr_eval", "stated_attrs"]

_ORIENT_RE = re.compile(f"({'|'.join(ORIENT_NAMES)})条纹")
_COUNT_RE = re.compile(f"({'|'.join(COUNT_NAMES)})个(?:移动)?方块")


def _deep_dive_text(chapters) -> str:
    """All text under deep_dive, flattened."""
    return json.dumps(chapters, ensure_ascii=False) if chapters else ""


def content_checks(note: dict, topic) -> dict[str, bool]:
    """Field-targeted coverage of ``topic``'s content signature in ``note``.

    Every check mirrors where the teacher note puts the information, so a
    perfectly distilled model scores 1.0 and one that only learned to name
    the title scores about 0.2.
    """
    t1, t2 = topic.terms
    title = str(note.get("title", ""))
    summary = str(note.get("one_sentence_summary", ""))
    takeaways = " ".join(str(t) for t in note.get("key_takeaways", []) or [])
    chapters = note.get("deep_dive") or []
    dd_text = _deep_dive_text(chapters)
    glossary = note.get("glossary") or {}
    gloss_keys = " ".join(str(k) for k in glossary)
    gloss_values = " ".join(str(v) for v in glossary.values())
    schemas = json.dumps(note.get("visual_schemas", []), ensure_ascii=False)

    chapter_titles = [str(ch.get("chapter_title", "")) for ch in chapters if isinstance(ch, dict)]
    named_chapters = sum(1 for ct in chapter_titles if topic.name in ct)

    return {
        "title_names_topic": topic.name in title,
        "summary_states_action": topic.action in summary,
        "takeaways_use_terms": (t1 in takeaways) or (t2 in takeaways),
        "chapters_name_topic": bool(chapter_titles) and named_chapters * 2 >= len(chapter_titles),
        "deep_dive_covers_terms": (t1 in dd_text) and (t2 in dd_text),
        "glossary_keys_topic": topic.name[:4] in gloss_keys,
        "glossary_keys_term": (t1[:4] in gloss_keys) or (t2[:4] in gloss_keys),
        "gloss_faithful": topic.gloss[:6] in gloss_values,
        "schema_mentions_topic": (topic.name in schemas) or (t1 in schemas) or (t2 in schemas),
    }


def stated_attrs(note: dict) -> tuple[int | None, int | None]:
    """(orient, n_shapes) the note claims, or None per unstated/ambiguous.

    Looks for the teacher's phrasings ("X向条纹", "N个[移动]方块") in the
    takeaways and glossary values; conflicting claims parse as None, so a
    model listing every orientation scores no hit.
    """
    blob = " ".join(str(t) for t in (note.get("key_takeaways") or [])) + " " + " ".join(
        str(v) for v in (note.get("glossary") or {}).values()
    )
    orients = {m.group(1) for m in _ORIENT_RE.finditer(blob)}
    counts = {m.group(1) for m in _COUNT_RE.finditer(blob)}
    orient = ORIENT_NAMES.index(next(iter(orients))) if len(orients) == 1 else None
    count = COUNT_NAMES.index(next(iter(counts))) + 1 if len(counts) == 1 else None
    return orient, count


def run_attr_eval(engine, n_clips: int, batch: int, seed: int = 311, profile: str = "compact") -> dict:
    """Frame-attribute grounding: random (topic, orient, shape-count) clips;
    a hit requires the note to state this clip's attribute. The attributes
    are drawn independently of the topic, so class identity cannot
    shortcut the answer."""
    rng = np.random.default_rng(seed)
    config = engine.config
    prompt = render_prompt("analysis", {"duration_label": format_seconds(120)}, profile=profile)
    t_frames = config.encoder.num_frames
    size = config.encoder.image_size

    draws = [
        (int(rng.integers(len(TOPIC_BANK))), int(rng.integers(3)), int(rng.integers(1, 6)))
        for _ in range(n_clips)
    ]
    rows = []
    for i in range(0, len(draws), batch):
        chunk = draws[i : i + batch]
        frames = np.stack([render_topic_clip(t, t_frames, size, rng, orient=o, n_shapes=c) for t, o, c in chunk])
        texts = engine.generate(frames, [prompt] * len(chunk))
        for (t, o, c), text in zip(chunk, texts):
            try:
                note = json.loads(text)
            except json.JSONDecodeError:
                rows.append({"topic": t, "parse": False})
                continue
            so, sc = stated_attrs(note)
            rows.append({
                "topic": t,
                "parse": True,
                "stated": so is not None or sc is not None,
                "orient_hit": so == o,
                "count_hit": sc == c,
                "topic_hit": TOPIC_BANK[t].name in str(note.get("title", "")),
            })
    parsed = [r for r in rows if r.get("parse")]
    n = max(len(parsed), 1)
    return {
        "clips": len(draws),
        "parse_rate": round(len(parsed) / max(len(rows), 1), 3),
        "stated_rate": round(sum(r["stated"] for r in parsed) / n, 3),
        "orient_acc": round(sum(r["orient_hit"] for r in parsed) / n, 3),
        "count_acc": round(sum(r["count_hit"] for r in parsed) / n, 3),
        "both_acc": round(sum(r["orient_hit"] and r["count_hit"] for r in parsed) / n, 3),
        "topic_acc": round(sum(r["topic_hit"] for r in parsed) / n, 3),
    }


def _contamination(note_text: str, topic, bank) -> int:
    """How many other topics' names the note mentions: content confusion
    that topic-naming hit rates cannot see."""
    return sum(1 for t in bank if t.name != topic.name and t.name in note_text)


def run_content_eval(
    engine,
    topic_ids: list[int],
    batch: int,
    seed: int = 99,
    profile: str = "compact",
    use_model_judge: bool = True,
) -> dict:
    """Generate one note per topic clip and score its content and rubric.

    Clips draw from the same rng stream as the grounding eval (seed 99), so
    the coverage table scores the clips the topic hit rates are reported on.
    """
    rng = np.random.default_rng(seed)
    config = engine.config
    prompt = render_prompt("analysis", {"duration_label": format_seconds(120)}, profile=profile)
    t_frames = config.encoder.num_frames
    size = config.encoder.image_size

    validator = ConsistencyValidator(
        {"validator": {"threshold": 75, "use_engine": use_model_judge}},
        APICounter(max_calls=10_000, hard_max_calls=10_000),
        engine=engine if use_model_judge else None,
    )

    per_topic: dict[str, dict] = {}
    start = time.perf_counter()
    for i in range(0, len(topic_ids), batch):
        ids = topic_ids[i : i + batch]
        frames = np.stack([render_topic_clip(t, t_frames, size, rng) for t in ids])
        texts = engine.generate(frames, [prompt] * len(ids))
        for t, text in zip(ids, texts):
            topic = TOPIC_BANK[t]
            row: dict = {"parse": False}
            try:
                note = json.loads(text)
            except json.JSONDecodeError:
                per_topic[topic.name] = row
                continue
            row["parse"] = True
            checks = content_checks(note, topic)
            row["checks"] = checks
            row["coverage"] = round(sum(checks.values()) / len(checks), 3)
            row["contamination"] = _contamination(text, topic, TOPIC_BANK)

            # The validator rubric over the rendered Markdown (what a user
            # reads); a contract or render failure scores 0, as the
            # pipeline does.
            schema_str = ""
            schemas = note.get("visual_schemas") or []
            if schemas and isinstance(schemas[0], dict):
                schema_str = str(schemas[0].get("schema") or schemas[0].get("description", ""))
            try:
                markdown = AnalysisResult.from_api_response("eval_clip", note).to_markdown(self_check_mode="static")
                verdict = validator.validate(schema_str, markdown)
                row["rubric"] = {
                    "total": round(verdict.total_score, 1),
                    "passed": verdict.passed,
                    **{k: round(v, 1) for k, v in verdict.dimension_scores.items()},
                }
            except Exception as exc:  # contract gate / render failure
                if _is_device_error(exc):
                    raise
                row["rubric"] = {"total": 0.0, "passed": False, "error": str(exc)[:120]}
            per_topic[topic.name] = row

    parsed = [r for r in per_topic.values() if r.get("parse")]
    coverages = [r["coverage"] for r in parsed if "coverage" in r]
    rubric_totals = [r["rubric"]["total"] for r in parsed if "rubric" in r]
    check_names = next((list(r["checks"]) for r in parsed if "checks" in r), [])
    per_check = {
        name: round(sum(r["checks"][name] for r in parsed if "checks" in r) / max(len(parsed), 1), 3)
        for name in check_names
    }
    return {
        "content_coverage": round(float(np.mean(coverages)) if coverages else 0.0, 3),
        "rubric_mean": round(float(np.mean(rubric_totals)) if rubric_totals else 0.0, 1),
        "rubric_pass_rate": round(
            sum(1 for r in parsed if r.get("rubric", {}).get("passed")) / max(len(parsed), 1), 3
        ),
        "parse_rate": round(len(parsed) / max(len(per_topic), 1), 3),
        "contamination_mean": round(
            float(np.mean([r.get("contamination", 0) for r in parsed])) if parsed else 0.0, 2
        ),
        "per_check": per_check,
        "per_topic": per_topic,
        "wall_seconds": round(time.perf_counter() - start, 2),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="note-content quality eval")
    parser.add_argument("--preset", default="tiny")
    parser.add_argument(
        "--checkpoint", required=True,
        help="converted checkpoint (.npz from tools/orbax_to_npz.py), a params_N "
             "directory holding the port trainer's params.pt, or a parent of those",
    )
    parser.add_argument("--tokenizer", help="BPE vocab path (models/bpe.py)")
    parser.add_argument("--topics", type=int, default=16)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--max-new-tokens", type=int, default=1536)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--quantize", default=None, choices=["int8", "int4"])
    parser.add_argument("--prompt-profile", default="compact", choices=["compact", "spec"])
    parser.add_argument(
        "--no-model-judge", action="store_true",
        help="structural rubric only (no second on-device judgment pass)",
    )
    parser.add_argument(
        "--coverage-floor", type=float, default=0.75,
        help="exit 1 when mean content coverage lands below this",
    )
    parser.add_argument(
        "--attrs", type=int, default=0,
        help="additionally score N frame-attribute clips (randomized orientation/shape count "
             "stated in the note; requires an attrs-trained checkpoint to score above chance)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (cpu runs the plain kernel versions)")
    args = parser.parse_args(argv)

    config = get_preset(args.preset)
    tokenizer = None
    if args.tokenizer:
        tokenizer = BpeTokenizer.load(args.tokenizer)
        config = replace(config, decoder=replace(config.decoder, vocab_size=tokenizer.vocab_size))
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
    engine.restore(args.checkpoint)

    n = min(args.topics, len(TOPIC_BANK))
    stride = max(len(TOPIC_BANK) // n, 1)
    topic_ids = [(i * stride) % len(TOPIC_BANK) for i in range(n)]

    report = run_content_eval(
        engine, topic_ids, args.batch, profile=args.prompt_profile, use_model_judge=not args.no_model_judge,
    )
    if args.attrs:
        report["attr_grounding"] = run_attr_eval(engine, args.attrs, args.batch, profile=args.prompt_profile)
    report["checkpoint"] = args.checkpoint
    report["prompt_profile"] = args.prompt_profile
    print(json.dumps(report, ensure_ascii=False), flush=True)
    return 0 if report["content_coverage"] >= args.coverage_floor else 1


if __name__ == "__main__":
    sys.exit(main())
