"""Training data: staged distillation pairs and synthetic pairs.

This package's own copy of the JAX package's ``train/data.py``:
``distillation_records`` yields the (clip, teacher note) pairs of a staging
directory, the production path; schema-shaped templated teacher notes
(``templated_teacher_note``), uniform walks of the note grammar
(``sample_dfa_text``) and whole batches of (random frames' patches, note
tokens) (``synthetic_batch``) serve smoke training. For the same
``np.random.default_rng`` seed they give the JAX package's arrays exactly
(``tests/test_torch_train.py``).
"""

from __future__ import annotations

import json
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from ..models.config import VLMConfig
from ..models.tokenizer import ByteTokenizer
from ..ops.constrained import JsonDfa

__all__ = ["sample_dfa_text", "templated_teacher_note", "synthetic_batch", "distillation_records"]

# Topic/phrase pools for templated teacher notes. Chinese pools match the
# product's output language (the unicode grammar admits CJK); the English
# pools remain for ASCII-only grammars.
_TOPICS = [
    "梯度下降", "反向传播", "注意力机制", "正则化", "批归一化",
    "分词", "词向量", "微调", "数据加载", "过拟合", "学习率", "模型保存",
]
_VERBS = ["更新", "控制", "稳定", "改进", "约束", "驱动"]
_NOUNS = ["损失函数", "训练过程", "收敛速度", "模型参数", "泛化能力"]
_TOPICS_ASCII = [
    "gradient descent", "backpropagation", "attention", "regularization",
    "batch norm", "tokenization", "embeddings", "fine tuning",
    "data loading", "overfitting", "learning rate", "checkpointing",
]


def templated_teacher_note(
    rng: np.random.Generator, language: str = "zh"
) -> dict:
    """A readable, schema-shaped synthetic teacher note.

    Unlike pure DFA sampling (uniform bytes), these pairs teach the model
    phrase-level structure, so smoke-trained checkpoints emit legible text.
    ``language="zh"`` (default) matches the product's Chinese notes;
    ``"en"`` targets ASCII-only grammars.
    """
    if language == "zh":
        topics, verbs, nouns = _TOPICS, _VERBS, _NOUNS

        def phrase() -> str:
            return f"{rng.choice(topics)}{rng.choice(verbs)}{rng.choice(nouns)}"

        def question(topic: str) -> str:
            return f"什么是{topic}"

    else:
        topics = _TOPICS_ASCII
        verbs = ["updates", "controls", "stabilizes", "improves", "bounds"]
        nouns = ["the loss", "training", "convergence", "the model"]

        def phrase() -> str:
            return f"{rng.choice(topics)} {rng.choice(verbs)} {rng.choice(nouns)}"

        def question(topic: str) -> str:
            return f"what is {topic}?"

    def qa() -> dict:
        topic = str(rng.choice(topics))
        return {"q": question(topic), "a": f"{topic}{rng.choice(verbs)}{rng.choice(nouns)}"
                if language == "zh" else f"{topic} {rng.choice(verbs)} {rng.choice(nouns)}"}

    def section(start: int) -> dict:
        topic = str(rng.choice(topics))
        return {
            "topic": topic,
            "timestamp": f"{start // 60:02d}:{start % 60:02d}",
            "explanation": f"{phrase()}. {phrase()}",
            "example": f"例如 {phrase()}" if language == "zh" else f"e.g. {phrase()}",
            "code": "x = train_step(x)",
            "common_mistakes": [f"忽略{rng.choice(topics)}" if language == "zh"
                                else f"ignoring {rng.choice(topics)}"],
            "connections": [str(rng.choice(topics))],
            "self_check": [qa()],
        }

    chapters = []
    for c in range(int(rng.integers(1, 3))):
        sections = [section(60 * c + 15 * s) for s in range(int(rng.integers(1, 3)))]
        chapters.append(
            {
                "chapter_title": str(rng.choice(topics)),
                "chapter_summary": phrase(),
                "chapter_self_check": [qa()],
                "sections": sections,
            }
        )
    return {
        "title": f"{rng.choice(topics)}精讲" if language == "zh"
        else f"lecture on {rng.choice(topics)}",
        "one_sentence_summary": phrase(),
        "key_takeaways": [phrase() for _ in range(int(rng.integers(1, 4)))],
        "deep_dive": chapters,
        "glossary": {str(rng.choice(topics)): phrase()},
        "visual_schemas": [
            {
                "type": "overview",
                "description": f"{rng.choice(topics)}总览" if language == "zh"
                else f"map of {rng.choice(topics)}",
                "schema": f"{rng.choice(topics)} -> {rng.choice(topics)} -> {rng.choice(topics)}",
            }
        ],
    }


def sample_dfa_text(
    dfa: JsonDfa, rng: np.random.Generator, max_tokens: int = 4096
) -> str:
    """Host-side walk of the schema DFA with uniform random choices.

    Produces structurally valid note JSON — the synthetic stand-in for
    teacher outputs.
    """
    tok = ByteTokenizer(dfa.next_state.shape[1])
    state = dfa.start
    out: list[int] = []
    for _ in range(max_tokens):
        row = dfa.next_state[state]
        allowed = np.flatnonzero(row >= 0)
        if allowed.size == 0:
            break
        # Mildly prefer closing tokens so samples stay compact.
        weights = np.ones(allowed.size)
        for i, token in enumerate(allowed):
            if token in (0x22, 0x5D, 0x7D, tok.EOS):
                weights[i] = 12.0
        token = int(rng.choice(allowed, p=weights / weights.sum()))
        if token == tok.EOS:
            break
        out.append(token)
        state = int(row[token])
    return tok.decode(out)


def synthetic_batch(
    rng: np.random.Generator,
    config: VLMConfig,
    batch: int,
    text_len: int,
    dfa: JsonDfa | None = None,
    templated: bool = True,
    prompt=None,  # str | Callable[[np.random.Generator], str] | None
    prompt_len: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(patches [B, Nv, patch_dim] f32, tokens [B, text_len] i32).

    templated=True (default) pairs frames with readable templated teacher
    notes; dfa-sampling and random-byte modes remain for grammar-shape and
    throughput testing.

    When ``prompt`` is given (a string or a callable(rng) -> string), every
    sequence starts with the fixed-width prompt block the serving engine
    prefills (BOS + prompt, PAD-padded to ``prompt_len``) so train and serve
    token positions line up exactly; callers mask the prompt region out of
    the loss.
    """
    tok = ByteTokenizer(config.decoder.vocab_size)
    patches = rng.standard_normal(
        (batch, config.video_tokens, config.encoder.patch_dim), dtype=np.float32
    )
    tokens = np.full((batch, text_len), tok.PAD, dtype=np.int32)
    if prompt is not None and prompt_len >= text_len:
        raise ValueError(
            f"prompt_len {prompt_len} leaves no room in text_len {text_len}"
        )
    body_len = text_len - (prompt_len if prompt is not None else 0)
    for i in range(batch):
        prefix: list[int] = []
        if prompt is not None and prompt_len > 0:
            # prompt may be a str or a callable(rng) -> str (e.g. randomized
            # duration labels so every serving prompt is in-distribution).
            text_prompt = prompt(rng) if callable(prompt) else prompt
            prefix = list(tok.encode_array(text_prompt, prompt_len, add_bos=True))
        if templated:
            text = json.dumps(templated_teacher_note(rng), ensure_ascii=False)
            ids = tok.encode(text, add_eos=True)[:body_len]
        elif dfa is not None:
            text = sample_dfa_text(dfa, rng, max_tokens=body_len - 2)
            ids = tok.encode(text, add_eos=True)[:body_len]
        else:
            length = int(rng.integers(8, body_len))
            ids = list(rng.integers(32, 127, size=length - 1)) + [tok.EOS]
        if not prefix:
            ids = [tok.BOS] + ids[: body_len - 1]
        row = prefix + ids
        tokens[i, : len(row)] = row
    return patches, tokens


def distillation_records(data_dir: str | Path) -> Iterator[tuple[Path, dict]]:
    """Yield (video_path, teacher_note_json) pairs from a staging directory.

    Layout: <dir>/<id>.<ext> with a sibling <id>.note.json teacher output;
    the clip is the first of .npzv, .npz, .y4m, .mp4 that exists.
    """
    data_dir = Path(data_dir)
    for note_path in sorted(data_dir.glob("*.note.json")):
        stem = note_path.name[: -len(".note.json")]
        for ext in (".npzv", ".npz", ".y4m", ".mp4"):
            video = data_dir / f"{stem}{ext}"
            if video.exists():
                yield video, json.loads(note_path.read_text(encoding="utf-8"))
                break
