"""A synthetic Qwen2-scale byte-level-BPE ``tokenizer.json``: this
package's counterpart of the JAX package's ``models/synth_vocab.py``.

No real Qwen2-VL ``tokenizer.json`` is in the repo, so the 152k-vocab
serving chain (the token grammar's bitset at S x 152,064, constrained
decoding over the full vocab, ``parallel/engine.py``'s ``_table_for``) runs
on a stand-in of the same scale and byte-length spread:

- the 256 GPT-2 byte-alphabet tokens,
- ASCII subwords (letter-chain merges, JSON structural fragments),
- the CJK range U+4E00..U+9FFF (two merges a character: the prefix pair,
  then the 3-byte character),
- CJK character bigrams (6-byte tokens) filling the rest,
- the added specials ``<|endoftext|>``, ``<|video_pad|>``,
  ``<|vision_start|>`` and ``<|vision_end|>``.

Every merge joins existing tokens into their concatenation, so
``HfTokenizer``'s rank tables, byte walks and ``encode_bytes`` behave as
with a trained file; only which corpus ranked the merges is made up. The
file is byte-equal to the JAX package's for the same arguments.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["write_synth_qwen_vocab"]


def write_synth_qwen_vocab(
    path: str | Path,
    vocab_size: int = 152064,
    seed: int = 0,
) -> Path:
    """Write a synthetic byte-level-BPE tokenizer.json with ``vocab_size``
    total ids (regular vocab + specials). Returns ``path``.

    ``vocab_size`` must be a multiple of 128 (engine requirement) and at
    least ~22k so the full CJK single-character range fits.
    """
    from .hf_tokenizer import _bytes_to_unicode

    if vocab_size % 128:
        raise ValueError("vocab_size must be a multiple of 128")
    byte_char = _bytes_to_unicode()

    def chars(data: bytes) -> str:
        return "".join(byte_char[b] for b in data)

    vocab: dict[str, int] = {}
    merges: list[str] = []

    def add(token: str) -> None:
        if token not in vocab:
            vocab[token] = len(vocab)

    def merge(a: str, b: str) -> str:
        """Record merge a+b (both must exist) and add the merged token."""
        merged = a + b
        if merged not in vocab:
            merges.append(f"{a} {b}")
            add(merged)
        return merged

    # 1. Byte alphabet.
    for b in range(256):
        add(byte_char[b])

    specials = ["<|endoftext|>", "<|video_pad|>", "<|vision_start|>",
                "<|vision_end|>"]
    budget = vocab_size - len(specials)

    # 2. ASCII subwords: JSON structural fragments + letter chains.
    for frag in ('{"', '":', '",', '"}', '["', '"]', '...', '->',
                 ': "', ', "'):
        data = frag.encode()
        acc = chars(data[:1])
        for byte in data[1:]:
            acc = merge(acc, byte_char[byte])
    letters = "etaoinsrhldcumfpgwybvkxjqz"
    rng = np.random.default_rng(seed)
    ascii_budget = 2000
    made = 0
    stems = [chars(c.encode()) for c in letters]
    while made < ascii_budget and len(vocab) < budget:
        stem = stems[int(rng.integers(len(stems)))]
        nxt = letters[int(rng.integers(len(letters)))]
        merged = merge(stem, chars(nxt.encode()))
        if len(merged) <= 8:
            stems.append(merged)
        made += 1

    # 3. Full CJK single characters (U+4E00..U+9FFF): prefix-pair merge,
    #    then full character. ~21k chars, ~384 shared 2-byte prefixes.
    cjk_chars: list[str] = []
    for cp in range(0x4E00, 0xA000):
        if len(vocab) >= budget:
            break
        data = chr(cp).encode("utf-8")  # 3 bytes
        prefix = merge(chars(data[:1]), chars(data[1:2]))
        full = merge(prefix, chars(data[2:3]))
        cjk_chars.append(full)

    # 4. CJK bigrams fill the remaining budget (the bulk, as in real
    #    CJK-heavy vocabularies).
    n_chars = len(cjk_chars)
    while len(vocab) < budget:
        a = cjk_chars[int(rng.integers(n_chars))]
        b = cjk_chars[int(rng.integers(n_chars))]
        merge(a, b)

    added = [
        {"content": tok, "id": len(vocab) + i, "special": True}
        for i, tok in enumerate(specials)
    ]
    payload = {
        "version": "1.0",
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "added_tokens": added,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, ensure_ascii=False), encoding="utf-8")
    return path
