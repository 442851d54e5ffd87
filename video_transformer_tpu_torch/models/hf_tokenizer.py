"""HF byte-level-BPE ``tokenizer.json`` vocabularies for the engine and the
grammar: this package's counterpart of the JAX package's
``models/hf_tokenizer.py``.

A real Qwen2-VL checkpoint (``models/port.py``) comes with a trained HF
tokenizer; ``HfTokenizer`` gives such a vocabulary the engine's tokenizer
surface (``models/tokenizer.py``) and the token grammar's
(``ops/token_grammar.py``), so that constrained decoding runs over the
152k vocab as over the BPE one (``models/bpe.py``).

- Canonical text encoding (prompts) goes through the ``tokenizers``
  runtime when it can be imported (imported in the constructor, never at
  module import), else through merge units with this module's own rank
  tables (valid tokens; the segmentation may differ from HF's).
  ``encode_branch`` says which.
- The grammar's primitives (``token_bytes``, ``encode_bytes``,
  ``token_table``) come from the raw vocab and merges through the GPT-2
  byte <-> unicode map: the grammar needs each token's exact bytes.

Grammars for subword engines are built 512 columns wide
(``engine.byte_vocab``), so ``token_table`` maps content tokens to their
byte columns (0-255) and this tokenizer's EOS to column 258, whatever its
HF id.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["HfTokenizer"]

# Canonical byte-DFA special columns (models/tokenizer.py ids).
_DFA_EOS_COL = 258


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class HfTokenizer:
    """Engine/grammar tokenizer over a HF byte-level-BPE tokenizer.json."""

    def __init__(
        self,
        path: str | Path,
        vocab_size: int | None = None,
        eos_token: str = "<|endoftext|>",
        bos_token: str | None = None,
        pad_token: str | None = None,
        video_token: str | None = "<|video_pad|>",
    ):
        path = Path(path)
        payload = json.loads(path.read_text(encoding="utf-8"))
        model = payload["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model: {model.get('type')}")
        self._vocab: dict[str, int] = model["vocab"]
        added = {t["content"]: int(t["id"]) for t in payload.get("added_tokens", [])}
        self._special_ids = set(added.values())
        lookup = dict(self._vocab)
        lookup.update(added)

        max_id = max(lookup.values())
        self.vocab_size = (
            int(vocab_size) if vocab_size else _round_up(max_id + 1, 128)
        )
        if self.vocab_size % 128:
            raise ValueError(f"vocab_size {self.vocab_size} must be a multiple of 128")
        if self.vocab_size <= max_id:
            raise ValueError(
                f"vocab_size {self.vocab_size} smaller than max token id {max_id}"
            )

        # Specials. HF byte-level models often have no BOS/PAD: both default
        # to EOS (GPT-2 document-separator convention), matching how Qwen2
        # configs alias pad to <|endoftext|>.
        def resolve(token: str | None, fallback: int | None = None) -> int:
            if token is not None and token in lookup:
                return lookup[token]
            if fallback is not None:
                return fallback
            raise ValueError(f"special token {token!r} not in vocabulary")

        self.EOS = resolve(eos_token)
        self.BOS = resolve(bos_token, self.EOS)
        self.PAD = resolve(pad_token, self.EOS)
        try:
            self.VID = resolve(video_token)
        except ValueError:
            self.VID = self.EOS  # engine only uses VID as a display marker

        # Exact bytes per token via the GPT-2 char map.
        char_to_byte = {c: b for b, c in _bytes_to_unicode().items()}
        self._bytes: list[bytes] = [b""] * self.vocab_size
        for token, idx in self._vocab.items():
            if idx in self._special_ids:
                continue
            try:
                self._bytes[idx] = bytes(char_to_byte[c] for c in token)
            except KeyError:
                # Token outside the byte alphabet (shouldn't happen for
                # byte-level BPE) — leave unreachable for the grammar.
                self._bytes[idx] = b""

        # Merge ranks on ID PAIRS for encode_bytes (merges are recorded as
        # token-string pairs; map through the vocab).
        self._byte_id = {}
        for byte, char in _bytes_to_unicode().items():
            if char in self._vocab:
                self._byte_id[byte] = self._vocab[char]
        self._rank: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, merge in enumerate(model.get("merges", [])):
            a, b = merge if isinstance(merge, list) else merge.split(" ", 1)
            ia, ib = self._vocab.get(a), self._vocab.get(b)
            merged = self._vocab.get(a + b)
            if ia is None or ib is None or merged is None:
                continue
            self._rank[(ia, ib)] = (rank, merged)

        # Canonical encoder (regex pretokenizer etc.) when available.
        self._fast = None
        try:
            from tokenizers import Tokenizer

            self._fast = Tokenizer.from_file(str(path))
        except Exception:  # not installed, or a file it cannot read: merge units
            pass

    @property
    def encode_branch(self) -> str:
        """Which canonical encoder ``encode`` runs: ``tokenizers`` or ``merge_units``."""
        return "tokenizers" if self._fast is not None else "merge_units"

    # -- codec ---------------------------------------------------------------

    def token_bytes(self, token_id: int) -> bytes:
        """The exact byte string a token decodes to (empty for specials)."""
        if 0 <= token_id < self.vocab_size:
            return self._bytes[token_id]
        return b""

    def encode_bytes(self, data: bytes) -> list[int]:
        """Encode raw bytes as ONE merge unit (grammar-aligned primitive)."""
        if not data:
            return []
        symbols = [self._byte_id[b] for b in data]
        while len(symbols) > 1:
            best = None
            best_i = -1
            for i in range(len(symbols) - 1):
                entry = self._rank.get((symbols[i], symbols[i + 1]))
                if entry is not None and (best is None or entry[0] < best[0]):
                    best = entry
                    best_i = i
            if best is None:
                break
            symbols[best_i : best_i + 2] = [best[1]]
        return symbols

    def encode(
        self, text: str, add_bos: bool = False, add_eos: bool = False
    ) -> list[int]:
        if self._fast is not None:
            ids = list(self._fast.encode(text, add_special_tokens=False).ids)
        else:
            from .bpe import _pre_split

            ids = []
            for unit in _pre_split(text):
                ids.extend(self.encode_bytes(unit))
        if add_bos:
            ids.insert(0, self.BOS)
        if add_eos:
            ids.append(self.EOS)
        return ids

    def decode(self, ids) -> str:
        data = b"".join(
            self.token_bytes(int(i)) for i in np.asarray(ids).reshape(-1)
        )
        return data.decode("utf-8", errors="replace")

    def encode_array(
        self, text: str, length: int, add_bos: bool = False
    ) -> np.ndarray:
        """Encode into a fixed-length int32 array, right-padded with PAD."""
        ids = self.encode(text, add_bos=add_bos)[:length]
        out = np.full((length,), self.PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    # -- grammar support -------------------------------------------------------

    def token_table(self, max_bytes: int = 16) -> tuple[np.ndarray, np.ndarray]:
        """(token_cols [V, max_bytes], token_len [V]) for the token grammar.

        Content tokens map to raw byte columns; EOS maps to the canonical
        byte-DFA EOS column (258). Other specials and over-long tokens stay
        length 0 (never allowed under constrained decoding).
        """
        cols = np.full((self.vocab_size, max_bytes), -1, dtype=np.int32)
        lens = np.zeros((self.vocab_size,), dtype=np.int32)
        for v in range(self.vocab_size):
            if v == self.EOS:
                cols[v, 0] = _DFA_EOS_COL
                lens[v] = 1
                continue
            if v in self._special_ids:
                continue
            data = self._bytes[v]
            if not data or len(data) > max_bytes:
                continue
            cols[v, : len(data)] = list(data)
            lens[v] = len(data)
        return cols, lens
