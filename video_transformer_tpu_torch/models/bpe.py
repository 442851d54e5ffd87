"""Byte-level BPE: train, save, load, encode, decode and the grammar's token table.

This package's own copy of the JAX package's ``models/bpe.py``. Ids 0-255
are raw bytes, 256-259 the specials PAD/BOS/EOS/VID, and ids from 260 are
merges, so a byte-DFA column works unchanged for single-byte tokens and
specials. ``train_bpe`` learns merges from a corpus (pair-count BPE over
pre-split units, ties to the larger pair) until the vocab is full.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

__all__ = ["BpeTokenizer", "train_bpe"]

_NUM_BYTES = 256
_NUM_SPECIALS = 4


def _pre_split(text: str) -> list[bytes]:
    """Split text into merge units (BPE never merges across unit borders).

    ASCII runs split on whitespace boundaries (the space attaches to the next
    word); multibyte runs become their own units.
    """
    units: list[bytes] = []
    current: list[int] = []
    mode = None  # "ascii" | "multi"
    for ch in text:
        kind = "ascii" if ord(ch) < 128 else "multi"
        boundary = kind != mode or (kind == "ascii" and ch == " " and current)
        if boundary and current:
            units.append(bytes(current))
            current = []
        mode = kind
        current.extend(ch.encode("utf-8"))
    if current:
        units.append(bytes(current))
    return units


def train_bpe(
    corpus: list[str],
    vocab_size: int,
    min_pair_count: int = 2,
    max_token_bytes: int = 16,
) -> "BpeTokenizer":
    """Learn BPE merges from ``corpus`` until the vocab reaches vocab_size.

    vocab_size must be a multiple of 128 and leave room for 128 merges.
    Merged tokens never exceed ``max_token_bytes`` decoded bytes: the token
    grammar walks at most that many byte columns per token, so a longer
    token would be unreachable under constrained decoding.
    """
    if vocab_size % 128:
        raise ValueError(f"vocab_size {vocab_size} must be a multiple of 128")
    if vocab_size < _NUM_BYTES + _NUM_SPECIALS + 128:
        raise ValueError("vocab_size leaves no room for merges")

    unit_counts: Counter[bytes] = Counter()
    for text in corpus:
        unit_counts.update(_pre_split(text))
    words = [list(unit) for unit in unit_counts]
    counts = list(unit_counts.values())

    # Incremental pair statistics: a merge touches only the words holding
    # its pair, not the whole corpus.
    byte_len: dict[int, int] = {i: 1 for i in range(_NUM_BYTES)}

    def _fits(pair: tuple[int, int]) -> bool:
        return byte_len[pair[0]] + byte_len[pair[1]] <= max_token_bytes

    pair_counts: Counter[tuple[int, int]] = Counter()
    pair_words: dict[tuple[int, int], set[int]] = defaultdict(set)
    for wi, (symbols, count) in enumerate(zip(words, counts)):
        for pair in zip(symbols, symbols[1:]):
            if _fits(pair):
                pair_counts[pair] += count
                pair_words[pair].add(wi)

    merges: list[tuple[int, int]] = []
    next_id = _NUM_BYTES + _NUM_SPECIALS
    max_merges = vocab_size - next_id
    while len(merges) < max_merges and pair_counts:
        (a, b), best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if best < min_pair_count:
            break
        merges.append((a, b))
        new_id = next_id
        next_id += 1
        byte_len[new_id] = byte_len[a] + byte_len[b]
        for wi in list(pair_words.get((a, b), ())):
            symbols = words[wi]
            count = counts[wi]
            # Take the word's old pairs out, rewrite it, put its new pairs in.
            for pair in zip(symbols, symbols[1:]):
                if _fits(pair) and pair in pair_counts:
                    pair_counts[pair] -= count
                    if pair_counts[pair] <= 0:
                        del pair_counts[pair]
            i = 0
            while i < len(symbols) - 1:
                if symbols[i] == a and symbols[i + 1] == b:
                    symbols[i : i + 2] = [new_id]
                else:
                    i += 1
            for pair in zip(symbols, symbols[1:]):
                if _fits(pair):
                    pair_counts[pair] += count
                    pair_words[pair].add(wi)
    return BpeTokenizer(merges=merges, vocab_size=vocab_size)


class BpeTokenizer:
    """Byte-level BPE codec with the engine's tokenizer interface."""

    PAD = 256
    BOS = 257
    EOS = 258
    VID = 259

    def __init__(self, merges: list[tuple[int, int]], vocab_size: int):
        if vocab_size % 128:
            raise ValueError(f"vocab_size {vocab_size} must be a multiple of 128")
        first_merge = _NUM_BYTES + _NUM_SPECIALS
        if first_merge + len(merges) > vocab_size:
            raise ValueError("too many merges for vocab_size")
        self.vocab_size = vocab_size
        self.merges = [tuple(m) for m in merges]
        self._rank = {pair: i for i, pair in enumerate(self.merges)}
        self._bytes: list[bytes] = [bytes([i]) for i in range(_NUM_BYTES)]
        self._bytes += [b""] * _NUM_SPECIALS
        for a, b in self.merges:
            self._bytes.append(self.token_bytes(a) + self.token_bytes(b))

    def save(self, path: str | Path) -> None:
        payload = {"vocab_size": self.vocab_size, "merges": self.merges}
        Path(path).write_text(json.dumps(payload), encoding="utf-8")

    @classmethod
    def load(cls, path: str | Path) -> "BpeTokenizer":
        payload = json.loads(Path(path).read_text(encoding="utf-8"))
        merges = [tuple(m) for m in payload["merges"]]
        return cls(merges=merges, vocab_size=int(payload["vocab_size"]))

    def token_bytes(self, token_id: int) -> bytes:
        """The byte string a token decodes to (empty for specials/padding)."""
        return self._bytes[token_id] if token_id < len(self._bytes) else b""

    def _merge_unit(self, symbols: list[int]) -> list[int]:
        """Apply merges in rank order within one unit."""
        while len(symbols) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                rank = self._rank.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_rank is None:
                break
            symbols[best_i : best_i + 2] = [_NUM_BYTES + _NUM_SPECIALS + best_rank]
        return symbols

    def encode_bytes(self, data: bytes) -> list[int]:
        """Encode a raw byte string as one merge unit (no pre-splitting)."""
        return self._merge_unit(list(data)) if data else []

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids: list[int] = []
        for unit in _pre_split(text):
            ids.extend(self._merge_unit(list(unit)))
        if add_bos:
            ids.insert(0, self.BOS)
        if add_eos:
            ids.append(self.EOS)
        return ids

    def decode(self, ids) -> str:
        data = b"".join(self.token_bytes(int(i)) for i in np.asarray(ids).reshape(-1))
        return data.decode("utf-8", errors="replace")

    def encode_array(self, text: str, length: int, add_bos: bool = False) -> np.ndarray:
        """Encode into a fixed-length int32 array, right-padded with PAD."""
        ids = self.encode(text, add_bos=add_bos)[:length]
        out = np.full((length,), self.PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def token_table(self, max_bytes: int = 16) -> tuple[np.ndarray, np.ndarray]:
        """(token_cols [V, max_bytes], token_len [V]) for the token grammar.

        token_cols[v] holds byte-DFA column ids (raw byte values; the EOS
        column for EOS), -1 padded. Specials other than EOS, and tokens longer
        than max_bytes, get length 0: the grammar never allows them.
        """
        cols = np.full((self.vocab_size, max_bytes), -1, dtype=np.int32)
        lens = np.zeros((self.vocab_size,), dtype=np.int32)
        for v in range(self.vocab_size):
            if v == self.EOS:
                cols[v, 0] = self.EOS
                lens[v] = 1
                continue
            if v in (self.PAD, self.BOS, self.VID):
                continue
            data = self.token_bytes(v)
            if not data or len(data) > max_bytes:
                continue
            cols[v, : len(data)] = list(data)
            lens[v] = len(data)
        return cols, lens
