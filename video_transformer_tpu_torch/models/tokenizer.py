"""Byte-level tokenizer: ids 0-255 are raw bytes, then PAD/BOS/EOS/VID.

This package's own copy of the JAX package's ``models/tokenizer.py``. The
byte-DFA builders take their vocabulary width and EOS id from it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """UTF-8 byte tokenizer with PAD/BOS/EOS/VID specials."""

    PAD = 256
    BOS = 257
    EOS = 258
    VID = 259  # placeholder id marking video-token positions in the prompt

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 260:
            raise ValueError("vocab_size must cover 256 bytes + 4 specials")
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids.insert(0, self.BOS)
        if add_eos:
            ids.append(self.EOS)
        return ids

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in np.asarray(ids).reshape(-1) if int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self, token_id: int) -> bytes:
        """The exact byte string a token decodes to (empty for specials)."""
        return bytes([token_id]) if token_id < 256 else b""

    def encode_array(self, text: str, length: int, add_bos: bool = False) -> np.ndarray:
        """Encode into a fixed-length int32 array, right-padded with PAD."""
        ids = self.encode(text, add_bos=add_bos)[:length]
        out = np.full((length,), self.PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out
