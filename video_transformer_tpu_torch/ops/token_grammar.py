"""Token-level grammar: a byte-schema DFA projected onto a BPE vocabulary.

This package's counterpart of the JAX package's ``ops/token_grammar.py``.
Per state, a bitset ``allowed_bits[S, ceil(V/32)]`` answers
which tokens keep the automaton alive (one row gather and a bit test); the
successor of the one sampled token per row is a walk of its byte columns
through the byte table; forced literal runs re-tokenize by the BPE codec so
the engine's fast-forward blocks work unchanged. Where ``S x V`` fits
``TOKEN_TABLE_MAX``, ``device_table`` also holds the walk's result for every
(state, token) pair, ``next_token`` [S, V], built on the table's device:
``advance`` is then one gather instead of up to 16 byte steps, with the same
values; above that size (the large grammars at a 152k vocabulary) it walks.

The bitset is a host precompute (seconds at a 2,048 vocab), cached on disk
under ``build/grammar_cache/`` at the repo root, keyed by a hash of the byte
table and the token table. ``encode_aligned`` tokenizes a training note with
merge breaks at every forced/free boundary of the byte DFA, the segmentation
the constrained decode loop produces.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from .constrained import NEG_INF, JsonDfa

__all__ = ["TokenGrammar", "TOKEN_TABLE_MAX", "token_transition_table"]

# The largest token-level transition table (states x vocab entries, int32)
# ``device_table`` builds: 256 MiB (the note grammar at the 2,048 BPE vocab
# takes 50 MiB; at Qwen2-VL's 152k vocab only the small grammars fit).
TOKEN_TABLE_MAX = 1 << 26
# States walked at once while the table is built (bounds the temporaries).
_TABLE_CHUNK = 1 << 20


def _walk(state: torch.Tensor, cols: torch.Tensor, lens: torch.Tensor, byte_table: torch.Tensor) -> torch.Tensor:
    """States after walking each token's byte columns ``cols`` [..., L]
    (``lens`` valid) from ``state``; a state below 0, or a byte it refuses,
    ends the walk there."""
    s = state
    for i in range(cols.shape[-1]):
        col = cols[..., i]
        nxt = byte_table[s.clamp(min=0), col.clamp(min=0)]
        take = (i < lens) & (s >= 0) & (col >= 0)
        s = torch.where(take, nxt, s)
    return s


def token_transition_table(tables: dict[str, torch.Tensor]) -> torch.Tensor:
    """``advance``'s byte walk for every (state, token) pair: int32 [S, V]."""
    byte_table, cols, lens = tables["byte_table"], tables["token_cols"], tables["token_len"]
    num_states, vocab = byte_table.shape[0], cols.shape[0]
    out = torch.empty((num_states, vocab), dtype=torch.int32, device=byte_table.device)
    step = max(1, _TABLE_CHUNK // vocab)
    for lo in range(0, num_states, step):
        states = torch.arange(lo, min(lo + step, num_states), device=byte_table.device)[:, None]
        out[lo:lo + step] = _walk(states.expand(-1, vocab), cols[None], lens[None], byte_table)
    return out


class TokenGrammar:
    """Engine-facing grammar over a BPE vocab (same surface as JsonDfa)."""

    def __init__(
        self,
        dfa: JsonDfa,
        tokenizer,
        max_token_bytes: int = 16,
        cache_dir: str | Path | None = "build/grammar_cache",
    ):
        if tokenizer.vocab_size % 128:
            raise ValueError("BPE vocab must be a multiple of 128")
        self.dfa = dfa
        self.tokenizer = tokenizer
        self.start = dfa.start
        self.accept = dfa.accept
        self.max_token_bytes = max_token_bytes
        self.vocab_size = tokenizer.vocab_size
        self.token_cols, self.token_len = tokenizer.token_table(max_token_bytes)
        self.allowed_bits = self._compute_allowed_bits(cache_dir)

    def _cache_key(self) -> str:
        h = hashlib.sha256()
        h.update(self.dfa.next_state.tobytes())
        h.update(self.token_cols.tobytes())
        return h.hexdigest()[:24]

    def _compute_allowed_bits(self, cache_dir) -> np.ndarray:
        """Walk every token's bytes from every state through the byte table,
        or load the result from ``cache_dir`` (a relative path is anchored
        at the repo root; None neither reads nor writes a cache)."""
        if cache_dir is not None:
            cache_dir = Path(cache_dir)
            if not cache_dir.is_absolute():
                cache_dir = Path(__file__).resolve().parents[2] / cache_dir
            cache_path = cache_dir / f"bits_{self._cache_key()}.npz"
            if cache_path.exists():
                try:
                    return np.load(cache_path)["bits"]
                except Exception:  # a torn or foreign host file: rebuild it
                    pass
        table = self.dfa.next_state
        num_states = table.shape[0]
        vocab = self.vocab_size
        bits = np.zeros((num_states, (vocab + 31) // 32), np.uint32)
        states = np.arange(num_states, dtype=np.int32)
        chunk = 2048
        for v0 in range(0, vocab, chunk):
            cols = self.token_cols[v0 : v0 + chunk]  # [C, L]
            lens = self.token_len[v0 : v0 + chunk]  # [C]
            cur = np.repeat(states[:, None], cols.shape[0], axis=1)  # [S, C]
            for pos in range(self.max_token_bytes):
                active = (pos < lens)[None, :] & (cur >= 0)
                if not active.any():
                    break
                col = np.maximum(cols[:, pos], 0)[None, :]
                nxt = table[np.maximum(cur, 0), np.broadcast_to(col, cur.shape)]
                cur = np.where(active, nxt, cur)
            ok = (cur >= 0) & (lens > 0)[None, :]
            token_ids = np.arange(v0, v0 + cols.shape[0])
            word_idx = token_ids // 32
            bit_val = np.uint32(1) << (token_ids % 32).astype(np.uint32)
            for w in np.unique(word_idx):
                sel = word_idx == w
                bits[:, w] |= (ok[:, sel] * bit_val[sel][None, :]).astype(np.uint32).sum(
                    axis=1, dtype=np.uint32
                )
        if cache_dir is not None:
            try:
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                # Publish atomically: concurrent processes may build the same
                # key, and a file written in place could be left torn.
                tmp_path = cache_path.with_suffix(f".{os.getpid()}.tmp")
                with open(tmp_path, "wb") as fh:  # np.savez would append ".npz" to a name
                    np.savez_compressed(fh, bits=bits)
                os.replace(tmp_path, cache_path)
            except OSError:
                pass
        return bits

    @property
    def num_states(self) -> int:
        return self.dfa.num_states

    def device_table(self, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
        """The grammar's tables on ``device`` (bits widened to int64), with
        ``next_token`` where it fits (module docstring)."""
        tables = {
            "bits": torch.from_numpy(self.allowed_bits.astype(np.int64)).to(device),
            "byte_table": torch.from_numpy(self.dfa.next_state).to(device=device, dtype=torch.long),
            "token_cols": torch.from_numpy(self.token_cols).to(device=device, dtype=torch.long),
            "token_len": torch.from_numpy(self.token_len).to(device=device, dtype=torch.long),
        }
        if self.num_states * self.token_cols.shape[0] <= TOKEN_TABLE_MAX:
            tables["next_token"] = token_transition_table(tables)
        return tables

    @staticmethod
    def constrain(logits: torch.Tensor, state: torch.Tensor, tables) -> torch.Tensor:
        """Mask logits [B, V] via the bitset: one row gather + bit test."""
        vocab = logits.shape[-1]
        token_ids = torch.arange(vocab, device=logits.device)
        words = tables["bits"][state][:, token_ids // 32]  # [B, V]
        allowed = (words >> (token_ids % 32)) & 1
        return torch.where(allowed.bool(), logits, torch.full_like(logits, NEG_INF))

    @staticmethod
    def advance(state: torch.Tensor, token: torch.Tensor, tables) -> torch.Tensor:
        """Successor state after emitting ``token``: walk its byte columns
        (one gather of ``next_token`` where the tables hold it)."""
        table = tables.get("next_token")
        if table is not None:
            return torch.where(state >= 0, table[state.clamp(min=0), token].long(), state)
        return _walk(state, tables["token_cols"][token], tables["token_len"][token], tables["byte_table"])

    def forced_tables(self, max_run: int = 24) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Token-level forced runs: greedy re-tokenization of the byte runs."""
        byte_len, byte_tok, _ = self.dfa.forced_tables(max_run=max_run * self.max_token_bytes)
        num_states = self.dfa.num_states
        forced_len = np.zeros((num_states,), np.int32)
        forced_tokens = np.zeros((num_states, max_run), np.int32)
        forced_end = np.arange(num_states, dtype=np.int32)
        table = self.dfa.next_state
        for s in range(num_states):
            n = int(byte_len[s])
            if n == 0:
                continue
            run = bytes(int(b) for b in byte_tok[s, :n])
            tokens = self.tokenizer.encode_bytes(run)[:max_run]
            cur = s
            for tok in tokens:
                for byte in self.tokenizer.token_bytes(tok):
                    cur = int(table[cur, byte])
            forced_len[s] = len(tokens)
            forced_tokens[s, : len(tokens)] = tokens
            forced_end[s] = cur
        return forced_len, forced_tokens, forced_end

    def encode_aligned(self, text: str) -> list[int]:
        """Tokenize ``text`` with merge breaks at forced/free DFA boundaries.

        Walks the byte DFA over the text, splits the byte stream wherever
        the automaton's forcedness (exactly one allowed byte) flips, and
        BPE-encodes each span as its own merge unit: the segmentation the
        constrained decode loop enforces. Raises ValueError if the text
        leaves the grammar.
        """
        table = self.dfa.next_state
        forced = (table >= 0).sum(axis=1) == 1
        ids: list[int] = []
        span: list[int] = []
        state = self.dfa.start
        span_forced = bool(forced[state])
        for byte in text.encode("utf-8"):
            now_forced = bool(forced[state])
            if now_forced != span_forced and span:
                ids.extend(self.tokenizer.encode_bytes(bytes(span)))
                span = []
            span_forced = now_forced
            nxt = int(table[state, byte])
            if nxt < 0:
                # The offset counts the ids emitted so far, as the JAX package's message does.
                raise ValueError(f"text leaves the grammar at byte offset {len(ids)}")
            span.append(byte)
            state = nxt
        if span:
            ids.extend(self.tokenizer.encode_bytes(bytes(span)))
        return ids
