"""Constrained JSON decoding: schema -> byte-level DFA -> logit masks.

The numpy builder is this package's own copy of the JAX package's
``ops/constrained.py``; ``constrain``, ``advance`` and ``device_table`` are
torch functions over the same tables. ``next_state[s, v]`` is the successor
of state s on byte token v, or -1 when v is not allowed; ``accept`` permits
only EOS, so ``state == accept`` is the decode loop's done flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.tokenizer import ByteTokenizer

__all__ = ["JsonDfa", "DfaBuilder"]

NEG_INF = -1e30

_FREE_BYTES = tuple(b for b in range(0x20, 0x7F) if b not in (0x22, 0x5C))
_DIGIT_BYTES = tuple(range(0x30, 0x3A))
# UTF-8 for free text: 2-byte leads and the 3-byte leads of the CJK plane.
_LEAD2_BYTES = tuple(range(0xC2, 0xE0))
_LEAD3_BYTES = tuple(range(0xE4, 0xEA))
_CONT_BYTES = tuple(range(0x80, 0xC0))


@dataclass(frozen=True)
class JsonDfa:
    """Compiled schema automaton over the byte vocabulary."""

    next_state: np.ndarray  # int32 [num_states, vocab]
    start: int
    accept: int

    @property
    def num_states(self) -> int:
        return self.next_state.shape[0]

    def device_table(self, device: str | torch.device = "cuda") -> torch.Tensor:
        return torch.from_numpy(self.next_state).to(device=device, dtype=torch.long)

    @staticmethod
    def constrain(logits: torch.Tensor, state: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """Mask logits [B, V] to DFA-allowed tokens for states [B]."""
        return torch.where(table[state] >= 0, logits, torch.full_like(logits, NEG_INF))

    @staticmethod
    def advance(state: torch.Tensor, token: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """DFA step after sampling: state' = next_state[state, token]."""
        return table[state, token]

    def forced_tables(self, max_run: int = 24) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-state forced literal runs (the JSON skeleton).

        Returns (forced_len [S], forced_tokens [S, max_run], forced_end [S]):
        from state s the next forced_len[s] tokens are forced_tokens[s, :],
        after which the automaton sits at forced_end[s]. EOS never enters a
        run.
        """
        num_states = self.num_states
        single = (self.next_state >= 0).sum(axis=1) == 1
        single_token = np.where(single, np.argmax(self.next_state >= 0, axis=1), 0)
        forced_len = np.zeros((num_states,), np.int32)
        forced_tokens = np.zeros((num_states, max_run), np.int32)
        forced_end = np.arange(num_states, dtype=np.int32)
        for s in range(num_states):
            cur = s
            run: list[int] = []
            while len(run) < max_run and single[cur] and cur != self.accept:
                token = int(single_token[cur])
                if token >= 256:  # specials (EOS) end the run
                    break
                run.append(token)
                cur = int(self.next_state[cur, token])
            forced_len[s] = len(run)
            forced_tokens[s, : len(run)] = run
            forced_end[s] = cur
        return forced_len, forced_tokens, forced_end


class DfaBuilder:
    """Imperative left-to-right DFA builder; every method returns self."""

    def __init__(self, tokenizer: ByteTokenizer | None = None, unicode_text: bool = False):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.vocab = self.tokenizer.vocab_size
        self.unicode_text = unicode_text
        self._rows: list[np.ndarray] = []
        self.state = self._new_state()

    def _new_state(self) -> int:
        self._rows.append(np.full((self.vocab,), -1, dtype=np.int32))
        return len(self._rows) - 1

    def _link(self, src: int, token: int, dst: int) -> None:
        self._rows[src][token] = dst

    def literal(self, text: str) -> "DfaBuilder":
        """Forced byte-exact literal run."""
        for byte in text.encode("utf-8"):
            nxt = self._new_state()
            self._link(self.state, byte, nxt)
            self.state = nxt
        return self

    def free_string(self, min_len: int = 1, max_len: int = 64, unicode: bool | None = None) -> "DfaBuilder":
        """Quoted free-text field with content length in [min, max] bytes.

        With ``unicode`` it also admits well-formed 2-byte UTF-8 and 3-byte
        CJK sequences, lead bytes only where the sequence fits the budget.
        """
        if unicode is None:
            unicode = self.unicode_text
        self.literal('"')
        exit_state = self._new_state()
        positions = [self.state] + [self._new_state() for _ in range(max_len)]
        for i in range(max_len):
            for byte in _FREE_BYTES:
                self._link(positions[i], byte, positions[i + 1])
        if unicode:
            for i in range(max_len):
                if i + 2 <= max_len:
                    cont = self._new_state()
                    for byte in _LEAD2_BYTES:
                        self._link(positions[i], byte, cont)
                    for byte in _CONT_BYTES:
                        self._link(cont, byte, positions[i + 2])
                if i + 3 <= max_len:
                    cont_a = self._new_state()
                    cont_b = self._new_state()
                    for byte in _LEAD3_BYTES:
                        self._link(positions[i], byte, cont_a)
                    for byte in _CONT_BYTES:
                        self._link(cont_a, byte, cont_b)
                        self._link(cont_b, byte, positions[i + 3])
        for i in range(min_len, max_len + 1):
            self._link(positions[i], 0x22, exit_state)
        self.state = exit_state
        return self

    def quoted_pattern(self, alphabets: list[tuple[int, ...]]) -> "DfaBuilder":
        """Quoted fixed-length field; position i draws from alphabets[i]."""
        self.literal('"')
        for alphabet in alphabets:
            nxt = self._new_state()
            for byte in alphabet:
                self._link(self.state, byte, nxt)
            self.state = nxt
        return self.literal('"')

    def timecode(self) -> "DfaBuilder":
        """Quoted "MM:SS" clock value."""
        d = _DIGIT_BYTES
        return self.quoted_pattern([d, d, (0x3A,), d, d])

    def loop_list(
        self,
        build_item: Callable[["DfaBuilder"], None],
        opener: str = "[",
        closer: str = "]",
    ) -> "DfaBuilder":
        """``opener item (', ' item)* closer`` with >= 1 items.

        The state after ", " aliases the first item's entry row.
        """
        self.literal(opener)
        entry = self.state
        build_item(self)
        after = self.state
        exit_state = self._new_state()
        comma = self._new_state()
        space = self._new_state()
        self._link(after, ord(closer), exit_state)
        self._link(after, ord(","), comma)
        self._link(comma, ord(" "), space)
        self._rows[space][:] = self._rows[entry]
        self.state = exit_state
        return self

    def string_list(self, item_min: int = 1, item_max: int = 64) -> "DfaBuilder":
        return self.loop_list(lambda b: b.free_string(item_min, item_max))

    def string_dict(
        self, key_min: int = 1, key_max: int = 32, val_min: int = 1, val_max: int = 96
    ) -> "DfaBuilder":
        """'{"key": "value", ...}' with >= 1 entries."""
        return self.loop_list(
            lambda b: b.free_string(key_min, key_max).literal(": ").free_string(val_min, val_max),
            opener="{",
            closer="}",
        )

    def finish(self) -> JsonDfa:
        """Terminate: frontier allows only EOS; accept self-loops on EOS."""
        accept = self._new_state()
        self._link(self.state, self.tokenizer.EOS, accept)
        self._link(accept, self.tokenizer.EOS, accept)
        return JsonDfa(next_state=np.stack(self._rows, axis=0), start=0, accept=accept)
