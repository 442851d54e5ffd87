"""The inference engine: preprocess, prefill and the constrained decode loop.

``InferenceEngine.generate(frames, prompts)`` is the counterpart of the JAX
package's ``parallel/engine.py::InferenceEngine.generate`` on one CUDA card:
the same prompt layout (each row's prompt in its own 128-multiple bucket),
the same cache sizing, and the same decode loop semantics (frozen rows, EOS
filler, grammar fast-forward blocks of 1 + max_forced_run tokens, per-row
``out_pos`` with ``out_width`` slack, the cache index rewound to
``index_before + advance`` after each block). The loop runs on the host, one
decoder call per step; the tensors stay on the device.

A bf16 KV cache decodes through K5 (each step's cache write and attention
in one kernel), an int8 one through K2 then K3. ``quantize="int4"`` stores
the decoder's dense kernels as packed int4, which each decode step
multiplies through K6 (``ops/int4_matmul.py``); prefill's larger row counts
take the unpacked route. ``preprocess`` is the batcher's staging entry
(``serving.py``).

Not ported yet (they raise NotImplementedError): continuation ``prefixes``,
sessions, ``generate_text``, speculative decoding, projection fusion and data
parallelism.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..models.config import VLMConfig
from ..models.lm import init_kv_cache
from ..models.quant import quantize_decoder
from ..models.tokenizer import ByteTokenizer
from ..models.vlm import VideoLM
from ..ops.preprocess import preprocess_frames
from ..weights import cast_weights, random_params

__all__ = ["InferenceEngine", "EngineStats"]


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass
class EngineStats:
    """Cumulative counters; seconds on the host clock after a device sync."""

    tokens_generated: int = 0
    generate_seconds: float = 0.0
    prefill_seconds: float = 0.0
    """Preprocess, encoder and decoder prefill."""
    prefill_tokens: int = 0
    decode_steps: int = 0


class InferenceEngine:
    """Owns the model on one device and runs ``generate``."""

    def __init__(
        self,
        config: VLMConfig,
        dfa: Any = None,
        max_new_tokens: int = 1024,
        temperature: float = 0.7,
        structure_bias: float = 0.0,
        max_forced_run: int = 2,
        seed: int = 0,
        params: VideoLM | None = None,
        tokenizer: Any = None,
        param_dtype: str | None = None,
        quantize: str | None = None,
        kv_quant: str | None = None,
        device: str | torch.device = "cuda",
    ):
        """``params`` is a VideoLM (``weights.from_jax_params`` or
        ``weights.random_params``); None makes seeded random weights on
        ``device``. ``param_dtype`` casts the float weights, ``quantize``
        ("int8" or "int4") then quantizes the decoder's dense layers, and
        ``kv_quant="int8"`` stores the KV cache in int8."""
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
        if tokenizer is not None and tokenizer.vocab_size != config.decoder.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} != decoder vocab {config.decoder.vocab_size}"
            )
        self.config = config
        self.device = torch.device(device)
        self.dfa = dfa
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.structure_bias = float(structure_bias)
        self.max_forced_run = int(max_forced_run)
        self.kv_quant = kv_quant
        self.tokenizer = tokenizer or ByteTokenizer(config.decoder.vocab_size)
        self.stats = EngineStats()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        dtype = getattr(torch, param_dtype) if param_dtype else torch.float32
        if params is None:
            params = random_params(config, self._generator, self.device, dtype)
        elif param_dtype:
            cast_weights(params, dtype)
        if quantize:
            quantize_decoder(params, quantize)
        self.model = params.to(self.device).eval()
        self._tables: dict[int, Any] = {}
        self._forced: dict[int, tuple[torch.Tensor, ...]] = {}

    # -- grammar -----------------------------------------------------------------

    @property
    def _subword(self) -> bool:
        return hasattr(self.tokenizer, "token_table")

    @property
    def byte_vocab(self) -> int:
        """Column width for byte-DFA construction against this tokenizer."""
        return 512 if self._subword else self.tokenizer.vocab_size

    def wrap_grammar(self, byte_dfa):
        """Project a byte-level grammar onto this engine's tokenizer."""
        if not self._subword:
            return byte_dfa
        from ..ops.token_grammar import TokenGrammar

        return TokenGrammar(byte_dfa, self.tokenizer)

    def _table_for(self, dfa):
        if id(dfa) not in self._tables:
            self._tables[id(dfa)] = dfa.device_table(self.device)
        return self._tables[id(dfa)]

    def _forced_for(self, dfa) -> tuple[torch.Tensor, ...]:
        if id(dfa) not in self._forced:
            f_len, f_tok, f_end = dfa.forced_tables(max_run=self.max_forced_run)
            self._forced[id(dfa)] = tuple(
                torch.from_numpy(a).to(device=self.device, dtype=torch.long) for a in (f_len, f_tok, f_end)
            )
        return self._forced[id(dfa)]

    def close_bias_array(self) -> torch.Tensor | None:
        """Length-control logit bias toward JSON closing tokens (or None)."""
        if self.structure_bias == 0.0:
            return None
        bias = np.zeros((self.config.decoder.vocab_size,), np.float32)
        closers = (0x22, 0x5D, 0x7D)  # " ] }
        if self._subword:
            cols, lens = self.tokenizer.token_table()
            last = cols[np.arange(cols.shape[0]), np.maximum(lens - 1, 0)]
            mask = (lens > 0) & np.isin(last, closers)
            bias[mask[: bias.shape[0]]] = self.structure_bias
        else:
            bias[list(closers)] = self.structure_bias
        bias[self.tokenizer.EOS] = self.structure_bias
        return torch.from_numpy(bias).to(self.device)

    # -- inputs ------------------------------------------------------------------

    def _block_width(self, dfa) -> int:
        return (1 + self.max_forced_run) if dfa is not None else 1

    def _prompt_bucket(self, prompts: list[str], with_video: bool) -> int:
        """Smallest 128-multiple holding every prompt (+BOS), capped so that
        prompt + video tokens + max_new still fit the KV cache."""
        longest = max((len(self.tokenizer.encode(p)) + 1 for p in prompts), default=1)
        bucket = _round_up(longest, 128)
        video_tokens = self.config.video_tokens if with_video else 0
        bw_max = 1 + self.max_forced_run
        fit = (self.config.decoder.max_seq_len // 128) * 128
        ceiling = fit - video_tokens - self.max_new_tokens - 2 * bw_max - 17
        return min(bucket, max((ceiling // 128) * 128, 128))

    def _assemble_inputs(self, prompts: list[str], b_real: int, prompt_len: int, dfa):
        """Token block [B, prompt_len], per-row valid lengths (each row's own
        128-multiple bucket) and grammar start states."""
        rows = []
        lengths = np.full((b_real,), prompt_len, np.int32)
        overflow = 0
        for i, p in enumerate(prompts):
            ids = self.tokenizer.encode(p)
            overflow += len(ids) + 1 > prompt_len
            rows.append(self.tokenizer.encode_array(p, prompt_len, add_bos=True))
            lengths[i] = min(_round_up(len(ids) + 1, 128), prompt_len)
        if overflow:
            logging.getLogger("video_transformer").warning(
                f"event=prompt_truncated count={overflow} prompt_len={prompt_len}"
            )
        start = dfa.start if dfa is not None else 0
        return np.stack(rows), lengths, np.full((b_real,), start, np.int64)

    def preprocess(self, frames) -> torch.Tensor:
        """uint8 [B, T, H, W, 3] frames -> patches on the device, in the
        compute dtype."""
        frames_t = torch.as_tensor(np.asarray(frames)).to(self.device)
        return preprocess_frames(frames_t, self.config.encoder, self.model.compute_dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- generate ----------------------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        frames,
        prompts: list[str],
        prompt_len: int | None = None,
        dfa: Any = None,
        prefixes: Any = None,
        return_status: bool = False,
        return_tokens: bool = False,
        session_rounds: int = 0,
        return_session: bool = False,
        batch_bucket: int | None = None,
    ):
        """Analyze a batch of clips: returns one decoded text per clip.

        ``frames`` uint8 [B, T, H, W, 3]; ``return_status=True`` appends
        per-row completion flags (False = ran out of token budget) and
        ``return_tokens=True`` the per-row generated token ids.
        """
        if prefixes is not None or session_rounds or return_session:
            raise NotImplementedError("continuation prefixes and sessions are not ported")
        if batch_bucket:
            raise NotImplementedError("batch buckets are not ported (one device, no padding)")
        b_real = len(frames)
        if len(prompts) != b_real:
            raise ValueError("one prompt per clip required")
        if prompt_len is None:
            prompt_len = self._prompt_bucket(prompts, with_video=True)
        dfa = dfa if dfa is not None else self.dfa
        tokens_in, lengths, states = self._assemble_inputs(prompts, b_real, prompt_len, dfa)

        start = time.perf_counter()
        patches = self.preprocess(frames)
        cfg = self.config
        block_width = self._block_width(dfa)
        # Tail slack past the last live position, as in the JAX engine.
        cache_len = _round_up(
            cfg.video_tokens + prompt_len + (self.max_new_tokens + block_width) + 1 + block_width + 16,
            128,
        )
        if cache_len > cfg.decoder.max_seq_len:
            raise ValueError(f"sequence {cache_len} exceeds max_seq_len {cfg.decoder.max_seq_len}")
        dev = self.device
        cache = init_kv_cache(
            cfg.decoder, b_real, cache_len, self.model.compute_dtype,
            quant=self.kv_quant == "int8", device=dev,
        )
        logits, cache = self.model.prefill(
            patches, torch.from_numpy(tokens_in).to(dev), cache, torch.from_numpy(lengths).to(dev)
        )
        self._sync()
        prefill_seconds = time.perf_counter() - start
        state = torch.from_numpy(states).to(dev)
        done = torch.zeros((b_real,), dtype=torch.bool, device=dev)
        if dfa is not None:
            done = done | (state == dfa.accept)
        tokens, out_pos, complete, steps = self._decode(logits, cache, state, done, dfa)
        tokens = tokens.cpu().numpy()
        out_pos = out_pos.cpu().numpy()
        complete = complete.cpu().numpy()
        elapsed = time.perf_counter() - start

        self.stats.tokens_generated += int(out_pos.sum())
        self.stats.generate_seconds += elapsed
        self.stats.prefill_seconds += prefill_seconds
        self.stats.decode_steps += steps
        self.stats.prefill_tokens += b_real * (cfg.video_tokens + prompt_len)

        ids = [tokens[i, : out_pos[i]].tolist() for i in range(b_real)]
        out: tuple = ([self.tokenizer.decode(row) for row in ids],)
        if return_status:
            out += ([bool(c) for c in complete],)
        if return_tokens:
            out += (ids,)
        return out if len(out) > 1 else out[0]

    def _decode(self, logits, cache, state, finished, dfa):
        """The constrained decode loop: up to max_new_tokens per row."""
        max_new = self.max_new_tokens
        eos = self.tokenizer.EOS
        dev = self.device
        b = logits.shape[0]
        table = self._table_for(dfa) if dfa is not None else None
        if dfa is not None:
            forced_len, forced_tok, forced_end = self._forced_for(dfa)
        block_width = self._block_width(dfa)
        # Rows freeze at out_pos >= max_new and frozen rows still write an EOS
        # block at out_pos each step: 2 x block_width of slack.
        out_width = max_new + 2 * block_width
        close_bias = self.close_bias_array()
        tokens = torch.full((b, out_width), eos, dtype=torch.long, device=dev)
        out_pos = torch.zeros((b,), dtype=torch.long, device=dev)
        cols = torch.arange(block_width, device=dev)[None, :]
        step = 0
        while step < max_new:
            frozen = finished | (out_pos >= max_new)
            if bool(frozen.all()):
                break
            masked = dfa.constrain(logits, state, table) if table is not None else logits
            if close_bias is not None:
                masked = masked + close_bias
            if self.temperature > 0:
                probs = torch.softmax(masked / self.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=self._generator)[:, 0]
            else:
                tok = masked.argmax(dim=-1)
            tok = torch.where(frozen, torch.full_like(tok, eos), tok)

            if table is not None:
                mid = torch.where(frozen, state, dfa.advance(state, tok, table))
                run = torch.where(frozen, torch.zeros_like(mid), forced_len[mid])
                run_block = torch.where(
                    cols[:, 1:] - 1 < run[:, None], forced_tok[mid], torch.full_like(forced_tok[mid], eos)
                )
                block = torch.cat([tok[:, None], run_block], dim=1)
                state = torch.where(run > 0, forced_end[mid], mid)
                finished = finished | (state == dfa.accept)
            else:
                run = torch.zeros_like(tok)
                block = tok[:, None]
                finished = finished | (~frozen & (tok == eos))

            tokens.scatter_(1, out_pos[:, None] + cols, block)
            ended = finished | frozen
            advance = torch.where(ended & (run == 0) & (tok == eos), 0, 1 + run)
            out_pos = out_pos + advance
            index_before = cache["index"]
            new_logits, cache = self.model.decode_block_pick(block, cache, run)
            cache["index"] = (index_before + advance).to(torch.int32)
            logits = torch.where(frozen[:, None], logits, new_logits)
            step += 1
        complete = (state == dfa.accept) if dfa is not None else finished
        return tokens, out_pos, complete, step
