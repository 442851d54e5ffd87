"""The inference engine: preprocess, prefill and the constrained decode loop.

``InferenceEngine.generate(frames, prompts)`` and ``generate_text(prompts)``
are the counterparts of the JAX package's ``parallel/engine.py`` entry
points on one CUDA card: the same prompt layout (each row's prompt in its
own 128-multiple bucket, a continuation prefix right after it), the same
cache sizing, and the same decode loop semantics (frozen rows, EOS filler,
grammar fast-forward blocks of 1 + max_forced_run tokens, per-row
``out_pos`` with ``out_width`` slack, the cache index rewound to
``index_before + advance`` after each block). The loop runs on the host,
one decoder call per step; the tensors stay on the device.

Continuation: ``prefixes`` (token ids or text) re-prefill prompt + prefix
and resume the grammar mid-document; ``session_rounds`` with
``return_session`` keeps the decode carry (logits, cache, grammar state,
done rows) in an ``EngineSession`` that ``continue_session`` resumes with
no prefill, through the same loop, so that a resumed generation equals one
call with a longer budget. ``batch_bucket`` pads a ragged batch with rows
that are frozen from step 0. ``restore`` loads trained weights (a converted
``.npz``, or the port trainer's ``params_N/params.pt``).

A bf16 KV cache decodes through K5 (each step's cache write and attention
in one kernel), an int8 one through K2 then K3. ``quantize="int4"`` stores
the decoder's dense kernels as packed int4, which each decode step
multiplies through K6 (``ops/int4_matmul.py``); prefill's larger row counts
take the unpacked route. ``preprocess`` is the batcher's staging entry
(``serving.py``).

Each entry point opens the JAX engine's tracing span (``utils/tracing.py``):
``engine.preprocess`` (``frames=``), ``engine.generate`` and
``engine.generate_text`` (``batch=``, the padded batch) and
``engine.continue_session`` (``batch=``, the real rows); on a CUDA engine
each is also an NVTX range. A span closes after the host has read the
call's results back from the device.

Not ported: speculative decoding (no draft model), projection fusion and
data parallelism (one device, so a batch pads only to ``batch_bucket``, and
``data_parallel`` is 1).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.config import VLMConfig
from ..models.lm import init_kv_cache
from ..models.quant import quantize_decoder
from ..models.tokenizer import ByteTokenizer
from ..models.vlm import VideoLM
from ..ops.preprocess import preprocess_frames
from ..utils.tracing import tracer
from ..weights import cast_weights, from_jax_params, from_state_dict, load_npz, random_params

__all__ = ["InferenceEngine", "EngineStats", "EngineSession", "params_checkpoints", "resolve_params_dir"]


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def params_checkpoints(parent: str | Path) -> list[Path]:
    """The ``params_N`` checkpoint directories under ``parent``, highest
    step first; raises when there is none."""
    parent = Path(parent)
    steps = sorted(
        ((int(p.name.split("_")[-1]), p) for p in parent.iterdir()
         if p.is_dir() and p.name.startswith("params_") and p.name.split("_")[-1].isdigit()),
        reverse=True,
    )
    if not steps:
        raise FileNotFoundError(f"no params_N checkpoints under {parent}")
    return [p for _, p in steps]


def resolve_params_dir(path: str | Path) -> Path:
    """``path`` itself unless it is a directory of ``params_N`` checkpoints,
    then the highest step under it."""
    path = Path(path)
    if not path.is_dir() or path.name.startswith("params_"):
        return path
    return params_checkpoints(path)[0]


@dataclass
class EngineStats:
    """Cumulative counters; seconds on the host clock after a device sync."""

    generate_calls: int = 0
    tokens_generated: int = 0
    generate_seconds: float = 0.0
    prefill_seconds: float = 0.0
    """Preprocess, encoder and decoder prefill."""
    prefill_tokens: int = 0
    frames_preprocessed: int = 0
    preprocess_seconds: float = 0.0
    session_resumes: int = 0
    """Decode-only continuation rounds (each one saved a re-prefill)."""
    decode_steps: int = 0

    @property
    def tokens_per_second(self) -> float:
        return self.tokens_generated / self.generate_seconds if self.generate_seconds else 0.0

    def as_dict(self) -> dict[str, Any]:
        """The JAX engine's nine keys and roundings (``prefill_seconds``,
        the port's own, is left out)."""
        return {
            "generate_calls": self.generate_calls,
            "tokens_generated": self.tokens_generated,
            "generate_seconds": round(self.generate_seconds, 3),
            "tokens_per_second": round(self.tokens_per_second, 1),
            "prefill_tokens": self.prefill_tokens,
            "frames_preprocessed": self.frames_preprocessed,
            "preprocess_seconds": round(self.preprocess_seconds, 3),
            "session_resumes": self.session_resumes,
            "decode_steps": self.decode_steps,
        }


@dataclass
class EngineSession:
    """The decode carry kept on the device between continuation rounds:
    the KV cache, each row's next-token logits and grammar state, and the
    rows that have ended (completed, or batch padding)."""

    cache: dict
    logits: torch.Tensor
    state: torch.Tensor
    done: torch.Tensor
    b_real: int
    dfa: Any
    rounds_left: int


class InferenceEngine:
    """Owns the model on one device and runs ``generate``/``generate_text``."""

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
        ``device`` (``restore`` then loads trained ones). ``param_dtype``
        casts the float weights, ``quantize`` ("int8" or "int4") then
        quantizes the decoder's dense layers, and ``kv_quant="int8"`` stores
        the KV cache in int8."""
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
        self.quantize = quantize
        self.param_dtype = getattr(torch, param_dtype) if param_dtype else None
        self.tokenizer = tokenizer or ByteTokenizer(config.decoder.vocab_size)
        self.stats = EngineStats()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = random_params(config, self._generator, self.device, self.param_dtype or torch.float32)
        self.model = self._place(params)
        self._tables: dict[int, Any] = {}
        self._forced: dict[int, tuple[torch.Tensor, ...]] = {}

    def _place(self, model: VideoLM) -> VideoLM:
        """The serving transform, in the JAX engine's order: the
        ``param_dtype`` cast, then quantization, then the device."""
        if self.param_dtype is not None:
            cast_weights(model, self.param_dtype)
        if self.quantize:
            quantize_decoder(model, self.quantize)
        return model.to(self.device).eval()

    def restore(self, checkpoint_path: str | Path) -> None:
        """Load trained weights, then re-apply the serving transform.

        Takes a converted checkpoint (``.npz`` from ``tools/orbax_to_npz.py``),
        a ``params_N`` directory holding the port trainer's ``params.pt``,
        or a parent of such directories (the highest step is taken). The
        leaves are loaded as the f32 tree the trainer writes (a bfloat16
        checkpoint is widened exactly, as the JAX engine restores against
        its f32 template), then cast and quantized as the engine serves.
        Raises on a missing file and on a tree that does not fit the
        preset; there is no fallback to random weights.
        """
        path = Path(checkpoint_path)
        if path.is_dir() and (any(path.glob("*.safetensors")) or (path / "model.safetensors.index.json").exists()):
            raise NotImplementedError(f"{path}: HF safetensors checkpoints are not ported")
        if path.suffix == ".npz":
            if not path.is_file():
                raise FileNotFoundError(f"no converted checkpoint at {path}")
            variables = load_npz(path)
            if "quant" in variables:
                raise ValueError(f"{path} holds quantized leaves; restore takes the trained float tree")
            model = from_jax_params(variables, self.config, device="cpu")
        else:
            path = resolve_params_dir(path)
            file = path / "params.pt"
            if not file.is_file():
                raise FileNotFoundError(f"no params.pt in {path}")
            state = torch.load(file, map_location="cpu", weights_only=True)
            model = from_state_dict(state, self.config, device="cpu")
        cast_weights(model, torch.float32)
        self.model = self._place(model)

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

    def _pad_and_tokenize(
        self, prompts: list[str], b_real: int, prompt_len: int, batch_bucket: int | None = None
    ) -> tuple[int, np.ndarray]:
        """Prompt tokens [B, prompt_len], the batch rounded up to
        ``batch_bucket`` with empty prompts (one device: no other quantum)."""
        b_padded = _round_up(max(b_real, 1), batch_bucket or 1)
        padded = prompts + [""] * (b_padded - b_real)
        overflow = sum(1 for p in prompts if len(self.tokenizer.encode(p)) + 1 > prompt_len)
        if overflow:
            logging.getLogger("video_transformer").warning(
                f"event=prompt_truncated count={overflow} prompt_len={prompt_len}"
            )
        return b_padded, np.stack([self.tokenizer.encode_array(p, prompt_len, add_bos=True) for p in padded])

    def _resume_state(self, dfa, prefix: bytes) -> int:
        """Grammar state after consuming ``prefix`` bytes (continuation)."""
        table = getattr(dfa, "dfa", dfa).next_state
        state = dfa.start
        for byte in prefix:
            state = int(table[state, byte])
            if state < 0:
                raise ValueError("continuation prefix leaves the grammar")
        return state

    def _prefix_bytes(self, ids: list[int]) -> bytes:
        """Exact bytes of a generated id sequence: ids keep a cap that fell
        mid UTF-8 character intact, where re-encoded text would not."""
        return b"".join(self.tokenizer.token_bytes(int(t)) for t in ids)

    def _normalize_prefixes(self, prefixes) -> list[list[int]] | None:
        """Text or token-id prefixes -> ids (ids are the exact path)."""
        if prefixes is None:
            return None
        return [self.tokenizer.encode(p) if isinstance(p, str) else list(p) for p in prefixes]

    def _assemble_inputs(
        self,
        prompts: list[str],
        prefixes: list[list[int]] | None,
        b_real: int,
        prompt_len: int,
        dfa,
        with_video: bool,
        batch_bucket: int | None = None,
    ) -> tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
        """(padded batch, width, tokens [B, prompt_len + prefix_bucket],
        per-row valid lengths, grammar start states).

        Each row's prompt occupies its own 128-multiple bucket and its
        prefix follows right after it, resuming the grammar mid-document;
        the prefix region is rounded up to 128 across the batch.
        """
        b_padded, prompt_tokens = self._pad_and_tokenize(prompts, b_real, prompt_len, batch_bucket)
        row_buckets = np.full((b_padded,), prompt_len, np.int32)
        for i, p in enumerate(prompts):
            row_buckets[i] = min(_round_up(len(self.tokenizer.encode(p)) + 1, 128), prompt_len)

        prefix_ids: list[list[int]] = [[] for _ in range(b_padded)]
        for i, prefix in enumerate(prefixes or []):
            prefix_ids[i] = [int(t) for t in prefix]
        prefix_bucket = _round_up(max(map(len, prefix_ids)), 128) if any(prefix_ids) else 0

        total = prompt_len + prefix_bucket
        if prefix_bucket:
            # The cache bound of a generation with no session reserve, raised
            # here so that callers can stop continuing. No draft model: the
            # JAX engine's speculative block width counts as 0.
            spec_tokens = 0
            video_tokens = self.config.video_tokens if with_video else 0
            cache_len = _round_up(
                video_tokens + total + self.max_new_tokens + 2 * max(self.max_forced_run + 1, spec_tokens) + 17,
                128,
            )
            if cache_len > self.config.decoder.max_seq_len:
                raise ValueError(
                    f"prompt+prefix ({total} tokens) exceeds the sequence budget; cannot continue this generation"
                )

        tokens = np.full((b_padded, total), self.tokenizer.PAD, np.int32)
        tokens[:, :prompt_len] = prompt_tokens
        lengths = row_buckets.copy()
        states = np.full((b_padded,), dfa.start if dfa is not None else 0, np.int64)
        for i, ids in enumerate(prefix_ids):
            if not ids:
                continue
            start = int(row_buckets[i])
            tokens[i, start : start + len(ids)] = ids
            lengths[i] = start + len(ids)
            if dfa is not None:
                states[i] = self._resume_state(dfa, self._prefix_bytes(ids))
        return b_padded, total, tokens, lengths, states

    def _max_session_rounds(self, prompt_width: int, with_video: bool, requested: int, dfa) -> int:
        """Largest continuation-round reserve that still fits the KV cache
        (0: no session; the caller continues with ``prefixes``)."""
        video_tokens = self.config.video_tokens if with_video else 0
        block_width = self._block_width(dfa)
        per_round = self.max_new_tokens + block_width
        cap = (self.config.decoder.max_seq_len // 128) * 128
        budget = cap - video_tokens - prompt_width - block_width - 17
        return max(0, min(requested, budget // per_round - 1))

    def _cache_len(self, prompt_width: int, with_video: bool, dfa, extra_rounds: int) -> int:
        """KV positions for a generation and ``extra_rounds`` session rounds,
        with the tail slack past the last live position that K5's aligned
        row write may touch, as in the JAX engine."""
        block_width = self._block_width(dfa)
        video_tokens = self.config.video_tokens if with_video else 0
        cache_len = _round_up(
            video_tokens + prompt_width + (1 + extra_rounds) * (self.max_new_tokens + block_width)
            + 1 + block_width + 16,
            128,
        )
        if cache_len > self.config.decoder.max_seq_len:
            raise ValueError(f"sequence {cache_len} exceeds max_seq_len {self.config.decoder.max_seq_len}")
        return cache_len

    @property
    def data_parallel(self) -> int:
        """Data-axis width: the port serves on one device."""
        return 1

    def preprocess(self, frames) -> torch.Tensor:
        """uint8 [B, T, H, W, 3] frames -> patches on the device, in the
        compute dtype, timed into stats (after a device sync)."""
        start = time.perf_counter()
        frames = np.asarray(frames)
        with tracer.span("engine.preprocess", nvtx=self._nvtx, frames=frames.shape[0] * frames.shape[1]):
            frames_t = torch.as_tensor(frames).to(self.device)
            patches = preprocess_frames(frames_t, self.config.encoder, self.model.compute_dtype)
            self._sync()
        self.stats.preprocess_seconds += time.perf_counter() - start
        self.stats.frames_preprocessed += frames.shape[0] * frames.shape[1]
        return patches

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _nvtx(self) -> bool:
        """Spans are also NVTX ranges on a CUDA engine."""
        return self.device.type == "cuda"

    # -- generate ----------------------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        frames,
        prompts: list[str],
        prompt_len: int | None = None,
        dfa: Any = None,
        prefixes: list[str] | list[list[int]] | None = None,
        return_status: bool = False,
        return_tokens: bool = False,
        session_rounds: int = 0,
        return_session: bool = False,
        batch_bucket: int | None = None,
    ):
        """Analyze a batch of clips: returns one decoded text per clip.

        ``frames`` uint8 [B, T, H, W, 3]. ``prefixes`` continues earlier
        generations (token ids from ``return_tokens=True`` resume exactly;
        text re-encodes): each row re-prefills prompt + prefix, resumes the
        grammar mid-document and returns only the new tail.
        ``return_status=True`` appends per-row completion flags (False = ran
        out of token budget), ``return_tokens=True`` the per-row generated
        ids, and ``return_session=True`` an ``EngineSession`` holding cache
        room for ``session_rounds`` decode-only rounds (None when no round
        fits; continue with ``prefixes`` then). ``batch_bucket`` pads the
        batch up to a multiple of it with rows that generate nothing.
        """
        frames = np.asarray(frames)
        b_real = frames.shape[0]
        if len(prompts) != b_real:
            raise ValueError("one prompt per clip required")
        if prompt_len is None:
            prompt_len = self._prompt_bucket(prompts, with_video=True)
        dfa = dfa if dfa is not None else self.dfa
        b_padded, total, tokens_in, lengths, states = self._assemble_inputs(
            prompts, self._normalize_prefixes(prefixes), b_real, prompt_len, dfa,
            with_video=True, batch_bucket=batch_bucket,
        )
        if b_padded != b_real:
            pad = np.zeros((b_padded - b_real,) + frames.shape[1:], frames.dtype)
            frames = np.concatenate([frames, pad], axis=0)
        with tracer.span("engine.generate", nvtx=self._nvtx, batch=len(lengths)):
            return self._execute(
                frames, tokens_in, lengths, states, b_real, total, dfa,
                session_rounds, return_status, return_tokens, return_session,
            )

    @torch.no_grad()
    def generate_text(
        self,
        prompts: list[str],
        prompt_len: int | None = None,
        dfa: Any = None,
        prefixes: list[str] | list[list[int]] | None = None,
        return_status: bool = False,
        return_tokens: bool = False,
        session_rounds: int = 0,
        return_session: bool = False,
        batch_bucket: int | None = None,
    ):
        """Text-only generation (validator scoring, consolidation, rewrite):
        ``generate`` without frames, prefilled through ``prefill_text``."""
        b_real = len(prompts)
        if prompt_len is None:
            prompt_len = self._prompt_bucket(prompts, with_video=False)
        dfa = dfa if dfa is not None else self.dfa
        _, total, tokens_in, lengths, states = self._assemble_inputs(
            prompts, self._normalize_prefixes(prefixes), b_real, prompt_len, dfa,
            with_video=False, batch_bucket=batch_bucket,
        )
        with tracer.span("engine.generate_text", nvtx=self._nvtx, batch=len(lengths)):
            return self._execute(
                None, tokens_in, lengths, states, b_real, total, dfa,
                session_rounds, return_status, return_tokens, return_session,
            )

    @torch.no_grad()
    def continue_session(self, session: EngineSession) -> tuple[list[str], list[bool], list[list[int]]]:
        """One decode-only round over a session's live cache: no prefill.

        Every row resumes from its next-token logits and grammar state;
        rows that have ended stay frozen and return empty tails. Returns
        (new-tail texts, complete flags, new-tail ids); the session advances
        in place.
        """
        if session.rounds_left <= 0:
            raise ValueError("session cache exhausted; no continuation rounds left")
        start = time.perf_counter()
        with tracer.span("engine.continue_session", nvtx=self._nvtx, batch=session.b_real):
            tokens, out_pos, complete, steps, session.logits, session.cache, session.state, session.done = (
                self._decode(session.logits, session.cache, session.state, session.done, session.dfa)
            )
            tokens, out_pos, complete = tokens.cpu().numpy(), out_pos.cpu().numpy(), complete.cpu().numpy()
        session.rounds_left -= 1
        b_real = session.b_real
        self.stats.generate_calls += 1
        self.stats.session_resumes += 1
        self.stats.tokens_generated += int(out_pos[:b_real].sum())
        self.stats.generate_seconds += time.perf_counter() - start
        self.stats.decode_steps += steps
        ids = [tokens[i, : out_pos[i]].tolist() for i in range(b_real)]
        return [self.tokenizer.decode(row) for row in ids], [bool(c) for c in complete[:b_real]], ids

    def _execute(
        self, frames, tokens_in, lengths, states, b_real, prompt_width, dfa,
        session_rounds, return_status, return_tokens, return_session,
    ):
        """Prefill (with video when ``frames`` is given), then the decode
        loop; packs the outputs as ``generate`` documents them."""
        with_video = frames is not None
        # A cache reserve is only of use to a session.
        rounds = session_rounds if return_session else 0
        if rounds:
            rounds = self._max_session_rounds(prompt_width, with_video, rounds, dfa)
        b = tokens_in.shape[0]
        dev = self.device
        cache_len = self._cache_len(prompt_width, with_video, dfa, rounds)

        start = time.perf_counter()
        cache = init_kv_cache(
            self.config.decoder, b, cache_len, self.model.compute_dtype,
            quant=self.kv_quant == "int8", device=dev,
        )
        if b != b_real:
            # Batch padding takes no part in the int8 KV scales: the JAX
            # engine lets pad rows raise them, which changes the real rows'
            # tokens against the unpadded call.
            cache["active"] = torch.arange(b, device=dev) < b_real
        tokens_t = torch.from_numpy(tokens_in).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        if with_video:
            logits, cache = self.model.prefill(self.preprocess(frames), tokens_t, cache, lengths_t)
        else:
            logits, cache = self.model.prefill_text(tokens_t, cache, lengths_t)
        self._sync()
        prefill_seconds = time.perf_counter() - start
        state = torch.from_numpy(states).to(dev)
        # Batch-padding rows start done: frozen from step 0.
        done = torch.arange(b, device=dev) >= b_real
        if dfa is not None:
            done = done | (state == dfa.accept)
        tokens, out_pos, complete, steps, logits, cache, state, done = self._decode(logits, cache, state, done, dfa)
        tokens, out_pos, complete = tokens.cpu().numpy(), out_pos.cpu().numpy(), complete.cpu().numpy()

        self.stats.generate_calls += 1
        self.stats.tokens_generated += int(out_pos[:b_real].sum())
        self.stats.generate_seconds += time.perf_counter() - start
        self.stats.prefill_seconds += prefill_seconds
        self.stats.decode_steps += steps
        video_tokens = self.config.video_tokens if with_video else 0
        self.stats.prefill_tokens += b_real * (video_tokens + prompt_width)

        ids = [tokens[i, : out_pos[i]].tolist() for i in range(b_real)]
        texts = [self.tokenizer.decode(row) for row in ids]
        out: tuple = (texts,)
        if return_status:
            out += ([bool(c) for c in complete[:b_real]],)
        if return_tokens:
            out += (ids,)
        if return_session:
            session = None
            if rounds:
                session = EngineSession(
                    cache=cache, logits=logits, state=state, done=done,
                    b_real=b_real, dfa=dfa, rounds_left=rounds,
                )
            out += (session,)
        return out if len(out) > 1 else texts

    def _decode(self, logits, cache, state, finished, dfa):
        """The constrained decode loop: up to max_new_tokens per row.

        Takes and returns the full carry, so that ``generate`` and
        ``continue_session`` run this one loop: ``finished`` marks rows
        that have ended for good (accepted, EOS, batch padding); the token
        cap freezes a row only for this round, through ``out_pos``.
        Returns (tokens, out_pos, complete, steps, logits, cache, state,
        finished).
        """
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
            # Frozen rows keep their last live logits: a resumed session
            # samples its next token from them.
            logits = torch.where(frozen[:, None], logits, new_logits)
            step += 1
        complete = (state == dfa.accept) if dfa is not None else finished
        return tokens, out_pos, complete, step, logits, cache, state, finished
