"""The inference engine: preprocess, prefill and the constrained decode loop.

``InferenceEngine.generate(frames, prompts)`` and ``generate_text(prompts)``
are the counterparts of the JAX package's ``parallel/engine.py`` entry
points on one CUDA card: the same prompt layout (each row's prompt in its
own 128-multiple bucket, a continuation prefix right after it), the same
cache sizing, and the same decode loop semantics (frozen rows, EOS filler,
grammar fast-forward blocks of 1 + max_forced_run tokens, per-row
``out_pos`` with ``out_width`` slack, the cache index rewound to
``index_before + advance`` after each block).

The decode loop is the JAX package's ``_decode_loop_fn`` as steps of a fixed
carry (``_decode_step``): each step updates the logits, grammar state, done
rows, output buffer, positions, KV cache, a device step counter and a device
flag ``go`` in place, and reads nothing on the host; a step taken after the
loop has ended (``go`` false) freezes every row and changes nothing that is
read later. On one card the steps run as replayed CUDA graphs of
``DECODE_CHUNK`` steps (``parallel/graphs.py``), the host reading ``go`` and
the counter once a chunk; on the CPU the same steps run eagerly in the same
chunks. A mesh whose steps may be captured (``Mesh.capturable``: NCCL over
``(data, model)``) replays the same graphs on every rank, its collectives
inside them; a gloo mesh reads ``go`` after every step (the plain loop), as
does an engine whose private ``_plain_decode`` is set (the loop's plain
version, for the tests and the smoke). ``stats.decode_route`` names the
route that ran. With a draft attached the loop's step is a speculative
cycle (``_spec_step``, the JAX ``_spec_decode_loop_fn`` body) on the same
carry plus the draft's KV cache, on the same routes, in chunks of
``SPEC_CHUNK`` cycles.

Graphs are cached as the JAX engine caches its programs: one a (batch,
cache length, grammar, temperature above 0, closer bias, block width,
draft cache length). Each key owns a static carry. A call without a session
prefills straight into the key's KV caches (the target's and the draft's);
a call that keeps a session, and ``continue_session``, decode in their own
caches, which are copied into the key's before the loop and back after it,
so that no two live sessions share storage. Assigning the model, the draft
or its width, the grammar, the temperature, the closer bias, the forced-run
cap or the token budget drops the graphs.

Continuation: ``prefixes`` (token ids or text) re-prefill prompt + prefix
and resume the grammar mid-document; ``session_rounds`` with
``return_session`` keeps the decode carry (logits, cache, grammar state,
done rows) in an ``EngineSession`` that ``continue_session`` resumes with
no prefill, through the same loop, so that a resumed generation equals one
call with a longer budget. ``batch_bucket`` pads a ragged batch with rows
that are frozen from step 0. ``restore`` loads trained weights (a converted
``.npz``, the port trainer's ``params_N/params.pt``, or an HF Qwen2-VL
safetensors directory through ``models/port.py``).

A bf16 KV cache decodes through K5 (each step's cache write and attention
in one kernel), an int8 one through K2 then K3. ``quantize="int4"`` stores
the decoder's dense kernels as packed int4, which each decode step
multiplies through K6 (``ops/int4_matmul.py``); prefill's larger row counts
take the unpacked route. ``fuse_projections=True`` serves each block's
q/k/v and gate/up as one product each (``models/fuse.py``), the draft's
too. ``preprocess`` is the batcher's staging entry (``serving.py``).

Speculative decoding: ``attach_draft`` adds a small draft model of the same
vocabulary (``detach_draft``, ``restore_draft``). Each cycle of the
speculative loop takes its first token from the target's carried processed
log-distribution, lets the draft propose the rest of a ``spec_tokens``-wide
block one grammar-constrained ``decode_step`` at a time, verifies the block
in one target ``decode_block`` and emits the longest accepted prefix
(greedy: argmax equality, so the tokens are the plain loop's; above
temperature 0: rejection sampling, with the residual ``norm(max(p - q,
0))`` after a rejection); both cache indices are then rewound to
``index_before + accepted``. Both caches are in the compute dtype whatever
``kv_quant`` says (as in the JAX engine), so the verify and every draft
step decode through K5. Sessions carry the draft's cache beside the
target's. On one card the cycles replay as CUDA graphs, as the plain steps
do.

Each entry point opens the JAX engine's tracing span (``utils/tracing.py``):
``engine.preprocess`` (``frames=``), ``engine.generate`` and
``engine.generate_text`` (``batch=``, the padded batch) and
``engine.continue_session`` (``batch=``, the real rows); on a CUDA engine
each is also an NVTX range. A span closes after the host has read the
call's results back from the device.

A mesh (``InferenceEngine(..., mesh=build_mesh(...))``, ``parallel/mesh.py``)
serves over ``data`` x ``model`` ranks. Every rank runs each call in
lockstep: a batch pads to a multiple of the data axis (of ``batch_bucket``
rounded up to it), each data group prefills and decodes its own rows, and
the results are gathered in row order; within a group the model ranks hold
``parallel/sharding.py``'s shards (the serving transform casts, quantizes
the whole kernels, then shards) and see the same all-reduced logits and the
same seeded generator, so they make the same host decisions: on the graph
route every rank of a group warms up, captures and replays the same chunks
and reads the same ``go``, in lockstep, and no step collects over ``data``
(``_gather_rows`` runs after the loop), so that the groups may run
different numbers of chunks. ``model`` need
not divide the heads: each rank's KV cache holds its plan's kv heads
(``parallel/sharding.py::head_plan``; a kv head shared by several ranks is
replicated on them, as JAX replicates the cache), and the projection
fusion is dropped when ``model`` is above 1 (``event=fuse_projections_dropped``),
as in JAX. A draft is replicated on
every rank. On rank 0 each public call is also sent to the worker ranks
(``parallel/mesh.py::replicated``); the controller's session objects name the workers'
carries by handle. A 1 x 1 mesh is no mesh.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..models.config import VLMConfig
from ..models.fuse import fuse_projections as fuse_model
from ..models.lm import init_kv_cache
from ..models.port import load_qwen2vl_dir
from ..models.quant import quantize_decoder, quantize_module
from ..models.tokenizer import ByteTokenizer
from ..models.vlm import VideoLM
from ..ops.attention import flash_attention
from ..ops.decode_attention import decode_attention, decode_attention_update, write_cache_rows
from ..ops.int4_matmul import int4_matmul
from ..ops.preprocess import preprocess_frames
from ..utils.tracing import tracer
from ..weights import cast_weights, flatten_tree, from_jax_params, from_state_dict, load_npz, random_params
from .graphs import GeneratorMark, GraphPool, RouteStats, StepGraph
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, replicated
from .sharding import shard_block, shard_model

__all__ = ["InferenceEngine", "EngineStats", "EngineSession", "params_checkpoints", "resolve_params_dir",
           "DECODE_CHUNK", "SPEC_CHUNK", "LAUNCH_COUNTERS"]

DECODE_CHUNK = 16
"""Decode steps a captured graph (an eager chunk on the CPU) runs between two host reads."""
SPEC_CHUNK = 4
"""Speculative cycles a captured graph runs between two host reads. A cycle
is 1 + ``spec_tokens`` forwards (six draft steps and the verify at the
shipped width), so 4 cycles launch more kernels than ``DECODE_CHUNK`` plain
steps and the host read costs as little a forward; and a cycle emits up to
``spec_tokens`` tokens a row, so a chunk past the loop's end wastes at most
3 cycles, where 16 could waste 15 (90 tokens' worth of forwards at 6)."""
GRAPH_KEYS = 8
"""Graph keys an engine keeps (least recently used first out): each holds a KV cache."""
LAUNCH_COUNTERS = (flash_attention, write_cache_rows, decode_attention, decode_attention_update, int4_matmul)
"""The kernel wrappers a decode step may launch through, whose ``launches`` a graph keeps true."""
# Assigning one of these drops the engine's graphs: a graph holds their values.
_GRAPH_INPUTS = frozenset(("model", "draft_model", "draft_config", "spec_tokens", "dfa", "temperature",
                           "structure_bias", "max_forced_run", "max_new_tokens", "tokenizer"))


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def _is_hf_dir(path: Path) -> bool:
    """An HF checkpoint directory: safetensors shards and/or their index."""
    return path.is_dir() and (any(path.glob("*.safetensors")) or (path / "model.safetensors.index.json").exists())


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
class EngineStats(RouteStats):
    """Cumulative counters; seconds on the host clock after a device sync.
    The decode route's (``RouteStats``) are the port's own."""

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
    the KV cache, each row's next-token logits (with a draft attached, the
    processed next-token log-distribution: a rejection's residual has no
    raw-logits form) and grammar state, the rows that have ended
    (completed, or batch padding), and the draft's KV cache (speculative
    engines only)."""

    cache: dict
    logits: torch.Tensor
    state: torch.Tensor
    done: torch.Tensor
    b_real: int
    dfa: Any
    rounds_left: int
    draft_cache: dict | None = None


@dataclass
class _Carry:
    """The decode loop's carry, which each step updates in place, and the
    loop's constants. With a draft, ``logits`` is the processed
    log-distribution and ``draft_cache`` the draft's KV cache."""

    logits: torch.Tensor
    state: torch.Tensor
    finished: torch.Tensor
    tokens: torch.Tensor  # [B, max_new + 2 x block width]
    out_pos: torch.Tensor
    cache: dict
    step: torch.Tensor  # int32 []: live steps taken (JAX's ``steps``)
    go: torch.Tensor  # bool []: the next step is live
    dfa: Any
    table: Any
    forced: tuple[torch.Tensor, ...] | None
    close_bias: torch.Tensor | None
    cols: torch.Tensor  # [1, block width]
    draft_cache: dict | None = None


@dataclass
class _GraphEntry:
    """A graph key's static carry, and its graph once captured."""

    carry: _Carry
    graph: StepGraph | None = None


def _copy_cache(dst: dict, src: dict) -> None:
    """Copy ``src``'s k/v, scales and index into ``dst``'s tensors, skipping
    the tensors the two share."""
    for name in ("k", "v", "k_scale", "v_scale"):
        for d, s in zip(dst.get(name, ()), src.get(name, ())):
            if d is not s:
                d.copy_(s)
    if dst["index"] is not src["index"]:
        dst["index"].copy_(src["index"])


class InferenceEngine:
    """Owns the model on one device (or a mesh rank's share of it) and runs
    ``generate``/``generate_text``."""

    def __init__(
        self,
        config: VLMConfig,
        dfa: Any = None,
        max_new_tokens: int = 1024,
        temperature: float = 0.7,
        structure_bias: float = 0.0,
        max_forced_run: int = 2,
        seed: int = 0,
        params: VideoLM | Callable[[], VideoLM] | None = None,
        tokenizer: Any = None,
        param_dtype: str | None = None,
        quantize: str | None = None,
        kv_quant: str | None = None,
        fuse_projections: bool = False,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        """``params`` is a VideoLM (``weights.from_jax_params`` or
        ``weights.random_params``), or a function of no arguments that
        returns one (a module-level function or a ``functools.partial`` of
        one, such as ``weights.constant_params``); None makes seeded random
        weights on ``device`` (``restore`` then loads trained ones). ``param_dtype``
        casts the float weights, ``quantize`` ("int8" or "int4") then
        quantizes the decoder's dense layers, ``fuse_projections`` then
        fuses each block's q/k/v and gate/up (``models/fuse.py``), and
        ``kv_quant="int8"`` stores the KV cache in int8 (not while a draft
        is attached). ``mesh`` serves over its ranks (see the module
        docstring); each rank takes its mesh device, whatever ``device``
        says. On a mesh every rank makes its own weights: random ones a block
        at a time, or by calling the ``params`` function; a VideoLM is
        refused (it would cross to every rank whole), as is done with
        trained weights through ``restore``, where each rank reads the
        checkpoint."""
        args = {name: value for name, value in locals().items() if name not in ("self", "__class__")}
        mesh = mesh if mesh is not None and mesh.size > 1 else None
        if mesh is not None:
            if set(mesh.shape) - {DATA_AXIS, MODEL_AXIS}:
                raise ValueError(f"the engine serves over a (data, model) mesh, not {mesh.shape}")
            if isinstance(params, torch.nn.Module):
                raise ValueError(
                    "on a mesh, params is a function each rank calls (or None, then restore() a checkpoint), "
                    "not a model"
                )
        object.__setattr__(self, "mesh", mesh)
        new = mesh.controlled(("new", type(self), (), args)) if mesh else contextlib.nullcontext()
        with new:
            self._init(**{k: v for k, v in args.items() if k != "mesh"})
            if mesh:
                mesh.register(self)
        self._ready = True

    def _init(self, config, dfa, max_new_tokens, temperature, structure_bias, max_forced_run, seed, params,
              tokenizer, param_dtype, quantize, kv_quant, fuse_projections, device):
        mesh = self.mesh
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
        if tokenizer is not None and tokenizer.vocab_size != config.decoder.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} != decoder vocab {config.decoder.vocab_size}"
            )
        if mesh is not None:
            if fuse_projections and mesh.model > 1:
                logging.getLogger("video_transformer").info(
                    f"event=fuse_projections_dropped model={mesh.model}: a fused product does not shard"
                )
                fuse_projections = False
        self.config = config
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.dfa = dfa
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.structure_bias = float(structure_bias)
        self.max_forced_run = int(max_forced_run)
        self.kv_quant = kv_quant
        self.quantize = quantize
        self.fuse_projections = bool(fuse_projections)
        self.param_dtype = getattr(torch, param_dtype) if param_dtype else None
        self.tokenizer = tokenizer or ByteTokenizer(config.decoder.vocab_size)
        self.stats = EngineStats()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = random_params(
                config, self._generator, self.device, self.param_dtype or torch.float32,
                place_block=self._place_block if mesh is not None else None,
            )
        elif not isinstance(params, torch.nn.Module):
            params = params()
        self.model = self._place(params)
        if mesh is not None and mesh.data_index:
            # Each data group samples its rows from a stream of its own.
            self._generator.manual_seed(seed + 1_000_003 * mesh.data_index)
        self._tables: dict[int, Any] = {}
        self._forced: dict[int, tuple[torch.Tensor, ...]] = {}
        # Speculative decoding (attach_draft): None serves the plain loop.
        self.draft_model: VideoLM | None = None
        self.draft_config: VLMConfig | None = None
        self.spec_tokens = 0
        # The compiled decode loop: graphs by key, sharing one pool.
        self._graphs: OrderedDict[tuple, _GraphEntry] = OrderedDict()
        self._graph_pool = GraphPool(self.device) if self.device.type == "cuda" else None
        self._plain_decode = False

    def __setattr__(self, name: str, value: Any) -> None:
        """On a mesh's rank 0, a public attribute set outside any call (such
        as ``engine.dfa = ...``) is made on every rank."""
        if name in _GRAPH_INPUTS and self.__dict__.get("_graphs"):
            self._graphs.clear()
        mesh = self.__dict__.get("mesh")
        if mesh is not None and mesh.is_controller and self.__dict__.get("_ready") and not name.startswith("_"):
            with mesh.controlled(("call", self, "__setattr__", (name, value), {})):
                object.__setattr__(self, name, value)
            return
        object.__setattr__(self, name, value)

    def _place_block(self, block):
        """A mesh rank's transform of one decoder block that
        ``random_params`` has drawn and cast: quantize it whole, then shard."""
        if self.quantize:
            quantize_module(block, self.quantize)
        return shard_block(block, self.mesh)

    def _place(self, model: VideoLM) -> VideoLM:
        """The serving transform, in the JAX engine's order: the
        ``param_dtype`` cast, then quantization, then (on a mesh) this
        rank's shards, then the projection fusion (a new module; the
        caller's keeps its layout), then the device."""
        if self.param_dtype is not None:
            cast_weights(model, self.param_dtype)
        if self.quantize:
            quantize_decoder(model, self.quantize)
        if self.mesh is not None:
            shard_model(model, self.mesh)
        if self.fuse_projections:
            model = fuse_model(model)
        return model.to(self.device).eval()

    # -- speculative decoding ------------------------------------------------------

    @replicated
    def attach_draft(
        self,
        config: VLMConfig,
        params: VideoLM | None = None,
        checkpoint: str | Path | None = None,
        spec_tokens: int = 6,
        share_target_params: bool = False,
    ) -> None:
        """Decode speculatively with a small draft model of the target's
        vocabulary: each cycle the draft proposes a ``spec_tokens``-wide
        block and one wide target forward verifies it (greedy output stays
        the plain loop's; sampling keeps the target's distribution).

        ``params`` is a float VideoLM of ``config``, ``checkpoint`` what
        ``restore_draft`` takes; with neither, seeded random weights (every
        misprediction is rejected, so the output is still the target's).
        ``share_target_params=True`` drafts with the target's own served
        model (the same geometry; no second copy). Sessions made before the
        attach cannot be continued after it.
        """
        if config.decoder.vocab_size != self.config.decoder.vocab_size:
            raise ValueError(
                f"draft vocab {config.decoder.vocab_size} != target vocab {self.config.decoder.vocab_size}"
            )
        if not 2 <= int(spec_tokens) <= 16:
            raise ValueError(f"spec_tokens must be in [2, 16], got {spec_tokens}")
        if share_target_params:
            if params is not None or checkpoint is not None:
                raise ValueError("share_target_params excludes params/checkpoint")
            if config.decoder != self.config.decoder or config.encoder != self.config.encoder:
                raise ValueError("share_target_params needs the target's exact geometry")
        if self.kv_quant:
            logging.getLogger("video_transformer").info(
                f"event=draft_kv_quant_unused kv_quant={self.kv_quant}: speculative caches are in the compute dtype"
            )
        self.draft_config = config
        self.spec_tokens = int(spec_tokens)
        if share_target_params:
            self.draft_model = self.model
            return
        if params is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
            params = random_params(config, generator, self.device)
        self.draft_model = self._place_draft(params)
        if checkpoint is not None:
            self.restore_draft(checkpoint)

    @replicated
    def detach_draft(self) -> None:
        """Return to the plain decode loop; sessions of the speculative era
        cannot be continued after it."""
        self.draft_model = None
        self.draft_config = None
        self.spec_tokens = 0

    def _place_draft(self, model: VideoLM) -> VideoLM:
        """The draft's serving transform: the ``param_dtype`` cast (bf16 or
        f32) and the projection fusion when the engine fuses; never
        quantized (the draft is small enough that unpacking would cost
        more than the bytes it saves)."""
        if self.param_dtype is not None:
            cast_weights(model, self.param_dtype)
        if self.fuse_projections:
            model = fuse_model(model)
        return model.to(self.device).eval()

    @replicated
    def restore_draft(self, checkpoint_path: str | Path) -> None:
        """Load the draft's trained weights from what ``restore`` takes (a
        converted ``.npz``, a ``params_N/params.pt`` or a parent of such
        directories), then re-apply ``_place_draft``. An HF safetensors
        directory is refused: the draft has no HF counterpart."""
        if self.draft_model is None:
            raise ValueError("attach_draft before restore_draft")
        path = Path(checkpoint_path)
        if _is_hf_dir(path):
            raise ValueError(
                f"{path} looks like an HF safetensors checkpoint; the draft loads converted .npz or "
                "params_N checkpoints only"
            )
        self.draft_model = self._place_draft(self._read_checkpoint(path, self.draft_config))

    def _draft_patches(self, frames: np.ndarray) -> torch.Tensor:
        """The draft's own view of the clips: resampled in time to its frame
        count, preprocessed at its encoder's geometry and compute dtype."""
        want = self.draft_config.encoder.num_frames
        have = frames.shape[1]
        if have != want:
            frames = frames[:, np.round(np.linspace(0, have - 1, want)).astype(int)]
        frames_t = torch.as_tensor(np.ascontiguousarray(frames)).to(self.device)
        return preprocess_frames(frames_t, self.draft_config.encoder, self.draft_model.compute_dtype)

    @replicated
    def restore(self, checkpoint_path: str | Path) -> None:
        """Load trained weights, then re-apply the serving transform.

        Takes a converted checkpoint (``.npz`` from ``tools/orbax_to_npz.py``),
        a ``params_N`` directory holding the port trainer's ``params.pt``,
        a parent of such directories (the highest step is taken), or an HF
        checkpoint directory (``*.safetensors`` shards and/or
        ``model.safetensors.index.json``, e.g. Qwen2-VL-7B-Instruct's), which
        ``_restore_hf`` loads. The leaves are loaded as the f32 tree the
        trainer writes (a bfloat16 checkpoint is widened exactly, as the JAX
        engine restores against its f32 template), then cast and quantized
        as the engine serves. Raises on a missing file and on a tree that
        does not fit the preset; there is no fallback to random weights.
        """
        path = Path(checkpoint_path)
        if _is_hf_dir(path):
            self._restore_hf(path)
            return
        self.model = self._place(self._read_checkpoint(path, self.config))

    @staticmethod
    def _read_checkpoint(path: Path, config: VLMConfig) -> VideoLM:
        """The f32 model of ``config`` in a converted ``.npz``, a
        ``params_N/params.pt`` or a parent of such directories, on the CPU."""
        if path.suffix == ".npz":
            if not path.is_file():
                raise FileNotFoundError(f"no converted checkpoint at {path}")
            variables = load_npz(path)
            if "quant" in variables:
                raise ValueError(f"{path} holds quantized leaves; restore takes the trained float tree")
            model = from_jax_params(variables, config, device="cpu")
        else:
            path = resolve_params_dir(path)
            file = path / "params.pt"
            if not file.is_file():
                raise FileNotFoundError(f"no params.pt in {path}")
            state = torch.load(file, map_location="cpu", weights_only=True)
            model = from_state_dict(state, config, device="cpu")
        return cast_weights(model, torch.float32)

    def _restore_hf(self, path: Path) -> None:
        """Load an HF safetensors checkpoint directory into the served model.

        The ported tree must match the engine's f32 structure leaf for leaf
        (the checkpoint's geometry is the preset's); otherwise it raises
        with the missing, extra and drifted leaves. Then the serving
        transform: the leaves keep the checkpoint's dtypes unless
        ``param_dtype`` casts them (a bf16 hub checkpoint serves bf16
        weights, as the JAX engine's ``_restore_hf`` places them), then
        quantization, then the device.
        """
        tree = load_qwen2vl_dir(path, self.config)
        with torch.device("meta"):
            expected = {name: tuple(t.shape) for name, t in VideoLM(self.config).state_dict().items()}
        got = {name: tuple(leaf.shape) for name, leaf in flatten_tree(tree)}
        if got != expected:
            missing = sorted(set(expected) - set(got))[:4]
            extra = sorted(set(got) - set(expected))[:4]
            drifted = sorted(k for k in set(expected) & set(got) if expected[k] != got[k])[:4]
            raise ValueError(
                f"HF checkpoint does not match preset {self.config.name}: missing={missing} extra={extra} "
                f"shape_drift={[(k, got[k], expected[k]) for k in drifted]}"
            )
        self.model = self._place(from_jax_params({"params": tree}, self.config, device="cpu"))

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
        """Tokens one decode iteration may append: the draft block with a
        draft attached, else the grammar's fast-forward block."""
        if self.draft_model is not None:
            return self.spec_tokens
        return (1 + self.max_forced_run) if dfa is not None else 1

    def _prompt_bucket(self, prompts: list[str], with_video: bool) -> int:
        """Smallest 128-multiple holding every prompt (+BOS), capped so that
        prompt + video tokens + max_new still fit the KV cache."""
        longest = max((len(self.tokenizer.encode(p)) + 1 for p in prompts), default=1)
        bucket = _round_up(longest, 128)
        video_tokens = self.config.video_tokens if with_video else 0
        bw_max = max(1 + self.max_forced_run, self.spec_tokens)
        fit = (self.config.decoder.max_seq_len // 128) * 128
        ceiling = fit - video_tokens - self.max_new_tokens - 2 * bw_max - 17
        return min(bucket, max((ceiling // 128) * 128, 128))

    def _pad_and_tokenize(
        self, prompts: list[str], b_real: int, prompt_len: int, batch_bucket: int | None = None
    ) -> tuple[int, np.ndarray]:
        """Prompt tokens [B, prompt_len], the batch rounded up with empty
        prompts to the data axis (or to ``batch_bucket`` rounded up to it)."""
        quantum = self.data_parallel
        if batch_bucket:
            quantum = _round_up(batch_bucket, self.data_parallel)
        b_padded = _round_up(max(b_real, 1), quantum)
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
            # here so that callers can stop continuing.
            video_tokens = self.config.video_tokens if with_video else 0
            cache_len = _round_up(
                video_tokens + total + self.max_new_tokens + 2 * max(self.max_forced_run + 1, self.spec_tokens) + 17,
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

    def _cache_len(self, prompt_width: int, with_video: bool, dfa, extra_rounds: int,
                   config: VLMConfig | None = None) -> int:
        """KV positions of ``config``'s cache (the target's by default; the
        draft's has its own video-token count) for a generation and
        ``extra_rounds`` session rounds, with the tail slack past the last
        live position that K5's aligned row write may touch, as in the JAX
        engine."""
        config = config or self.config
        block_width = self._block_width(dfa)
        video_tokens = config.video_tokens if with_video else 0
        cache_len = _round_up(
            video_tokens + prompt_width + (1 + extra_rounds) * (self.max_new_tokens + block_width)
            + 1 + block_width + 16,
            128,
        )
        if cache_len > config.decoder.max_seq_len:
            raise ValueError(f"sequence {cache_len} exceeds max_seq_len {config.decoder.max_seq_len} ({config.name})")
        return cache_len

    @property
    def data_parallel(self) -> int:
        """Data-axis width: 1 without a mesh."""
        return self.mesh.data if self.mesh is not None else 1

    def _local_rows(self, b: int) -> slice:
        """This rank's data group's rows of a padded batch of ``b``."""
        if self.mesh is None:
            return slice(0, b)
        per = b // self.mesh.data
        return slice(self.mesh.data_index * per, (self.mesh.data_index + 1) * per)

    def _gather_rows(self, tokens, out_pos, complete, steps: int):
        """Every data group's decode results in row order, and the most
        steps a group took (the length of the global loop)."""
        mesh = self.mesh
        if mesh is None or mesh.data == 1:
            return tokens, out_pos, complete, steps
        packed = torch.cat([tokens, out_pos[:, None], complete[:, None].long()], dim=1)
        packed = mesh.all_gather(packed, DATA_AXIS, dim=0)
        most = mesh.all_reduce(torch.tensor([steps], dtype=torch.long, device=tokens.device), DATA_AXIS, op="max")
        return packed[:, :-2], packed[:, -2], packed[:, -1].bool(), int(most.item())

    @replicated
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

    @replicated
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

    @replicated
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

    @replicated
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
        if (session.draft_cache is None) != (self.draft_model is None):
            # The carry follows the engine's draft state at the session's
            # start: a session of the other era cannot resume.
            raise ValueError("session predates an attach_draft/detach_draft switch; restart its generation")
        start = time.perf_counter()
        with tracer.span("engine.continue_session", nvtx=self._nvtx, batch=session.b_real):
            tokens, out_pos, complete, steps, session.logits, session.cache, session.state, session.done = (
                self._decode(session.logits, session.cache, session.state, session.done, session.dfa,
                             session.draft_cache)
            )
            tokens, out_pos, complete, steps = self._gather_rows(tokens, out_pos, complete, steps)
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
        dev = self.device
        cache_len = self._cache_len(prompt_width, with_video, dfa, rounds)
        # This data group's rows (all of them without a mesh).
        rows = self._local_rows(tokens_in.shape[0])
        tokens_in, lengths, states = tokens_in[rows], lengths[rows], states[rows]
        if with_video:
            frames = frames[rows]
        b = tokens_in.shape[0]
        local_real = min(max(b_real - rows.start, 0), b)

        spec = self.draft_model is not None
        draft_len = self._cache_len(prompt_width, with_video, dfa, rounds, self.draft_config) if spec else None
        start = time.perf_counter()
        static = None
        if not rounds and self._decode_route() == "graph":
            # No session keeps these caches: the prefills write straight
            # into the graph key's KV caches (fresh indices and scales).
            static = self._graph_entry(b, cache_len, dfa, draft_len).carry
        # Speculative caches are in the compute dtype whatever kv_quant
        # says, as the JAX engine's speculative program makes them.
        cache = self._prefill_cache(self.config, self.model, b, cache_len, self.kv_quant == "int8" and not spec,
                                    static.cache if static else None)
        if b != local_real:
            # Batch padding takes no part in the int8 KV scales: the JAX
            # engine lets pad rows raise them, which changes the real rows'
            # tokens against the unpadded call.
            cache["active"] = torch.arange(b, device=dev) < local_real
        tokens_t = torch.from_numpy(tokens_in).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        if with_video:
            logits, cache = self.model.prefill(self.preprocess(frames), tokens_t, cache, lengths_t)
        else:
            logits, cache = self.model.prefill_text(tokens_t, cache, lengths_t)
        draft_cache = None
        if spec:
            # The draft prefills the same prompt block, with its own view of the clips.
            draft_cache = self._prefill_cache(self.draft_config, self.draft_model, b, draft_len, False,
                                              static.draft_cache if static else None)
            if with_video:
                _, draft_cache = self.draft_model.prefill(self._draft_patches(frames), tokens_t, draft_cache, lengths_t)
            else:
                _, draft_cache = self.draft_model.prefill_text(tokens_t, draft_cache, lengths_t)
        self._sync()
        prefill_seconds = time.perf_counter() - start
        state = torch.from_numpy(states).to(dev)
        # Batch-padding rows start done: frozen from step 0.
        done = torch.arange(b, device=dev) >= local_real
        if dfa is not None:
            done = done | (state == dfa.accept)
        if spec:
            table = self._table_for(dfa) if dfa is not None else None
            logits = self._process(logits, state, dfa, table, self.close_bias_array())
        tokens, out_pos, complete, steps, logits, cache, state, done = self._decode(
            logits, cache, state, done, dfa, draft_cache
        )
        tokens, out_pos, complete, steps = self._gather_rows(tokens, out_pos, complete, steps)
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
                    b_real=b_real, dfa=dfa, rounds_left=rounds, draft_cache=draft_cache,
                )
                if self.mesh is not None:
                    # Every rank keeps its carry; rank 0's session names them.
                    self.mesh.register(session)
            out += (session,)
        return out if len(out) > 1 else texts

    # -- the decode loop -----------------------------------------------------------

    def _decode_route(self) -> str:
        """The loop's route, from the configuration alone: "graph" on one
        card and on a mesh whose steps may be captured (NCCL), "chunked"
        (the same steps, eagerly, in the same chunks) on the CPU, "plain" (a
        host read after every step) on a gloo mesh or where
        ``_plain_decode`` asks for the loop's plain version. The speculative
        loop takes the same routes."""
        if self._plain_decode:
            return "plain"
        if self.mesh is not None:
            return "graph" if self.mesh.capturable else "plain"
        return "graph" if self.device.type == "cuda" else "chunked"

    def _prefill_cache(self, config: VLMConfig, model: VideoLM, b: int, cache_len: int, quant: bool,
                       static: dict | None) -> dict:
        """A KV cache for ``model``'s prefill: a new one, or one on
        ``static``'s k/v (a graph key's) with a fresh index and scales."""
        cache = init_kv_cache(config.decoder, b, 0 if static else cache_len, model.compute_dtype, quant=quant,
                              device=self.device, kv_heads=model.decoder.kv_heads)
        if static is not None:
            cache["k"], cache["v"] = list(static["k"]), list(static["v"])
        return cache

    def _new_carry(self, logits, cache, state, finished, dfa, draft_cache=None) -> _Carry:
        """A carry around these tensors, which the steps update in place,
        with a new output buffer, positions, step counter and flag."""
        dev = self.device
        b = logits.shape[0]
        block_width = self._block_width(dfa)
        # Rows freeze at out_pos >= max_new and frozen rows still write an EOS
        # block at out_pos each step: 2 x block_width of slack.
        out_width = self.max_new_tokens + 2 * block_width
        return _Carry(
            logits=logits, state=state, finished=finished,
            tokens=torch.empty((b, out_width), dtype=torch.long, device=dev),
            out_pos=torch.empty((b,), dtype=torch.long, device=dev), cache=cache,
            step=torch.empty((), dtype=torch.int32, device=dev), go=torch.empty((), dtype=torch.bool, device=dev),
            dfa=dfa, table=self._table_for(dfa) if dfa is not None else None,
            forced=self._forced_for(dfa) if dfa is not None else None, close_bias=self.close_bias_array(),
            cols=torch.arange(block_width, device=dev)[None, :], draft_cache=draft_cache,
        )

    def _graph_entry(self, b: int, cache_len: int, dfa, draft_len: int | None = None) -> _GraphEntry:
        """The graph key's entry (made on first use: a static carry with its
        own KV cache, and with ``draft_len`` the draft's, no graph yet); the
        least recently used key past ``GRAPH_KEYS`` is dropped."""
        key = (b, cache_len, id(dfa) if dfa is not None else None, self.temperature > 0, self.structure_bias,
               self._block_width(dfa), draft_len)
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            return entry
        dev = self.device
        spec = draft_len is not None
        cache = init_kv_cache(self.config.decoder, b, cache_len, self.model.compute_dtype,
                              quant=self.kv_quant == "int8" and not spec, device=dev,
                              kv_heads=self.model.decoder.kv_heads)
        draft_cache = None
        if spec:
            draft_cache = init_kv_cache(self.draft_config.decoder, b, draft_len, self.draft_model.compute_dtype,
                                        device=dev, kv_heads=self.draft_model.decoder.kv_heads)
        logits = torch.zeros((b, self.config.decoder.vocab_size), dtype=torch.float32, device=dev)
        state = torch.zeros((b,), dtype=torch.long, device=dev)
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        entry = self._graphs[key] = _GraphEntry(self._new_carry(logits, cache, state, finished, dfa, draft_cache))
        while len(self._graphs) > GRAPH_KEYS:
            self._graphs.popitem(last=False)
        return entry

    def _decode(self, logits, cache, state, finished, dfa, draft_cache=None):
        """The constrained decode loop: up to max_new_tokens per row; with
        ``draft_cache`` (a draft attached) the speculative loop, whose
        ``logits`` are the processed log-distribution.

        Takes and returns the full carry, so that ``generate`` and
        ``continue_session`` run this one loop: ``finished`` marks rows
        that have ended for good (accepted, EOS, batch padding); the token
        cap freezes a row only for this round, through ``out_pos``. The
        caller's logits, caches, state and finished advance in place.
        Returns (tokens, out_pos, complete, steps, logits, cache, state,
        finished); a speculative loop's steps are its cycles.
        """
        route = self._decode_route()
        entry = None
        if route == "graph":
            draft_len = draft_cache["k"][0].shape[2] if draft_cache is not None else None
            entry = self._graph_entry(logits.shape[0], cache["k"][0].shape[2], dfa, draft_len)
            c = entry.carry
            for dst, src in ((c.logits, logits), (c.state, state), (c.finished, finished)):
                dst.copy_(src)
            _copy_cache(c.cache, cache)
            if draft_cache is not None:
                _copy_cache(c.draft_cache, draft_cache)
        else:
            c = self._new_carry(logits, cache, state, finished, dfa, draft_cache)
        max_new = self.max_new_tokens
        c.tokens.fill_(self.tokenizer.EOS)
        c.out_pos.zero_()
        c.step.zero_()
        c.go.copy_((c.step < max_new) & ~(c.finished | (c.out_pos >= max_new)).all())
        steps = self._run_loop(c, entry, route)
        complete = (c.state == c.dfa.accept) if c.dfa is not None else c.finished.clone()
        if entry is not None:
            for dst, src in ((logits, c.logits), (state, c.state), (finished, c.finished)):
                dst.copy_(src)
            _copy_cache(cache, c.cache)
            if draft_cache is not None:
                _copy_cache(draft_cache, c.draft_cache)
        return c.tokens, c.out_pos, complete, steps, logits, cache, state, finished

    def _run_loop(self, c: _Carry, entry: _GraphEntry | None, route: str) -> int:
        """Run the steps (with a draft cache in ``c``, the speculative
        cycles) on ``c`` until ``go`` is false; returns the live steps. The
        graph and chunked routes read the device once a chunk of
        ``DECODE_CHUNK`` steps or ``SPEC_CHUNK`` cycles (a key's first chunk
        runs eagerly on the graphs' stream, the next is captured, then
        replayed); the plain route once a step."""
        stats = self.stats
        stats.decode_route = "graph" if route == "graph" else "eager"
        step = self._spec_step if c.draft_cache is not None else self._decode_step
        if route == "plain":
            while bool(c.go):  # the plain loop's host read, one a step
                step(c)
            return int(c.step)
        n = SPEC_CHUNK if c.draft_cache is not None else DECODE_CHUNK
        sampling = self.temperature > 0
        ran = 0
        while True:
            mark = GeneratorMark(self._generator) if sampling else None

            def chunk():
                for _ in range(n):
                    if mark is not None:
                        mark.before_step()
                    step(c)

            if entry is None:
                chunk()
            elif entry.graph is None:
                self._graph_pool.warm(chunk)
            else:
                entry.graph.replay()
                stats.replays += 1
            ran += n
            # The one host read a chunk; a mesh's model ranks read the same
            # values (their logits are all-reduced), so they go on alike.
            go, live = torch.stack([c.go.to(torch.int32), c.step]).tolist()
            if not go:
                break
            if entry is not None and entry.graph is None:
                entry.graph = StepGraph(lambda: step(c), n, self._graph_pool, LAUNCH_COUNTERS,
                                        (self._generator,) if sampling else (), self.mesh)
                stats.graphs_captured += 1
                stats.capture_seconds += entry.graph.seconds
        if mark is not None:
            # The chunk's idle steps drew too; the eager loop would have stopped.
            mark.rewind(live - (ran - n), n)
        stats.idle_steps += ran - live
        return live

    def _decode_step(self, c: _Carry) -> None:
        """One step of the decode loop (the JAX ``_decode_loop_fn`` body), in
        place on ``c``; reads nothing on the host. Every row is frozen when
        ``go`` is false, so that a step past the loop's end changes nothing
        read later: it writes an EOS block at an unmoved ``out_pos`` and k/v
        at an unmoved cache index."""
        max_new = self.max_new_tokens
        eos = self.tokenizer.EOS
        dfa, table = c.dfa, c.table
        frozen = c.finished | (c.out_pos >= max_new) | ~c.go
        masked = dfa.constrain(c.logits, c.state, table) if table is not None else c.logits
        if c.close_bias is not None:
            masked = masked + c.close_bias
        if self.temperature > 0:
            probs = torch.softmax(masked / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self._generator)[:, 0]
        else:
            tok = masked.argmax(dim=-1)
        tok = torch.where(frozen, torch.full_like(tok, eos), tok)

        if table is not None:
            forced_len, forced_tok, forced_end = c.forced
            mid = torch.where(frozen, c.state, dfa.advance(c.state, tok, table))
            run = torch.where(frozen, torch.zeros_like(mid), forced_len[mid])
            run_block = torch.where(
                c.cols[:, 1:] - 1 < run[:, None], forced_tok[mid], torch.full_like(forced_tok[mid], eos)
            )
            block = torch.cat([tok[:, None], run_block], dim=1)
            c.state.copy_(torch.where(run > 0, forced_end[mid], mid))
            finished = c.finished | (c.state == dfa.accept)
        else:
            run = torch.zeros_like(tok)
            block = tok[:, None]
            finished = c.finished | (~frozen & (tok == eos))

        c.tokens.scatter_(1, c.out_pos[:, None] + c.cols, block)
        ended = finished | frozen
        advance = torch.where(ended & (run == 0) & (tok == eos), 0, 1 + run)
        c.out_pos.add_(advance)
        c.finished.copy_(finished)
        cache = c.cache
        index = cache["index"]
        new_logits, _ = self.model.decode_block_pick(block, cache, run)
        cache["index"] = index  # the decoder rebinds it; the carry keeps its tensor
        index.copy_(index + advance)
        # Frozen rows keep their last live logits: a resumed session
        # samples its next token from them.
        c.logits.copy_(torch.where(frozen[:, None], c.logits, new_logits))
        c.step.add_(c.go.to(torch.int32))
        c.go.copy_((c.step < max_new) & ~(c.finished | (c.out_pos >= max_new)).all())

    # -- the speculative loop -------------------------------------------------------

    def _process(self, logits, state, dfa, table, close_bias) -> torch.Tensor:
        """Raw logits [B, V] -> the processed log-distribution a speculative
        cycle samples from: grammar mask, closer bias and temperature, then
        log_softmax (f32)."""
        if table is not None:
            logits = dfa.constrain(logits, state, table)
        if close_bias is not None:
            logits = logits + close_bias
        scale = self.temperature if self.temperature > 0 else 1.0
        return torch.log_softmax(logits.float() / scale, dim=-1)

    def _pick(self, logp, frozen) -> torch.Tensor:
        """argmax (greedy) or a draw from ``logp``; EOS for frozen rows."""
        if self.temperature > 0:
            tok = torch.multinomial(logp.exp(), 1, generator=self._generator)[:, 0]
        else:
            tok = logp.argmax(dim=-1)
        return torch.where(frozen, torch.full_like(tok, self.tokenizer.EOS), tok)

    def _spec_cycle(self, logp, cache, draft_cache, state, finished, frozen, dfa, table, close_bias):
        """One draft/verify cycle over every row (the JAX engine's
        ``_spec_decode_loop_fn`` body; the batcher's paged step too).

        t0 is drawn from the carried processed distribution ``logp``, so a
        live row emits at least one token; the draft then feeds t0 and its
        own proposals through ``spec_tokens`` grammar-constrained
        ``decode_step``s (the last keeps its cache covering every verified
        position), and one target ``decode_block`` scores the whole block.
        A proposal is accepted on argmax equality (greedy) or where
        ``log u < log p - log q``; the longest accepted prefix is emitted,
        and an emitted EOS ends its row without counting. The next
        distribution is the target's after that prefix, or after a rejection
        the residual ``norm(max(p - q, 0))``. Both cache indices are
        rewound to ``index_before + adv`` in their own tensors (the caches
        are updated in place and keep their index tensors); reads nothing on
        the host. Returns (block [B, K], adv [B], logp, state, finished).
        """
        k = self.spec_tokens
        eos = self.tokenizer.EOS
        greedy = self.temperature <= 0
        live = ~frozen
        b = logp.shape[0]
        rows = torch.arange(b, device=logp.device)

        def advance(s, tok):
            return torch.where(live, dfa.advance(s, tok, table), s) if table is not None else s

        t0 = self._pick(logp, frozen)
        draft_index = draft_cache["index"]
        prev, s = t0, advance(state, t0)
        proposals, draft_logps, states = [], [], []
        for _ in range(k):
            draft_logits, draft_cache = self.draft_model.decode_step(prev[:, None], draft_cache)
            lq = self._process(draft_logits, s, dfa, table, close_bias)
            prev = self._pick(lq, frozen)
            proposals.append(prev)
            draft_logps.append(lq)
            states.append(s)  # the state after block token i, which constrained proposal i + 1
            s = advance(s, prev)
        block = torch.stack([t0] + proposals[: k - 1], dim=1)

        index_before = cache["index"]
        all_logits, cache = self.model.decode_block(block, cache)  # [B, K, V]
        # The target's processed distribution at every block position, each
        # under the state its draft proposal was constrained at.
        states_t = torch.stack(states, dim=1)  # [B, K]: the state after block token i
        p_all = self._process(all_logits.reshape(b * k, -1), states_t.reshape(-1), dfa, table,
                              close_bias).reshape(b, k, -1)
        proposed = block[:, 1:]
        if greedy:
            accepted = proposed == p_all[:, :-1].argmax(dim=-1)  # [B, K - 1]
        else:
            q_all = torch.stack(draft_logps, dim=1)
            log_u = torch.log(torch.rand((b, k), generator=self._generator, device=logp.device))
            lp = p_all[:, :-1].gather(2, proposed[..., None])[..., 0]
            lq = q_all[:, :-1].gather(2, proposed[..., None])[..., 0]
            accepted = log_u[:, 1:] < lp - lq

        # The longest accepted prefix: token i is emitted while every
        # proposal before it was accepted and no emitted token ended the row
        # (EOS, or the grammar's accept); an emitted EOS does not count.
        is_eos = block == eos
        ended = is_eos | (states_t == dfa.accept) if table is not None else is_eos
        go_on = torch.cat([live[:, None], accepted & ~ended[:, :-1]], dim=1)
        emit = torch.cumprod(go_on.to(torch.int32), dim=1).bool()  # [B, K]
        adv = (emit & ~is_eos).sum(dim=1).to(index_before.dtype)
        last = (emit.sum(dim=1) - 1).clamp(min=0)
        new_state = torch.where(emit[:, 0], states_t[rows, last], state)
        new_finished = finished | (emit & ended).any(dim=1)

        # The next distribution: the target's after the emitted prefix, or
        # after a rejection the residual norm(max(p - q, 0)).
        next_idx = (adv.long() - 1).clamp(min=0)
        p_next = p_all[rows, next_idx]
        if greedy:
            new_logp = p_next
        else:
            q_next = q_all[rows, next_idx]
            resid = (p_next.exp() - q_next.exp()).clamp(min=0.0)
            total = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(total > 0, resid / total.clamp(min=1e-30), p_next.exp())
            new_logp = torch.where((adv < k)[:, None], torch.log(resid + 1e-30), p_next)
        logp = torch.where(frozen[:, None], logp, new_logp)
        # The decoders rebound both indices; the caches keep their tensors.
        cache["index"], draft_cache["index"] = index_before, draft_index
        index_before.add_(adv)
        draft_index.add_(adv)
        return block, adv.long(), logp, new_state, new_finished

    def _spec_step(self, c: _Carry) -> None:
        """One cycle of the speculative loop (the JAX ``run_spec`` body), in
        place on ``c``; reads nothing on the host. Every row is frozen when
        ``go`` is false, so that a cycle past the loop's end changes nothing
        read later: it writes an EOS block at an unmoved ``out_pos``, and
        draft and verify k/v at both caches' unmoved indices, inside the
        tail slack that ``_cache_len`` leaves for a frozen row's block."""
        max_new = self.max_new_tokens
        frozen = c.finished | (c.out_pos >= max_new) | ~c.go
        block, adv, logp, state, finished = self._spec_cycle(
            c.logits, c.cache, c.draft_cache, c.state, c.finished, frozen, c.dfa, c.table, c.close_bias
        )
        c.tokens.scatter_(1, c.out_pos[:, None] + c.cols, block)
        c.out_pos.add_(adv)
        c.logits.copy_(logp)
        c.state.copy_(state)
        c.finished.copy_(finished)
        c.step.add_(c.go.to(torch.int32))
        c.go.copy_((c.step < max_new) & ~(c.finished | (c.out_pos >= max_new)).all())
