"""Continuous batching: requests join and leave the decode loop mid-flight.

The counterpart of the JAX package's ``parallel/serving.py`` on one CUDA
card. ``InferenceEngine.generate`` runs one batch until every row finishes;
``ContinuousBatcher`` keeps a fixed pool of ``slots`` decode lanes resident
on the device (KV cache, grammar state, output buffer) and refills finished
lanes with queued requests mid-flight, so the decode matmuls run at full pool
width whatever the individual request lengths. The scheduling, the step
semantics and the greedy tokens are the JAX batcher's.

Two refill modes:

- **Device refill** (``device_refill=True``, the default): paged. The bf16
  KV pool holds ``slots + queue_depth`` full-length physical rows, and each
  decode lane addresses its row through an int32 ``rows`` table that K2/K3/K5
  read (``ops/decode_attention.py``). A stage prefills queued requests as
  one batch into a scratch cache of ``park_len = video_tokens + prompt_len``
  positions and adopts each into a host-chosen free pool row (K4,
  ``adopt_rows``); the ring keeps only small metadata per parked request.
  The chunk loop then decodes and refills: every ``refill_period`` steps a
  finished lane takes the ring head by a table update,
  ``rows[slot] = q_phys[head]``, and a reset of its small state; no KV bytes
  move. The host reads the device once per ``refill_period`` steps (the
  loop and refill conditions) and once per chunk (the status pack); the
  refill itself is tensor ops (``argmax(done)``, indexed updates) in the JAX
  order, launched from Python.
- **Host-driven refill** (``device_refill=False``): per-request prefill
  spliced into the pool between fixed decode chunks, with adaptive chunk
  sizing and an early exit. It is the parity oracle.

Each decode step (``_step``) updates the batcher's carry (pool, logits,
grammar state, done slots, output buffer, positions, cache index) in place
and reads nothing on the host. On one card the steps between two host reads
run as a replayed CUDA graph (``parallel/graphs.py``, the engine's pool): a
refill period's ``refill_period`` steps (JAX ``_build_decode_refill``), or
a host-driven chunk's ``n_steps`` (JAX ``_build_decode``), whose count sits
in a device scalar set before each replay; a step past it, or past the
point where every slot is done, freezes every slot. A key's first run of
steps is eager (the graph's warm-up); the graph is captured at its second.
With a draft each step is a speculative cycle, and a refill period's
cycles replay the same way. On the CPU the same steps run eagerly. The
route is the engine's (``InferenceEngine._decode_route``, chosen at
construction): graphs also on a mesh whose steps may be captured (NCCL),
each data group replaying its own; eager on a gloo mesh or where the
engine's ``_plain_decode`` is set, and there a host-driven chunk reads the
device after every step. ``stats`` names the route (``decode_route``).

The pool is in the compute dtype, so on the card each decode step writes
and attends through K5 (``decode_attention_update`` on a bf16 cache).

On a mesh (the engine's, ``parallel/mesh.py``) the slots and the pool's
physical rows split into ``n_groups`` = data-axis groups (``_group_rows``):
``slots`` and ``queue_depth`` must divide the axis, as in JAX. Each group's
ranks hold only its rows (the pool's kv heads split over ``model``), stage
the lanes of the stage that fall to the group (a stage's lane count is its
request count rounded up to the groups, the rest pad lanes) into its own
free rows, and refill its own slots from its own ring, so that no KV row
crosses a group; a greedy request's tokens do not depend on the slot it
runs in. The host gathers every group's completions after each chunk, in
group order. Without a mesh there is one group: a stage's width is its
request count and no stage has pad lanes.

Speculative decoding composes (device refill only, as in JAX): with a draft
attached to the engine (``attach_draft``), each step of the chunk loop is
the engine's draft/verify cycle (``InferenceEngine._spec_cycle``) over the
paged pools, in place on the carry as a plain step is. The draft has its
own bf16 pool of ``draft_cache_len`` positions, addressed through the same
``rows`` table, with its own per-slot index (its encoder emits its own
video-token count); a stage prefills both models into their scratch caches
and K4 adopts both into the pools, and the ring parks the processed
start-state log-distribution, the carry of the speculative step. Greedy
acceptance is exact, so the tokens are the plain batcher's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..models.lm import init_kv_cache
from ..ops.decode_attention import adopt_rows
from .engine import LAUNCH_COUNTERS
from .graphs import GeneratorMark, RouteStats, StepGraph
from .mesh import DATA_AXIS, replicated

__all__ = ["ContinuousBatcher", "Request", "Completion"]


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass
class Request:
    request_id: int
    frames: np.ndarray  # uint8 [T, H, W, 3]
    prompt: str
    priority: int = 0  # higher drains first; FIFO within a priority level


@dataclass
class Completion:
    request_id: int
    text: str
    tokens: int
    complete: bool  # grammar accepted (False = token budget exhausted)
    first_token_s: float = 0.0  # submit -> first decode chunk containing it
    token_ids: list[int] = field(default_factory=list)


@dataclass
class _Slot:
    request_id: int | None = None
    started: float = 0.0
    first_token_at: float = 0.0  # 0 until the slot's first decode chunk


@dataclass
class ContinuousBatcher:
    """Fixed-slot continuous scheduler over an InferenceEngine's model.

    Requests drain highest ``Request.priority`` first (FIFO within a level);
    in device-refill mode priority applies at staging time. The host-driven
    loop runs ``latency_steps`` chunks while requests wait and
    ``chunk_steps`` chunks otherwise, and every chunk stops as soon as all
    slots are done.
    """

    engine: Any  # InferenceEngine (model, tokenizer, dfa, device)
    slots: int = 4
    prompt_len: int = 256
    chunk_steps: int = 64
    latency_steps: int = 8
    max_new_tokens: int | None = None
    device_refill: bool = True
    queue_depth: int = 0
    """Parked-request ring capacity (device refill); 0 = 2 * slots."""
    refill_period: int = 8
    """Decode steps between refill checks in the device-refill chunk."""

    _slots: list[_Slot] = field(default_factory=list)
    _queue: list[tuple[int, int, Request]] = field(default_factory=list)
    _submit_seq: int = 0
    _submit_time: dict[int, float] = field(default_factory=dict)

    @property
    def mesh(self):
        return self.engine.mesh

    def __post_init__(self):
        """On a mesh's rank 0 the construction is replayed on every rank."""
        mesh = self.mesh
        args = {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if not f.name.startswith("_")}
        with mesh.controlled(("new", type(self), (), args)) if mesh else contextlib.nullcontext():
            self._setup()
        if mesh is not None:
            mesh.register(self)

    def _setup(self):
        engine = self.engine
        cfg = engine.config
        # Speculative decoding rides along when the engine has a draft attached.
        self.spec = engine.draft_model is not None
        self.spec_k = engine.spec_tokens if self.spec else 0
        if self.spec and not self.device_refill:
            raise ValueError(
                "speculative decoding requires device_refill=True (the host-driven loop is the plain-path "
                "parity oracle); detach_draft or use the default mode"
            )
        self.max_new = self.max_new_tokens or engine.max_new_tokens
        self.dfa = engine.dfa
        self.table = engine._table_for(self.dfa) if self.dfa is not None else None
        self._forced = engine._forced_for(self.dfa) if self.dfa is not None else None
        self.block_width = 1 + engine.max_forced_run if self.dfa is not None else 1
        # The widest append of one step: the fast-forward block, or the draft block.
        self.step_width = max(self.block_width, self.spec_k) if self.spec else self.block_width
        # Tail slack past the last live position: frozen rows still write a
        # block at their index, as in the JAX batcher.
        self.cache_len = _round_up(
            cfg.video_tokens + self.prompt_len + self.max_new + 2 * self.step_width + 17, 128
        )
        if self.cache_len > cfg.decoder.max_seq_len:
            raise ValueError("slot cache exceeds max_seq_len")
        self.out_width = self.max_new + 2 * self.step_width
        self.park_len = cfg.video_tokens + self.prompt_len
        if self.spec:
            dcfg = engine.draft_config
            self.draft_cache_len = _round_up(
                dcfg.video_tokens + self.prompt_len + self.max_new + 2 * self.step_width + 17, 128
            )
            if self.draft_cache_len > dcfg.decoder.max_seq_len:
                raise ValueError("draft slot cache exceeds draft max_seq_len")
            self.draft_park_len = dcfg.video_tokens + self.prompt_len
        self._slots = [_Slot() for _ in range(self.slots)]
        if self.queue_depth <= 0:
            self.queue_depth = 2 * self.slots
        self.n_groups = max(engine.data_parallel, 1)
        if self.slots % self.n_groups or self.queue_depth % self.n_groups:
            raise ValueError(
                f"slots ({self.slots}) and queue_depth ({self.queue_depth}) must divide the data axis ({self.n_groups})"
            )
        # This rank's data group and its share of the slots and the ring.
        self.group = engine.mesh.data_index if engine.mesh is not None else 0
        self.local_slots = self.slots // self.n_groups
        self.local_depth = self.queue_depth // self.n_groups
        self._close_bias = engine.close_bias_array()
        # The columns one step writes: the fast-forward block, or the draft block.
        self._cols = torch.arange(self.spec_k or self.block_width, device=engine.device)[None, :]
        # The decode route, the engine's: graphs of steps (or of speculative
        # cycles) on one card or a capturable mesh; else eager.
        self._graphed = engine._decode_route() == "graph"
        self.stats = RouteStats(decode_route="graph" if self._graphed else "eager")
        self._graphs: dict[tuple, StepGraph] = {}
        self._warm: set[tuple] = set()
        self._graph_inputs: tuple = ()
        self._init_device_state()
        if self.device_refill:
            self._init_ring_state()

    # -- device state -----------------------------------------------------------

    def _init_device_state(self):
        """The KV pool (compute dtype) and the per-slot decode state.

        Host-driven mode: ``slots`` physical rows, identity addressing.
        Device refill: ``slots + queue_depth`` rows addressed through
        ``rows``; slot i starts on row i and the rest are free for staging.
        A rank holds its group's ``_group_rows`` only, indexed from 0, and
        its group's slots: logical slot i of group g is local slot
        ``i - g * local_slots``, first on the group's i-th local row.
        """
        engine = self.engine
        cfg = engine.config
        dev = engine.device
        n = self.local_slots
        self.total_rows = self.slots + self.queue_depth if self.device_refill else self.slots
        self.local_rows = self.total_rows // self.n_groups
        pool = init_kv_cache(cfg.decoder, self.local_rows, self.cache_len, engine.model.compute_dtype,
                             device=dev, kv_heads=engine.model.decoder.kv_heads)
        self.cache = {
            "k": pool["k"],
            "v": pool["v"],
            # Logical per-slot fill counts (the rows table owns physical addressing).
            "index": torch.zeros((n,), dtype=torch.int32, device=dev),
        }
        self._rows_host = np.arange(n, dtype=np.int32)
        if self.device_refill:
            self.rows = torch.arange(n, dtype=torch.int32, device=dev)
            self.cache["rows"] = self.rows
        if self.spec:
            # The draft's pool: the same physical rows, through the same table.
            dcfg = engine.draft_config
            dpool = init_kv_cache(dcfg.decoder, self.local_rows, self.draft_cache_len,
                                  engine.draft_model.compute_dtype, device=dev,
                                  kv_heads=engine.draft_model.decoder.kv_heads)
            self.dcache = {"k": dpool["k"], "v": dpool["v"], "rows": self.rows,
                           "index": torch.zeros((n,), dtype=torch.int32, device=dev)}
        eos = engine.tokenizer.EOS
        self.state = torch.full((n,), self.dfa.start if self.dfa else 0, dtype=torch.long, device=dev)
        self.logits = torch.zeros((n, cfg.decoder.vocab_size), dtype=torch.float32, device=dev)
        self.tokens_out = torch.full((n, self.out_width), eos, dtype=torch.long, device=dev)
        self.out_pos = torch.zeros((n,), dtype=torch.long, device=dev)
        # Empty slots sit "done" so the decode freezes them. With a draft,
        # ``logits`` holds the processed log-distribution (the spec carry).
        self.done = torch.ones((n,), dtype=torch.bool, device=dev)
        # A step freezes every slot while ``_live`` is false; a host-driven
        # chunk sets it before each step from its count ``_chunk_k`` of live
        # steps and its length ``_chunk_n``.
        self._live = torch.ones((), dtype=torch.bool, device=dev)
        self._chunk_k = torch.zeros((), dtype=torch.int32, device=dev)
        self._chunk_n = torch.zeros((), dtype=torch.int32, device=dev)

    def _group_rows(self, group: int) -> range:
        """Physical pool rows (of ``total_rows``) that data group ``group`` owns."""
        per = self.total_rows // self.n_groups
        return range(group * per, (group + 1) * per)

    def _groups(self, obj: Any) -> list[Any]:
        """Every data group's ``obj``, in group order (without a mesh: [obj])."""
        mesh = self.engine.mesh
        if mesh is None or mesh.data == 1:
            return [obj]
        return mesh.gather_objects(obj, DATA_AXIS)

    def _init_ring_state(self):
        """The parked-request ring and the completion buffer.

        A ring entry's KV already sits in a free pool row (written by K4 at
        stage time); the ring holds its physical row (``q_phys``), its cache
        index after prefill, its first-token logits and its request id.
        Chunks drain the ring, so it is empty at every stage and positions
        rebase to 0..take-1. ``comp_meta`` rows are (request_id, out_pos,
        complete) of requests evicted during a chunk; ``slots + queue_depth``
        rows bound one chunk's completions.
        """
        engine = self.engine
        dev = engine.device
        depth = self.local_depth
        self._q_index = torch.zeros((depth,), dtype=torch.int32, device=dev)
        self._q_dindex = torch.zeros((depth,), dtype=torch.int32, device=dev)  # the draft's (speculative only)
        self._q_logits = torch.zeros((depth, engine.config.decoder.vocab_size), dtype=torch.float32, device=dev)
        self._q_req = torch.full((depth,), -1, dtype=torch.long, device=dev)
        self._q_phys = torch.zeros((depth,), dtype=torch.int32, device=dev)
        self._q_head = 0  # host-side: the host counts every refill it issues
        self._q_tail = 0
        self._slot_req = torch.full((self.local_slots,), -1, dtype=torch.long, device=dev)
        comp_rows = self.local_slots + depth
        self._comp_tokens = torch.full((comp_rows, self.out_width), engine.tokenizer.EOS, dtype=torch.long,
                                       device=dev)
        self._comp_meta = torch.full((comp_rows, 3), -1, dtype=torch.long, device=dev)
        self._staged_total = 0
        # Worst case one fast slot serves every parked request in turn; the
        # loop exits early once everything is done.
        self._device_steps = (depth + 1) * (self.max_new + 1) + self.local_slots

    # -- the decode step ---------------------------------------------------------

    @torch.no_grad()
    def _step(self) -> None:
        """One grammar-constrained decode iteration over all slots, in place
        on the batcher's carry; reads nothing on the host. Done slots, and
        every slot while ``_live`` is false, are frozen: they write an EOS
        block at an unmoved position and keep their logits."""
        if self.spec:
            self._spec_step()
            return
        engine = self.engine
        dfa = self.dfa
        eos = engine.tokenizer.EOS
        frozen = self.done | ~self._live
        masked = dfa.constrain(self.logits, self.state, self.table) if self.table is not None else self.logits
        if self._close_bias is not None:
            masked = masked + self._close_bias
        if engine.temperature > 0:
            probs = torch.softmax(masked / engine.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=engine._generator)[:, 0]
        else:
            tok = masked.argmax(dim=-1)
        tok = torch.where(frozen, torch.full_like(tok, eos), tok)

        if self.table is not None:
            forced_len, forced_tok, forced_end = self._forced
            mid = torch.where(frozen, self.state, dfa.advance(self.state, tok, self.table))
            run = torch.where(frozen, torch.zeros_like(mid), forced_len[mid])
            run_block = torch.where(
                self._cols[:, 1:] - 1 < run[:, None], forced_tok[mid], torch.full_like(forced_tok[mid], eos)
            )
            block = torch.cat([tok[:, None], run_block], dim=1)
            self.state.copy_(torch.where(run > 0, forced_end[mid], mid))
            done = self.done | (self.state == dfa.accept)
        else:
            run = torch.zeros_like(tok)
            block = tok[:, None]
            done = self.done | (~frozen & (tok == eos))

        self.tokens_out.scatter_(1, self.out_pos[:, None] + self._cols, block)
        advance = torch.where((done | frozen) & (run == 0) & (tok == eos), 0, 1 + run)
        self.out_pos.add_(advance)
        self.done.copy_(done | (self.out_pos >= self.max_new))

        cache = self.cache
        index = cache["index"]
        # Logits at each row's last valid block column only.
        picked, _ = engine.model.decode_block_pick(block, cache, run)
        cache["index"] = index  # the decoder rebinds it; the carry keeps its tensor
        index.copy_(index + advance)
        self.logits.copy_(torch.where(frozen[:, None], self.logits, picked.float()))

    def _chunk_step(self) -> None:
        """A host-driven chunk's step: live while fewer than ``_chunk_n``
        steps of the chunk were live and a slot is not done."""
        self._live.copy_((self._chunk_k < self._chunk_n) & ~self.done.all())
        self._chunk_k.add_(self._live.to(torch.int32))
        self._step()

    def _run_steps(self, key: tuple, n: int, step) -> None:
        """``n`` calls of ``step``: on the graph route one replay of the
        key's graph (the key's first run is eager on the graphs' stream, its
        second is captured); else eagerly."""
        if not self._graphed:
            for _ in range(n):
                step()
            return
        engine = self.engine
        inputs = (engine.model, engine.draft_model, engine.temperature)
        if self._graph_inputs != inputs:
            # A graph holds the weights and the temperature it was captured with.
            self._graphs.clear()
            self._graph_inputs = inputs
        graph = self._graphs.get(key)
        if graph is None and key in self._warm:
            sampling = engine.temperature > 0
            graph = self._graphs[key] = StepGraph(step, n, engine._graph_pool, LAUNCH_COUNTERS,
                                                  (engine._generator,) if sampling else (), engine.mesh)
            self.stats.graphs_captured += 1
            self.stats.capture_seconds += graph.seconds
        if graph is None:
            self._warm.add(key)
            engine._graph_pool.warm(lambda: [step() for _ in range(n)])
        else:
            graph.replay()
            self.stats.replays += 1

    def _spec_step(self) -> None:
        """One speculative cycle over all slots (the JAX batcher's
        ``_make_spec_step``): the engine's draft/verify cycle over both
        paged pools, then the batcher's output and freezing rules, in place
        on the carry; reads nothing on the host. Every slot is frozen while
        ``_live`` is false."""
        frozen = self.done | (self.out_pos >= self.max_new) | ~self._live
        block, adv, logp, state, done = self.engine._spec_cycle(
            self.logits, self.cache, self.dcache, self.state, self.done, frozen, self.dfa, self.table,
            self._close_bias,
        )
        self.tokens_out.scatter_(1, self.out_pos[:, None] + self._cols, block)
        self.out_pos.add_(adv)
        self.logits.copy_(logp)
        self.state.copy_(state)
        self.done.copy_(done | (self.out_pos >= self.max_new))

    def _decode_chunk(self, n_steps: int) -> np.ndarray:
        """Host-driven chunk: up to ``n_steps`` steps, stopping once every
        slot is done. Returns the status pack (done, out_pos, state, steps)
        of every slot, each group's gathered in group order.

        On the engine's plain route (a gloo mesh, or ``_plain_decode``) the
        host reads ``done`` before each step; otherwise the chunk runs
        ``n_steps`` steps with its count in the device scalar ``_chunk_n``,
        and the host reads the device once, for the status pack (gathered
        over the groups after that read, outside any graph)."""
        engine = self.engine
        if engine._decode_route() == "plain":
            steps = 0
            while steps < n_steps and not bool(self.done.all()):
                self._step()
                steps += 1
            status = torch.stack([
                self.done.long(), self.out_pos, self.state, torch.full_like(self.out_pos, steps),
            ]).cpu().numpy()
            return status if self.n_groups == 1 else np.concatenate(self._groups(status), axis=1)
        mark = GeneratorMark(engine._generator) if engine.temperature > 0 else None
        self._chunk_k.zero_()
        self._chunk_n.fill_(n_steps)

        def step():
            if mark is not None:
                mark.before_step()
            self._chunk_step()

        self._run_steps(("chunk", n_steps), n_steps, step)
        status = torch.stack([
            self.done.long(), self.out_pos, self.state, self._chunk_k.long().expand_as(self.out_pos),
        ]).cpu().numpy()
        steps = int(status[3, 0])
        self.stats.idle_steps += n_steps - steps
        if mark is not None:
            mark.rewind(steps, n_steps)  # the idle steps drew too
        self._live.fill_(True)
        return status if self.n_groups == 1 else np.concatenate(self._groups(status), axis=1)

    def _all_tokens(self) -> np.ndarray:
        """Every slot's output buffer, each group's in group order."""
        tokens = self.tokens_out.cpu().numpy()
        return tokens if self.n_groups == 1 else np.concatenate(self._groups(tokens))

    # -- host-driven prefill -----------------------------------------------------

    @torch.no_grad()
    def _prefill_slot(self, slot: int, row: int, request: Request) -> None:
        """Prefill one request into a scratch cache and splice it into pool
        row ``row`` as logical slot ``slot``. Generation starts right after
        the request's own 128-multiple prompt bucket (train/serve
        prompt-block alignment), not after the shared ``prompt_len``."""
        engine = self.engine
        cfg = engine.config
        dev = engine.device
        patches = engine.preprocess(request.frames[None])
        prompt = engine.tokenizer.encode_array(request.prompt, self.prompt_len, add_bos=True)
        bucket = min(_round_up(len(engine.tokenizer.encode(request.prompt)) + 1, 128), self.prompt_len)
        scratch = init_kv_cache(cfg.decoder, 1, self.cache_len, engine.model.compute_dtype, device=dev,
                                kv_heads=engine.model.decoder.kv_heads)
        first_logits, scratch = engine.model.prefill(
            patches, torch.from_numpy(prompt[None]).to(dev), scratch,
            torch.tensor([bucket], dtype=torch.int32, device=dev),
        )
        for pool, filled in zip(self.cache["k"] + self.cache["v"], scratch["k"] + scratch["v"]):
            pool[row].copy_(filled[0])
        self.cache["index"][slot] = scratch["index"][0]
        self.state[slot] = self.dfa.start if self.dfa else 0
        self.logits[slot] = first_logits[0].float()
        self.tokens_out[slot] = engine.tokenizer.EOS
        self.out_pos[slot] = 0
        self.done[slot] = False

    # -- device refill -------------------------------------------------------------

    def _free_rows(self) -> list[int]:
        """This group's pool rows (local numbers) that no slot references.
        Chunks drain the ring, so at stage time the live rows are the slots'
        current rows (``_rows_host``, refreshed from the status pack after
        every chunk)."""
        live = set(int(r) for r in self._rows_host)
        return [r for r in range(self.local_rows) if r not in live]

    @torch.no_grad()
    def _stage(self) -> None:
        """Move queued requests from the host heap into the pool: one
        batched preprocess and prefill into a scratch cache, then K4 adopts
        each lane's park region into a free pool row. ``lengths`` marks each
        row's own round_up(tokens + 1, 128) bucket inside the shared prompt
        block.

        With data groups the stage's lanes are its request count rounded up
        to the groups (JAX ``serving.py:1015``); lane i falls to group
        ``i // (lanes / n_groups)``, which prefills its lanes (pad lanes:
        zero frames and prompt, bucket 128) and adopts its real ones into
        its own free rows. Every rank pops the same requests."""
        assert self._ring_occupancy() == 0, "stage with a non-empty ring: chunks are expected to drain it"
        free = self._free_rows()
        take = min(len(self._queue), self.queue_depth, len(free) * self.n_groups)
        if take <= 0:
            return
        engine = self.engine
        dev = engine.device
        requests = [heapq.heappop(self._queue)[2] for _ in range(take)]
        self._staged_total += take
        if self.n_groups > 1:
            lanes = min(_round_up(take, self.n_groups), self.queue_depth)
            per_group = lanes // self.n_groups
            requests = requests[self.group * per_group : (self.group + 1) * per_group]
            take = len(requests)
            if take == 0:
                return
            width = per_group
        else:
            width = take
        frames = np.stack([r.frames for r in requests])
        if width > take:
            frames = np.concatenate([frames, np.zeros((width - take,) + frames.shape[1:], frames.dtype)])
        patches = engine.preprocess(frames)
        prompts = np.zeros((width, self.prompt_len), np.int32)
        buckets = np.full((width,), min(128, self.prompt_len), np.int32)
        reqs = np.zeros((take,), np.int64)
        for i, request in enumerate(requests):
            prompts[i] = engine.tokenizer.encode_array(request.prompt, self.prompt_len, add_bos=True)
            n_tokens = len(engine.tokenizer.encode(request.prompt)) + 1
            buckets[i] = min(_round_up(n_tokens, 128), self.prompt_len)
            reqs[i] = request.request_id
        scratch = init_kv_cache(engine.config.decoder, width, self.park_len, engine.model.compute_dtype, device=dev,
                                kv_heads=engine.model.decoder.kv_heads)
        prompts_t, buckets_t = torch.from_numpy(prompts).to(dev), torch.from_numpy(buckets).to(dev)
        first_logits, scratch = engine.model.prefill(patches, prompts_t, scratch, buckets_t)
        first_logits = first_logits[:take]
        target_rows = torch.tensor(free[:take], dtype=torch.int32, device=dev)
        for pool_k, pool_v, filled_k, filled_v in zip(self.cache["k"], self.cache["v"], scratch["k"], scratch["v"]):
            adopt_rows(pool_k, filled_k, target_rows, take, self.park_len, pool_v, filled_v)
        first_logits = first_logits.float()
        if self.spec:
            # The draft's prefill, parked in its own pool at the same rows;
            # the ring keeps the processed start-state distribution.
            draft = engine.draft_model
            dscratch = init_kv_cache(engine.draft_config.decoder, width, self.draft_park_len, draft.compute_dtype,
                                     device=dev, kv_heads=draft.decoder.kv_heads)
            _, dscratch = draft.prefill(engine._draft_patches(frames), prompts_t, dscratch, buckets_t)
            for pool_k, pool_v, filled_k, filled_v in zip(self.dcache["k"], self.dcache["v"], dscratch["k"],
                                                          dscratch["v"]):
                adopt_rows(pool_k, filled_k, target_rows, take, self.draft_park_len, pool_v, filled_v)
            self._q_dindex[:take] = dscratch["index"][:take]
            start = torch.full((take,), self.dfa.start if self.dfa else 0, dtype=torch.long, device=dev)
            first_logits = engine._process(first_logits, start, self.dfa, self.table, self._close_bias)
        # Ring positions rebase to 0..take-1 (the ring is empty: see the assert).
        self._q_index[:take] = scratch["index"][:take]
        self._q_logits[:take] = first_logits
        self._q_req[:take] = torch.from_numpy(reqs).to(dev)
        self._q_phys[:take] = target_rows
        self._q_head, self._q_tail = 0, take

    def _ring_occupancy(self) -> int:
        return self._q_tail - self._q_head

    def _refill_one(self, comp_count: torch.Tensor) -> torch.Tensor:
        """Evict the first done slot (a completion record when it held a
        request) and point it at the ring head's parked row. Tensor ops only:
        ``slot`` and ``comp_count`` stay on the device as [1] indices."""
        eos = self.engine.tokenizer.EOS
        slot = torch.argmax(self.done.int()).reshape(1)
        live = self._slot_req[slot] >= 0
        self._comp_tokens[comp_count] = torch.where(live[:, None], self.tokens_out[slot], self._comp_tokens[comp_count])
        complete = self.state[slot] == self.dfa.accept if self.dfa is not None else self.done[slot]
        meta = torch.stack([self._slot_req[slot], self.out_pos[slot], complete.long()], dim=1)
        self._comp_meta[comp_count] = torch.where(live[:, None], meta, self._comp_meta[comp_count])
        qi = self._q_head % self.local_depth
        self.rows[slot] = self._q_phys[qi : qi + 1]
        self.cache["index"][slot] = self._q_index[qi : qi + 1]
        if self.spec:
            self.dcache["index"][slot] = self._q_dindex[qi : qi + 1]
        self.state[slot] = self.dfa.start if self.dfa else 0
        self.logits[slot] = self._q_logits[qi : qi + 1]
        self.tokens_out[slot] = eos
        self.out_pos[slot] = 0
        self.done[slot] = False
        self._slot_req[slot] = self._q_req[qi : qi + 1]
        self._q_head += 1
        return comp_count + live.long()

    def _refill_chunk(self) -> tuple[np.ndarray, int]:
        """Decode every slot until all are done and the ring is empty,
        draining every eligible refill each ``refill_period`` steps. Returns
        the status pack (done, out_pos, state, slot_req, steps, rows) and the
        number of completion records."""
        period = max(1, int(self.refill_period))
        comp_count = torch.zeros((1,), dtype=torch.long, device=self.engine.device)
        steps = 0
        while steps < self._device_steps:
            n_done = int(self.done.sum())  # the one host read per period
            if n_done == self.local_slots and self._q_head >= self._q_tail:
                break
            for _ in range(min(n_done, self._q_tail - self._q_head)):
                comp_count = self._refill_one(comp_count)
            self._run_steps(("refill", period), period, self._step)
            steps += period
        status = torch.cat([
            torch.stack([self.done.long(), self.out_pos, self.state, self._slot_req,
                         torch.full_like(self.out_pos, steps), self.rows.long()]).flatten(),
            comp_count,
        ]).cpu().numpy()
        return status[:-1].reshape(6, self.local_slots), int(status[-1])

    def _emit(self, req_id: int, ids: list[int], complete: bool) -> Completion:
        now = time.perf_counter()
        submitted = self._submit_time.pop(req_id, now)
        self.engine.stats.tokens_generated += len(ids)
        return Completion(
            req_id, self.engine.tokenizer.decode(ids), len(ids), bool(complete),
            # The host cannot see the first token mid-chunk; harvest time bounds it.
            first_token_s=round(now - submitted, 4), token_ids=ids,
        )

    def _run_device(self, on_complete: Callable[[Completion], None] | None, drain: bool) -> list[Completion]:
        """Drive the device-refill scheduler: stage -> chunk -> harvest."""
        results: list[Completion] = []

        def publish(completion: Completion) -> None:
            results.append(completion)
            if on_complete is not None:
                on_complete(completion)

        # Adopt slots prefilled through the host-path API (_fill_slots).
        host_filled = [(i, s.request_id) for i, s in enumerate(self._slots) if s.request_id is not None]
        lo = self.group * self.local_slots
        for i, req_id in host_filled:
            if lo <= i < lo + self.local_slots and int(self._slot_req[i - lo]) < 0:
                self._slot_req[i - lo] = req_id
            self._slots[i].request_id = None
        busy = self._groups(self._ring_occupancy() > 0 or bool((self._slot_req >= 0).any()))
        if not self._queue and not any(busy):
            return []

        stats = self.engine.stats
        while True:
            self._stage()
            chunk_start = time.perf_counter()
            status, comp_n = self._refill_chunk()
            stats.generate_calls += 1
            stats.generate_seconds += time.perf_counter() - chunk_start
            records = []
            if comp_n:
                meta = self._comp_meta[:comp_n].cpu().numpy()
                toks = self._comp_tokens[:comp_n].cpu().numpy()
                records = [(int(req_id), tok_row[:out_pos].tolist(), bool(complete))
                           for (req_id, out_pos, complete), tok_row in zip(meta, toks)]
            done_np, out_pos_np, state_np, slot_req_np, steps_np, rows_np = status
            # The free set at the next stage derives from this row map.
            self._rows_host = rows_np.astype(np.int32)
            live = int((slot_req_np >= 0).sum())
            unfinished = int(((slot_req_np >= 0) & (done_np == 0)).sum())
            # Every group's evictions, steps and counts (group order).
            groups = self._groups((records, int(steps_np[0]), live, unfinished, self._ring_occupancy()))
            for group_records, *_ in groups:
                for req_id, ids, complete in group_records:
                    publish(self._emit(req_id, ids, complete))
            stats.decode_steps += max(g[1] for g in groups)
            queued = any(g[4] > 0 for g in groups) or bool(self._queue)
            if not queued and sum(g[3] for g in groups) == 0:
                # Final harvest: finished slots that were never evicted.
                if sum(g[2] for g in groups):
                    final = []
                    if live:
                        tokens = self.tokens_out.cpu().numpy()
                        for i in range(self.local_slots):
                            if slot_req_np[i] < 0:
                                continue
                            complete = int(state_np[i]) == self.dfa.accept if self.dfa is not None else True
                            final.append((int(slot_req_np[i]), tokens[i, : out_pos_np[i]].tolist(), complete))
                    for group_final in self._groups(final):
                        for req_id, ids, complete in group_final:
                            publish(self._emit(req_id, ids, complete))
                    self._slot_req.fill_(-1)
                break
            if not drain and not queued:
                break
        return results

    # -- scheduler -----------------------------------------------------------------

    @replicated
    def submit(self, request: Request) -> None:
        heapq.heappush(self._queue, (-request.priority, self._submit_seq, request))
        self._submit_seq += 1
        self._submit_time[request.request_id] = time.perf_counter()

    def _fill_slots(self) -> None:
        """Host path: prefill queued requests into the empty slots."""
        if self.spec:
            raise RuntimeError(
                "host-path slot prefill has no draft prefill; speculative batching stages requests through the "
                "device ring (submit + run)"
            )
        lo = self.group * self.local_slots
        for i, slot in enumerate(self._slots):
            if slot.request_id is not None or not self._queue:
                continue
            _, _, request = heapq.heappop(self._queue)
            if lo <= i < lo + self.local_slots:  # the slot's group prefills it
                self._prefill_slot(i - lo, int(self._rows_host[i - lo]), request)
            slot.request_id = request.request_id
            slot.started = time.perf_counter()
            slot.first_token_at = 0.0

    def _next_chunk_steps(self) -> int:
        """Short chunks while work is queued, full chunks otherwise."""
        if self._queue:
            return max(1, min(self.latency_steps, self.chunk_steps))
        return self.chunk_steps

    def _harvest(self, status: np.ndarray) -> list[Completion]:
        done, out_pos, state, steps = status
        self.engine.stats.decode_steps += int(steps.max())
        now = time.perf_counter()
        tokens = None
        results: list[Completion] = []
        for i, slot in enumerate(self._slots):
            if slot.request_id is None:
                continue
            if slot.first_token_at == 0.0:
                slot.first_token_at = now
            if not done[i]:
                continue
            if tokens is None:
                tokens = self._all_tokens()
            ids = tokens[i, : out_pos[i]].tolist()
            complete = int(state[i]) == self.dfa.accept if self.dfa is not None else True
            submitted = self._submit_time.pop(slot.request_id, slot.started)
            results.append(Completion(
                slot.request_id, self.engine.tokenizer.decode(ids), int(out_pos[i]), complete,
                first_token_s=round(slot.first_token_at - submitted, 4), token_ids=ids,
            ))
            slot.request_id = None
        return results

    def run(self, on_complete: Callable[[Completion], None] | None = None, drain: bool = True) -> list[Completion]:
        """Drive the scheduler until the queue and all slots drain. On a
        mesh the workers run it too (``on_complete`` is rank 0's alone)."""
        mesh = self.mesh
        with mesh.controlled(("call", self, "run", (), {"drain": drain})) if mesh else contextlib.nullcontext():
            if self.device_refill:
                return self._run_device(on_complete, drain)
            return self._run_host(on_complete, drain)

    def _run_host(self, on_complete: Callable[[Completion], None] | None, drain: bool) -> list[Completion]:
        """The host-driven loop: fill empty slots, decode a chunk, harvest."""
        all_results: list[Completion] = []
        while self._queue or any(s.request_id is not None for s in self._slots):
            self._fill_slots()
            for completion in self._harvest(self._decode_chunk(self._next_chunk_steps())):
                all_results.append(completion)
                if on_complete is not None:
                    on_complete(completion)
            if not drain and not self._queue:
                break
        return all_results
