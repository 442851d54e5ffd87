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
  move. The chunk is a host loop over device tensors. The host reads the
  device once per ``refill_period`` steps (the loop and refill conditions)
  and once per chunk (the status pack); the refill itself is tensor ops
  (``argmax(done)``, indexed updates) in the JAX order.
- **Host-driven refill** (``device_refill=False``): per-request prefill
  spliced into the pool between fixed decode chunks, with adaptive chunk
  sizing and an early exit. It is the parity oracle.

The pool is in the compute dtype, so on the card each decode step writes
and attends through K5 (``decode_attention_update`` on a bf16 cache). One
device: no mesh, no sharding, no data-axis grouping, so a stage's width is
its request count and no stage has pad lanes (the JAX batcher pads a stage
only to divide its data axis). Not ported:
speculative decoding in the batcher (the port's engine has no draft model, so
``spec`` is always False).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..models.lm import init_kv_cache
from ..ops.decode_attention import adopt_rows

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

    def __post_init__(self):
        engine = self.engine
        cfg = engine.config
        self.spec = False  # no draft model in the port's engine (the analyzer reads this flag)
        self.max_new = self.max_new_tokens or engine.max_new_tokens
        self.dfa = engine.dfa
        self.table = engine._table_for(self.dfa) if self.dfa is not None else None
        self._forced = engine._forced_for(self.dfa) if self.dfa is not None else None
        self.block_width = engine._block_width(self.dfa)
        # Tail slack past the last live position: frozen rows still write a
        # block at their index, as in the JAX batcher.
        self.cache_len = _round_up(
            cfg.video_tokens + self.prompt_len + self.max_new + 2 * self.block_width + 17, 128
        )
        if self.cache_len > cfg.decoder.max_seq_len:
            raise ValueError("slot cache exceeds max_seq_len")
        self.out_width = self.max_new + 2 * self.block_width
        self.park_len = cfg.video_tokens + self.prompt_len
        self._slots = [_Slot() for _ in range(self.slots)]
        if self.queue_depth <= 0:
            self.queue_depth = 2 * self.slots
        self._close_bias = engine.close_bias_array()
        self._cols = torch.arange(self.block_width, device=engine.device)[None, :]
        self._init_device_state()
        if self.device_refill:
            self._init_ring_state()

    # -- device state -----------------------------------------------------------

    def _init_device_state(self):
        """The KV pool (compute dtype) and the per-slot decode state.

        Host-driven mode: ``slots`` physical rows, identity addressing.
        Device refill: ``slots + queue_depth`` rows addressed through
        ``rows``; slot i starts on row i and the rest are free for staging.
        """
        engine = self.engine
        cfg = engine.config
        dev = engine.device
        self.total_rows = self.slots + self.queue_depth if self.device_refill else self.slots
        pool = init_kv_cache(cfg.decoder, self.total_rows, self.cache_len, engine.model.compute_dtype,
                             device=dev)
        self.cache = {
            "k": pool["k"],
            "v": pool["v"],
            # Logical per-slot fill counts (the rows table owns physical addressing).
            "index": torch.zeros((self.slots,), dtype=torch.int32, device=dev),
        }
        self._rows_host = np.arange(self.slots, dtype=np.int32)
        if self.device_refill:
            self.rows = torch.arange(self.slots, dtype=torch.int32, device=dev)
            self.cache["rows"] = self.rows
        eos = engine.tokenizer.EOS
        self.state = torch.full((self.slots,), self.dfa.start if self.dfa else 0, dtype=torch.long, device=dev)
        self.logits = torch.zeros((self.slots, cfg.decoder.vocab_size), dtype=torch.float32, device=dev)
        self.tokens_out = torch.full((self.slots, self.out_width), eos, dtype=torch.long, device=dev)
        self.out_pos = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        # Empty slots sit "done" so the decode freezes them.
        self.done = torch.ones((self.slots,), dtype=torch.bool, device=dev)

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
        depth = self.queue_depth
        self._q_index = torch.zeros((depth,), dtype=torch.int32, device=dev)
        self._q_logits = torch.zeros((depth, engine.config.decoder.vocab_size), dtype=torch.float32, device=dev)
        self._q_req = torch.full((depth,), -1, dtype=torch.long, device=dev)
        self._q_phys = torch.zeros((depth,), dtype=torch.int32, device=dev)
        self._q_head = 0  # host-side: the host counts every refill it issues
        self._q_tail = 0
        self._slot_req = torch.full((self.slots,), -1, dtype=torch.long, device=dev)
        comp_rows = self.slots + depth
        self._comp_tokens = torch.full((comp_rows, self.out_width), engine.tokenizer.EOS, dtype=torch.long,
                                       device=dev)
        self._comp_meta = torch.full((comp_rows, 3), -1, dtype=torch.long, device=dev)
        self._staged_total = 0
        # Worst case one fast slot serves every parked request in turn; the
        # loop exits early once everything is done.
        self._device_steps = (depth + 1) * (self.max_new + 1) + self.slots

    # -- the decode step ---------------------------------------------------------

    @torch.no_grad()
    def _step(self) -> None:
        """One grammar-constrained decode iteration over all slots."""
        engine = self.engine
        dfa = self.dfa
        eos = engine.tokenizer.EOS
        done, state = self.done, self.state
        masked = dfa.constrain(self.logits, state, self.table) if self.table is not None else self.logits
        if self._close_bias is not None:
            masked = masked + self._close_bias
        if engine.temperature > 0:
            probs = torch.softmax(masked / engine.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=engine._generator)[:, 0]
        else:
            tok = masked.argmax(dim=-1)
        tok = torch.where(done, torch.full_like(tok, eos), tok)

        if self.table is not None:
            forced_len, forced_tok, forced_end = self._forced
            mid = torch.where(done, state, dfa.advance(state, tok, self.table))
            run = torch.where(done, torch.zeros_like(mid), forced_len[mid])
            run_block = torch.where(
                self._cols[:, 1:] - 1 < run[:, None], forced_tok[mid], torch.full_like(forced_tok[mid], eos)
            )
            block = torch.cat([tok[:, None], run_block], dim=1)
            state = torch.where(run > 0, forced_end[mid], mid)
            done = done | (state == dfa.accept)
        else:
            run = torch.zeros_like(tok)
            block = tok[:, None]
            done = done | (tok == eos)

        self.tokens_out.scatter_(1, self.out_pos[:, None] + self._cols, block)
        advance = torch.where(done & (run == 0) & (tok == eos), 0, 1 + run)
        self.out_pos = self.out_pos + advance
        self.done = done | (self.out_pos >= self.max_new)
        self.state = state

        cache = self.cache
        index_before = cache["index"]
        # Logits at each row's last valid block column only.
        picked, cache = engine.model.decode_block_pick(block, cache, run)
        cache["index"] = (index_before + advance).to(torch.int32)
        self.logits = picked.float()

    def _decode_chunk(self, n_steps: int) -> np.ndarray:
        """Host-driven chunk: up to ``n_steps`` steps, stopping once every
        slot is done. Returns the status pack (done, out_pos, state, steps)."""
        steps = 0
        while steps < n_steps and not bool(self.done.all()):
            self._step()
            steps += 1
        return torch.stack([
            self.done.long(), self.out_pos, self.state, torch.full_like(self.out_pos, steps),
        ]).cpu().numpy()

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
        scratch = init_kv_cache(cfg.decoder, 1, self.cache_len, engine.model.compute_dtype, device=dev)
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
        """Pool rows no slot references. Chunks drain the ring, so at stage
        time the live rows are the slots' current rows (``_rows_host``,
        refreshed from the status pack after every chunk)."""
        live = set(int(r) for r in self._rows_host)
        return [r for r in range(self.total_rows) if r not in live]

    @torch.no_grad()
    def _stage(self) -> None:
        """Move queued requests from the host heap into the pool: one
        batched preprocess and prefill into a scratch cache, then K4 adopts
        each lane's park region into a free pool row. ``lengths`` marks each
        row's own round_up(tokens + 1, 128) bucket inside the shared prompt
        block."""
        assert self._ring_occupancy() == 0, "stage with a non-empty ring: chunks are expected to drain it"
        free = self._free_rows()
        take = min(len(self._queue), self.queue_depth, len(free))
        if take <= 0:
            return
        engine = self.engine
        dev = engine.device
        requests = [heapq.heappop(self._queue)[2] for _ in range(take)]
        patches = engine.preprocess(np.stack([r.frames for r in requests]))
        prompts = np.zeros((take, self.prompt_len), np.int32)
        buckets = np.zeros((take,), np.int32)
        reqs = np.zeros((take,), np.int64)
        for i, request in enumerate(requests):
            prompts[i] = engine.tokenizer.encode_array(request.prompt, self.prompt_len, add_bos=True)
            n_tokens = len(engine.tokenizer.encode(request.prompt)) + 1
            buckets[i] = min(_round_up(n_tokens, 128), self.prompt_len)
            reqs[i] = request.request_id
        scratch = init_kv_cache(engine.config.decoder, take, self.park_len, engine.model.compute_dtype, device=dev)
        first_logits, scratch = engine.model.prefill(
            patches, torch.from_numpy(prompts).to(dev), scratch, torch.from_numpy(buckets).to(dev)
        )
        target_rows = torch.tensor(free[:take], dtype=torch.int32, device=dev)
        for pool_k, pool_v, filled_k, filled_v in zip(self.cache["k"], self.cache["v"], scratch["k"], scratch["v"]):
            adopt_rows(pool_k, filled_k, target_rows, take, self.park_len, pool_v, filled_v)
        # Ring positions rebase to 0..take-1 (the ring is empty: see the assert).
        self._q_index[:take] = scratch["index"]
        self._q_logits[:take] = first_logits.float()
        self._q_req[:take] = torch.from_numpy(reqs).to(dev)
        self._q_phys[:take] = target_rows
        self._q_head, self._q_tail = 0, take
        self._staged_total += take

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
        qi = self._q_head % self.queue_depth
        self.rows[slot] = self._q_phys[qi : qi + 1]
        self.cache["index"][slot] = self._q_index[qi : qi + 1]
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
            if n_done == self.slots and self._q_head >= self._q_tail:
                break
            for _ in range(min(n_done, self._q_tail - self._q_head)):
                comp_count = self._refill_one(comp_count)
            for _ in range(period):
                self._step()
            steps += period
        status = torch.cat([
            torch.stack([self.done.long(), self.out_pos, self.state, self._slot_req,
                         torch.full_like(self.out_pos, steps), self.rows.long()]).flatten(),
            comp_count,
        ]).cpu().numpy()
        return status[:-1].reshape(6, self.slots), int(status[-1])

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
        for i, req_id in host_filled:
            if int(self._slot_req[i]) < 0:
                self._slot_req[i] = req_id
            self._slots[i].request_id = None
        if not self._queue and self._ring_occupancy() == 0 and not bool((self._slot_req >= 0).any()):
            return []

        stats = self.engine.stats
        while True:
            self._stage()
            chunk_start = time.perf_counter()
            status, comp_n = self._refill_chunk()
            stats.generate_calls += 1
            stats.generate_seconds += time.perf_counter() - chunk_start
            if comp_n:
                meta = self._comp_meta[:comp_n].cpu().numpy()
                toks = self._comp_tokens[:comp_n].cpu().numpy()
                for (req_id, out_pos, complete), tok_row in zip(meta, toks):
                    publish(self._emit(int(req_id), tok_row[:out_pos].tolist(), bool(complete)))
            done_np, out_pos_np, state_np, slot_req_np, steps_np, rows_np = status
            # The free set at the next stage derives from this row map.
            self._rows_host = rows_np.astype(np.int32)
            stats.decode_steps += int(steps_np[0])
            live = int((slot_req_np >= 0).sum())
            unfinished = int(((slot_req_np >= 0) & (done_np == 0)).sum())
            queued = self._ring_occupancy() > 0 or bool(self._queue)
            if not queued and unfinished == 0:
                # Final harvest: finished slots that were never evicted.
                if live:
                    tokens = self.tokens_out.cpu().numpy()
                    for i in range(self.slots):
                        if slot_req_np[i] < 0:
                            continue
                        complete = int(state_np[i]) == self.dfa.accept if self.dfa is not None else True
                        publish(self._emit(int(slot_req_np[i]), tokens[i, : out_pos_np[i]].tolist(), complete))
                    self._slot_req.fill_(-1)
                break
            if not drain and not queued:
                break
        return results

    # -- scheduler -----------------------------------------------------------------

    def submit(self, request: Request) -> None:
        heapq.heappush(self._queue, (-request.priority, self._submit_seq, request))
        self._submit_seq += 1
        self._submit_time[request.request_id] = time.perf_counter()

    def _fill_slots(self) -> None:
        """Host path: prefill queued requests into the empty slots."""
        for i, slot in enumerate(self._slots):
            if slot.request_id is not None or not self._queue:
                continue
            _, _, request = heapq.heappop(self._queue)
            self._prefill_slot(i, int(self._rows_host[i]), request)
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
        self.engine.stats.decode_steps += int(steps[0])
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
                tokens = self.tokens_out.cpu().numpy()
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
        """Drive the scheduler until the queue and all slots drain."""
        if self.device_refill:
            return self._run_device(on_complete, drain)
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
