"""CUDA graphs of whole steps: the port's compiled decode loop and training step.

The counterpart of the JAX package's compiled loops (``parallel/engine.py``
``_decode_loop_fn`` under ``_get_generate``/``_get_resume``, and
``parallel/serving.py`` ``_build_decode``/``_build_decode_refill``) and of
its jitted training step (``train/trainer.py`` ``make_train_step``; the
port's ``Trainer.step`` captures one step, forward, backward and update, as
a graph of ``n = 1``). A decode step
function updates a carry of fixed tensors in place and reads nothing on the
host: it computes the loop's exit on the device, and a step taken after the
loop has ended changes nothing that is read later. ``StepGraph`` captures
``n`` calls of such a step into one ``torch.cuda.CUDAGraph``; a replay runs
them with one launch from the host, and the caller reads the carry's exit
flag once a replay.

Capture runs nothing on the card, so every kernel the step launches must
have run once at its shapes first (the kernels' first-call attribute
settings, the cuBLAS workspace): the callers run a key's first chunk of
steps eagerly on the graphs' side stream (``GraphPool.warm``), then capture.
A kernel wrapper adds one to its ``launches`` counter where it launches
(the port's launch checks read them), and a capture calls the wrappers
without launching anything: ``StepGraph`` takes back what the capture
added, and adds it again at each replay.

Over an NCCL mesh (``Mesh.capturable``) every rank captures and replays
the same steps, and the collectives between them are kernels of the graph:
a ``StepGraph`` given the mesh counts its collectives at each replay, and
each axis group's communicator exists before a capture, made by the
warm-up's collectives (NCCL makes a communicator at a group's first
collective). Every decision to warm up, capture, replay or stop rests on
values that the ranks of a group share, so that they replay in lockstep.
NCCL destroys a communicator only once no graph holds its collectives, so
the mesh keeps each such graph and destroys it before it leaves the world
(``Mesh.hold``).

Sampling draws from the engine's generator, which each graph registers
(``CUDAGraph.register_generator_state``): a replay draws what the same
steps would draw eagerly. A chunk runs on past the loop's end, and its idle
steps draw all the same; ``GeneratorMark`` puts the generator back to where
the last live step left it, so that the stream continues as the eager
loop's does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

__all__ = ["GeneratorMark", "GraphPool", "RouteStats", "StepGraph"]


@dataclass
class RouteStats:
    """How the decode loops ran: ``decode_route`` "graph" (replayed CUDA
    graphs of whole steps) or "eager" (steps launched from Python), the
    graphs captured and the seconds their capture took, the replays, and the
    idle steps (steps run past a loop's end, which change nothing)."""

    decode_route: str = ""
    graphs_captured: int = 0
    capture_seconds: float = 0.0
    replays: int = 0
    idle_steps: int = 0


class GraphPool:
    """One engine's (or trainer's) graphs: a memory pool they all share and
    the side stream on which their warm-up chunks run and they are captured."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pool = None
        self._stream = None

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def warm(self, fn: Callable[[], Any]) -> None:
        """Run ``fn`` (a key's first chunk of real steps) on the side stream,
        ordered after and before the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)


class StepGraph:
    """``n`` calls of ``step`` captured into one CUDA graph.

    ``counters`` are the kernel wrappers whose ``launches`` the steps move,
    or (object, attribute) pairs for another count that the steps' Python
    code moves (``flash_attention.reference_backwards``); ``generators`` the
    generators the steps draw from; ``mesh`` the mesh whose collectives the
    steps issue, whose ``collectives`` count is then a counter too, and which
    holds the graph until it leaves its world (``Mesh.hold``). The caller
    has run the step at these shapes already (``GraphPool.warm``). A capture
    that fails raises.
    """

    def __init__(self, step: Callable[[], Any], n: int, pool: GraphPool, counters: Sequence[Any] = (),
                 generators: Sequence[torch.Generator] = (), mesh: Any = None):
        self.n = n
        if mesh is not None:
            counters = (*counters, (mesh, "collectives"))
        self.counters = tuple(c if isinstance(c, tuple) else (c, "launches") for c in counters)
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        before = [getattr(counter, name) for counter, name in self.counters]
        start = time.perf_counter()
        # thread_local: a thread of the same process that uses the card
        # meanwhile (a mesh rank, NCCL's watchdog) is not refused by this
        # capture.
        with torch.cuda.graph(self.graph, pool=pool.pool, stream=pool.stream, capture_error_mode="thread_local"):
            for _ in range(n):
                step()
        self.seconds = time.perf_counter() - start
        # The capture called the wrappers but launched nothing.
        self.deltas = [getattr(counter, name) - b for (counter, name), b in zip(self.counters, before)]
        for (counter, name), b in zip(self.counters, before):
            setattr(counter, name, b)
        if mesh is not None:
            mesh.hold(self)

    def replay(self) -> None:
        """Run the ``n`` steps; each wrapper's counter moves by what they
        launch. A graph that ``reset`` destroyed raises."""
        self.graph.replay()
        for (counter, name), delta in zip(self.counters, self.deltas):
            setattr(counter, name, getattr(counter, name) + delta)

    def reset(self) -> None:
        """Destroy the captured graph (and with it what it holds of NCCL's)."""
        self.graph.reset()


class GeneratorMark:
    """Where a generator stood at the start of a chunk of steps that each
    draw the same amount, so that ``rewind`` can put it where the chunk's
    live steps alone would have left it.

    A CUDA generator is a Philox counter: its offset advances the same for
    every step, eager or replayed. A CPU generator has no offset, so the
    eager chunk keeps its state before each step (``before_step``)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.on_cuda = generator.device.type == "cuda"
        self.offset = generator.get_offset() if self.on_cuda else 0
        self.states: list[torch.Tensor] = []

    def before_step(self) -> None:
        if not self.on_cuda:
            self.states.append(self.generator.get_state())

    def rewind(self, live: int, ran: int) -> None:
        """``ran`` steps ran since the mark, the first ``live`` of them live."""
        if live >= ran:
            return
        if self.on_cuda:
            per_step = (self.generator.get_offset() - self.offset) // ran
            self.generator.set_offset(self.offset + live * per_step)
        else:
            self.generator.set_state(self.states[live])
