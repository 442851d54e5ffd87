"""A (data, model) mesh of ranks over ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/mesh.py``. Two axes:

- ``data``: batch parallelism. Each data group serves its own rows of a
  batch (the engine pads a batch to the axis) and its own slots of the
  continuous batcher.
- ``model``: tensor parallelism over attention heads and the MLP's hidden
  width (``parallel/sharding.py``): one all-reduce after each block's
  ``out`` and ``down`` projections.

Rank ``r`` sits at data index ``r // model`` and model index ``r % model``,
the row-major order of JAX's ``make_mesh`` over ``(data, model)``.

One-axis meshes (training): ``build_pipe_mesh`` (``pipe``: pipeline
stages, ``parallel/pipeline_parallel.py``), ``build_cp_mesh`` (``cp``: the
sequence, ``parallel/context_parallel.py``) and ``build_expert_mesh``
(``expert``: MoE experts, ``parallel/expert_parallel.py``), JAX's 1-D
meshes, over the same worlds and the same control plane; rank ``r`` sits at
index ``r`` of the axis.

Autograd. ``Mesh.all_reduce``, ``all_gather`` and ``ppermute`` are
invisible to autograd; training goes through their differentiable forms:
the Megatron pair ``copy_to_axis`` (forward identity, backward all-reduce:
at the input of a column-parallel region, whose ranks each use part of a
replicated tensor) and ``reduce_from_axis`` (forward all-reduce, backward
identity: the partial sums of a row-parallel output), ``gather_from_axis``
(forward all-gather, backward this rank's part) and ``permute_on_axis``
(backward the inverse permutation). Every rank computes the replicated
loss, so a gradient arriving at a replicated tensor is already whole:
``torch.distributed.nn.functional.all_reduce``, whose backward
all-reduces again, would multiply it by the axis size.

Ranks. ``build_mesh(config, devices)`` names one ``torch.device`` a rank;
the default is one rank per visible card, as JAX's default is every
device (the CPU alone when no card is visible). Without a launcher the
calling process becomes rank 0 and ``build_mesh`` starts the other ranks as
processes of its own, which it stops again at ``Mesh.close`` and at exit;
under ``torchrun`` (``maybe_initialize_distributed``) every process is
already a rank.

Backend. ``nccl`` when every rank has a card of its own; ``gloo`` when a card
is named twice (NCCL refuses two ranks on one device) or the ranks are on
the CPU. The rule depends on ``devices`` alone; the choice is logged
(``event=mesh_built``). The collectives are ``all_reduce`` and
``all_gather`` on both backends: gloo takes CUDA tensors for both
(``tools/gloo_cuda_probe.py``), staging them through the host itself.
Under NCCL the collectives are kernels on the card, which a CUDA graph
captures with the steps around them: the decode loops and the training step
over a ``(data, model)`` mesh (``Mesh.capturable``) and the training step
over a pipe mesh (``Mesh.trains_on_graphs``) replay as graphs, as on one
card (``parallel/graphs.py``); gloo's run on the host, outside any graph.
``ppermute`` is an all_gather from which each rank takes its source's
part: gloo aborts the process on an ``isend`` of a CUDA tensor (the probe,
on an H100: ``writev ... Bad address``), and one route serves every
backend.

Execution. Inside the engine every rank runs the same method with the same
arguments (SPMD). Outside it the program stays single-controller, as in
JAX: rank 0 runs it, and every other rank runs ``serve``, which replays
what rank 0 sends: the construction of an engine or a batcher, their
methods (``generate``, ``generate_text``, ``continue_session``, the batcher's
``submit`` and ``run``), public attribute sets (``engine.dfa = ...``) and
``close``. Messages and each rank's outcome travel through the rendezvous
store, never through a collective, so that an idle worker waits without a
collective timeout. After each call rank 0 waits for every rank's outcome
(within the group timeout): a rank that raised while rank 0 did not makes
rank 0 raise ``MeshWorkerError`` with that rank's traceback; a rank that
stops answering makes rank 0's collective or its wait time out. A 1 x 1
mesh creates no process group and no process.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import logging
import math
import multiprocessing
import os
import pickle
import time
import traceback
import weakref
from datetime import timedelta
from typing import Any, Callable, Iterator, Mapping

import torch
import torch.distributed as dist

__all__ = [
    "CP_AXIS",
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshWorkerError",
    "PIPE_AXIS",
    "build_cp_mesh",
    "build_expert_mesh",
    "build_mesh",
    "build_pipe_mesh",
    "choose_backend",
    "copy_to_axis",
    "default_devices",
    "distributed_init_kwargs",
    "gather_from_axis",
    "maybe_initialize_distributed",
    "mesh_devices",
    "mesh_shape_from_config",
    "permute_on_axis",
    "reduce_from_axis",
    "replicated",
    "serve",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
CP_AXIS = "cp"
EXPERT_AXIS = "expert"
DEFAULT_TIMEOUT_S = 600.0
_log = logging.getLogger("video_transformer")


class MeshWorkerError(RuntimeError):
    """A worker rank raised where rank 0 did not."""


# -- the env contract ---------------------------------------------------------


def distributed_init_kwargs(env: Mapping[str, str]) -> dict[str, Any] | None:
    """Parse torchrun's env contract into ``init_process_group`` arguments,
    or None when no multi-process world is configured.

    ``MASTER_ADDR`` enables the path (``MASTER_PORT`` defaults to 29500);
    ``WORLD_SIZE`` and ``RANK`` must then be set together, as integers, with
    the rank in ``[0, WORLD_SIZE)``. Neither of them, or a world of one,
    means a single process: None. ``LOCAL_RANK`` (default: ``RANK``) picks
    the process's card.
    """
    addr = env.get("MASTER_ADDR")
    if addr is None:
        return None
    num = env.get("WORLD_SIZE")
    rank = env.get("RANK")
    if (num is None) != (rank is None):
        raise ValueError("WORLD_SIZE and RANK must be set together (or neither, for a single process)")
    if num is None:
        return None
    try:
        world, rank_i = int(num), int(rank)  # type: ignore[arg-type]
        port = int(env.get("MASTER_PORT", "29500"))
        local = int(env.get("LOCAL_RANK", rank))  # type: ignore[arg-type]
    except ValueError as exc:
        raise ValueError(f"WORLD_SIZE/RANK/MASTER_PORT/LOCAL_RANK must be integers: {exc}") from None
    if not 0 <= rank_i < world:
        raise ValueError(f"RANK {rank} outside [0, {num})")
    if world == 1:
        return None
    return {"host": addr, "port": port, "world_size": world, "rank": rank_i, "local_rank": local}


def maybe_initialize_distributed(timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a torchrun world when its env vars are set; a single process is
    left alone. Each process takes the card ``LOCAL_RANK`` (modulo the
    visible cards); the backend follows ``choose_backend``. Call it before
    any engine is built: afterwards ``build_mesh`` spans the world."""
    kwargs = distributed_init_kwargs(os.environ)
    if kwargs is None or dist.is_initialized():
        return False
    world, rank = kwargs["world_size"], kwargs["rank"]
    count = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.device("cuda", kwargs["local_rank"] % count) if count else torch.device("cpu")
    shared = count and local_world > count
    backend = "gloo" if device.type == "cpu" or shared else "nccl"
    # Under torchrun's agent the agent hosts the store; every rank is its client.
    master = rank == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    store = dist.TCPStore(kwargs["host"], kwargs["port"], world, master, timeout=timedelta(seconds=timeout_s))
    _init_process(store, rank, world, device, backend, timeout_s)
    if rank == 0:
        atexit.register(_close_at_exit)  # the workers leave serve() when rank 0 ends
    return True


# -- shapes and devices ---------------------------------------------------------


def default_devices() -> list[torch.device]:
    """One rank per visible card; the CPU alone when there is none."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(count)] or [torch.device("cpu")]


def mesh_devices(device: torch.device | str, mesh_config: Mapping[str, Any] | None) -> list[torch.device]:
    """The ranks of a program that serves on ``device``: one per visible
    card on CUDA (``default_devices``); on the CPU as many CPU ranks as the
    config's axes name (``-1`` counts 1)."""
    if _PROCESS is not None:  # a torchrun world: its ranks
        return [_PROCESS.device] * _PROCESS.world
    if torch.device(device).type != "cpu":
        return default_devices()
    cfg = dict(mesh_config or {})
    count = max(int(cfg.get("data", -1)), 1) * max(int(cfg.get("model", 1)), 1)
    return [torch.device("cpu")] * count


def mesh_shape_from_config(mesh_config: Mapping[str, Any] | None, num_devices: int | None = None) -> tuple[int, int]:
    """Resolve (data, model) axis sizes; -1 on an axis means "all remaining"."""
    if num_devices is None:
        num_devices = len(default_devices())
    cfg = dict(mesh_config or {})
    data = int(cfg.get("data", -1))
    model = int(cfg.get("model", 1))
    if model <= 0:
        model = 1
    if num_devices % model != 0:
        raise ValueError(f"model axis {model} does not divide device count {num_devices}")
    if data <= 0:
        data = num_devices // model
    if data * model != num_devices:
        raise ValueError(f"mesh {data}x{model} != device count {num_devices}")
    return data, model


def choose_backend(devices: list[torch.device]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if all(d.type == "cuda" for d in devices) and len({str(d) for d in devices}) == len(devices):
        return "nccl"
    return "gloo"


def _normalize(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return device


# -- the process's place in the world ---------------------------------------------


@dataclasses.dataclass
class _Process:
    store: Any
    rank: int
    world: int
    device: torch.device
    backend: str
    timeout_s: float
    procs: list = dataclasses.field(default_factory=list)
    seq: int = 0
    """Messages rank 0 has sent (the next one's key is ``msg/{seq + 1}``)."""


_PROCESS: _Process | None = None
# The CUDA graphs that captured collectives of this process's world. NCCL
# destroys a communicator only once no graph holds its collectives (its
# destroy waits for them), so leaving the world destroys these first.
_GRAPHS: weakref.WeakSet = weakref.WeakSet()


def _leave(proc: _Process) -> None:
    """Leave the world with the other ranks: destroy this rank's held graphs
    (a replay of one raises after) once the card has run what was launched,
    wait through the store until every rank has done so (at most the
    world's timeout, then raise), and only then leave the process group.
    On 2 and 4 H100s a rank that left while another had not yet begun to
    leave stalled until that one began, so all leave at once."""
    graphs = list(_GRAPHS)
    if graphs and torch.cuda.is_available():
        torch.cuda.synchronize()
    for graph in graphs:
        graph.reset()
    _GRAPHS.clear()
    proc.store.set(f"left/{proc.rank}", b"1")
    proc.store.wait([f"left/{r}" for r in range(proc.world)], timedelta(seconds=proc.timeout_s))
    if dist.is_initialized():
        dist.destroy_process_group()


# The store takes values of at most 8 MiB; larger ones go in parts.
_PART_BYTES = 4 << 20


def _put(store, key: str, data: bytes) -> None:
    """``data`` under ``key`` in parts; the part count is written last, so
    that a reader that sees ``key`` sees every part."""
    parts = max(1, -(-len(data) // _PART_BYTES))
    for i in range(parts):
        store.set(f"{key}/{i}", data[i * _PART_BYTES:(i + 1) * _PART_BYTES])
    store.set(key, str(parts))


def _take(store, key: str, delete: bool = False) -> bytes:
    parts = int(store.get(key))
    data = b"".join(store.get(f"{key}/{i}") for i in range(parts))
    if delete:
        for name in [f"{key}/{i}" for i in range(parts)] + [key]:
            store.delete_key(name)
    return data


def _init_process(store, rank: int, world: int, device: torch.device, backend: str, timeout_s: float) -> None:
    global _PROCESS
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
    _PROCESS = _Process(dist.PrefixStore("vtx_mesh/", store), rank, world, device, backend, timeout_s)


def _worker_main(rank: int, world: int, port: int, device: str, backend: str, timeout_s: float) -> None:
    """A spawned rank: join rank 0's store and world, then ``serve``."""
    device_t = torch.device(device)
    if device_t.type == "cpu":
        torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, world, False, timeout=timedelta(seconds=timeout_s))
    _init_process(store, rank, world, device_t, backend, timeout_s)
    serve()


def _spawn_world(devices: list[torch.device], backend: str, timeout_s: float) -> None:
    """Make the calling process rank 0 of a new world and start the others."""
    world = len(devices)
    store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=timedelta(seconds=timeout_s),
                          wait_for_workers=False)  # port 0: the OS picks a free one
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_worker_main, args=(r, world, store.port, str(devices[r]), backend, timeout_s),
                    daemon=True, name=f"vtx-mesh-rank{r}")
        for r in range(1, world)
    ]
    for proc in procs:
        proc.start()
    _init_process(store, 0, world, devices[0], backend, timeout_s)
    _PROCESS.procs = procs


# -- the mesh -----------------------------------------------------------------------


class Mesh:
    """This rank's view of a mesh: its device, its group on each axis, the
    collectives the model needs, and (on rank 0 of a world it controls) the
    channel to the worker ranks.

    ``axes`` names the axes and their sizes in row-major order
    (``{DATA_AXIS: d, MODEL_AXIS: m}``, or ``{PIPE_AXIS: n}`` for a
    pipeline's stages). ``data`` and ``model`` are the sizes of those two
    axes (1 where the mesh has no such axis)."""

    def __init__(self, axes: Mapping[str, int], devices: list[torch.device], backend: str | None = None,
                 rank: int = 0, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.axes = {k: int(v) for k, v in axes.items()}
        self.devices = list(devices)
        self.backend = backend
        self.rank = int(rank)
        self.timeout_s = float(timeout_s)
        self.groups: dict[str, Any] = dict.fromkeys(self.axes)
        self._depth = 0
        self._next_handle = 0
        self._objects: dict[int, Any] = {}  # workers: the replayed objects
        self._handles: weakref.WeakValueDictionary = weakref.WeakValueDictionary()  # rank 0: handle -> object
        self._refs: dict[int, tuple[int, Any]] = {}  # rank 0: id(obj) -> (ref id, obj) sent by reference
        self._drops: list[int] = []
        self._closed = False
        self.collectives = 0
        """Collectives this rank has issued on the mesh's groups."""

    def _make_groups(self) -> None:
        """The group of each axis: the ranks that differ from this one on
        that axis alone. Every rank of the world creates every group, in one
        order (a ``new_group`` rule): axis by axis, the groups in the order
        of the other axes' indices."""
        timeout = timedelta(seconds=self.timeout_s)
        if self.size == 1:
            return
        for axis in self.axes:
            for ranks in self._axis_groups(axis):
                group = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self.groups[axis] = group

    def _axis_groups(self, axis: str) -> list[list[int]]:
        """Every group of ``axis``, each its ranks in axis order."""
        names, sizes = list(self.axes), list(self.axes.values())
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        a = names.index(axis)
        others = [range(n) if i != a else range(1) for i, n in enumerate(sizes)]
        groups = []
        for coords in itertools.product(*others):
            base = sum(c * s for c, s in zip(coords, strides))
            groups.append([base + j * strides[a] for j in range(sizes[a])])
        return groups

    # -- shape -------------------------------------------------------------

    @property
    def data(self) -> int:
        return self.axes.get(DATA_AXIS, 1)

    @property
    def model(self) -> int:
        return self.axes.get(MODEL_AXIS, 1)

    @property
    def size(self) -> int:
        return math.prod(self.axes.values())

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def data_index(self) -> int:
        return self.axis_index(DATA_AXIS)

    @property
    def model_index(self) -> int:
        return self.axis_index(MODEL_AXIS)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def capturable(self) -> bool:
        """Whether the serving steps over this mesh may be captured into
        CUDA graphs: NCCL (one card a rank, the collectives kernels on it)
        over a ``(data, model)`` mesh. Gloo's collectives run on the host;
        no serving route runs on a one-axis mesh."""
        return self.backend == "nccl" and set(self.axes) <= {DATA_AXIS, MODEL_AXIS}

    @property
    def trains_on_graphs(self) -> bool:
        """Whether a trainer's step over this mesh may be captured: a
        ``capturable`` mesh, or NCCL over ``pipe`` (whose tick schedule
        branches only on the stage count, the microbatches and the stage).
        ``cp`` and ``expert`` meshes stay eager: no trainer builds them."""
        return self.capturable or (self.backend == "nccl" and set(self.axes) == {PIPE_AXIS})

    @property
    def is_controller(self) -> bool:
        """Rank 0 of a mesh of more than one rank: it sends the calls."""
        return self.rank == 0 and self.size > 1 and not self._closed

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.axes.items())
        return f"Mesh({axes}, rank={self.rank}, backend={self.backend}, devices={[str(d) for d in self.devices]})"

    # -- collectives (the data plane) ------------------------------------------------

    def _group(self, axis: str):
        return self.groups[axis]

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.axes.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 for an axis the mesh does not have)."""
        if axis not in self.axes:
            return 0
        sizes = list(self.axes.values())
        a = list(self.axes).index(axis)
        return self.rank // math.prod(sizes[a + 1:]) % sizes[a]

    def all_reduce(self, tensor: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """The reduction of ``tensor`` over ``axis`` (a new tensor of its
        dtype; the input when the axis has one rank). Half-precision floats
        are reduced in float32 and rounded once (a max is exact).

        Safe inside a CUDA graph's capture (NCCL): ``buf`` then comes from
        the graph's pool and each replay reduces into it again; the count
        ``collectives`` is a ``StepGraph`` counter, moved at each replay."""
        if self.axis_size(axis) == 1:
            return tensor
        wide = tensor.dtype in (torch.bfloat16, torch.float16)
        buf = tensor.float() if wide else tensor.clone()
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(buf, op=reduce_op, group=self._group(axis))
        self.collectives += 1
        return buf.to(tensor.dtype) if wide else buf

    def all_gather(self, tensor: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's ``tensor`` along ``axis``, concatenated on ``dim`` in
        rank order (the input when the axis has one rank); safe inside a
        capture, as ``all_reduce`` is."""
        n = self.axis_size(axis)
        if n == 1:
            return tensor
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor, group=self._group(axis))
        self.collectives += 1
        return torch.cat(parts, dim=dim)

    def ppermute(self, tensor: torch.Tensor, axis: str, perm: list[tuple[int, int]]) -> torch.Tensor:
        """JAX's ``lax.ppermute``: the ``tensor`` of the rank that sends to
        this one under ``perm`` ((source, destination) axis indices), or
        zeros where none does. One all_gather (see the module docstring)."""
        n = self.axis_size(axis)
        sources = {dst: src for src, dst in perm}
        src = sources.get(self.axis_index(axis))
        if n == 1:
            return tensor.clone() if src == 0 else torch.zeros_like(tensor)
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor, group=self._group(axis))
        self.collectives += 1
        return parts[src] if src is not None else torch.zeros_like(tensor)

    def hold(self, graph) -> None:
        """Keep ``graph`` (a ``StepGraph`` whose steps issue this mesh's
        collectives) until the world is left, which destroys it first."""
        _GRAPHS.add(graph)

    def gather_objects(self, obj: Any, axis: str = DATA_AXIS) -> list[Any]:
        """Every rank's ``obj`` along ``axis``, in rank order."""
        if self.axis_size(axis) == 1:
            return [obj]
        out: list[Any] = [None] * self.axis_size(axis)
        dist.all_gather_object(out, obj, group=self._group(axis))
        self.collectives += 1
        return out

    # -- handles ----------------------------------------------------------------

    def register(self, obj: Any) -> int:
        """Give ``obj`` the next handle. Every rank registers the same
        objects in the same order, so handles agree across ranks; rank 0
        keeps a weak reference and tells the workers when it is freed."""
        handle = self._next_handle
        self._next_handle += 1
        obj._mesh_handle = handle
        if self.rank == 0:
            self._handles[handle] = obj
            weakref.finalize(obj, self._drops.append, handle)
        else:
            self._objects[handle] = obj
        return handle

    # -- the control plane (rank 0) ----------------------------------------------

    def _dumps(self, message: tuple) -> bytes:
        refs: dict[int, Any] = {}
        mesh = self

        class _Pickler(pickle.Pickler):
            def persistent_id(self, obj):
                if obj is mesh:
                    return ("mesh",)
                handle = getattr(obj, "_mesh_handle", None) if not isinstance(obj, type) else None
                if handle is not None and mesh._handles.get(handle) is obj:
                    return ("obj", handle)
                if hasattr(type(obj), "device_table"):  # grammars: sent once, then by reference
                    entry = mesh._refs.get(id(obj))
                    if entry is None:
                        entry = mesh._refs[id(obj)] = (len(mesh._refs), obj)
                        refs[entry[0]] = obj
                    return ("ref", entry[0])
                return None

        body = io.BytesIO()
        _Pickler(body, protocol=pickle.HIGHEST_PROTOCOL).dump(message)
        drops, self._drops[:] = list(self._drops), []
        return pickle.dumps((pickle.dumps(refs, protocol=pickle.HIGHEST_PROTOCOL), body.getvalue(), drops),
                            protocol=pickle.HIGHEST_PROTOCOL)

    def _send(self, message: tuple) -> int:
        _PROCESS.seq += 1
        _put(_PROCESS.store, f"msg/{_PROCESS.seq}", self._dumps(message))
        return _PROCESS.seq

    def _settle(self, seq: int, failed: bool) -> list[Any]:
        """Wait for every worker's outcome of message ``seq``; raise
        ``MeshWorkerError`` when a worker raised and rank 0 did not.
        Returns the workers' values (``run_all``)."""
        store = _PROCESS.store
        keys = [f"out/{seq}/{r}" for r in range(1, self.size)]
        store.wait(keys, timedelta(seconds=self.timeout_s))
        outcomes = [pickle.loads(_take(store, k, delete=True)) for k in keys]
        _take(store, f"msg/{seq}", delete=True)
        errors = [f"rank {r}:\n{text}" for r, (ok, text) in enumerate(outcomes, start=1) if not ok]
        if errors and not failed:
            raise MeshWorkerError("a mesh worker raised:\n" + "\n".join(errors))
        return [value for ok, value in outcomes]

    @contextlib.contextmanager
    def controlled(self, message: tuple) -> Iterator[list]:
        """On rank 0 outside any replayed call: send ``message`` to the
        workers, run the body, then wait for their outcomes (the list it
        yields is filled with their values). Elsewhere it only runs the body."""
        values: list = []
        if not self.is_controller or self._depth:
            yield values
            return
        seq = self._send(message)
        self._depth += 1
        failed = True
        try:
            yield values
            failed = False
        finally:
            self._depth -= 1
            values.extend(self._settle(seq, failed))

    def run_all(self, fn: Callable, *args, **kwargs) -> list[Any]:
        """``fn(*args, **kwargs)`` on every rank (``fn`` a module-level
        function); returns each rank's value in rank order."""
        with self.controlled(("run", fn, args, kwargs)) as values:
            mine = fn(*args, **kwargs)
        return [mine] + values

    def close(self) -> None:
        """Stop the workers (they leave ``serve``), leave the world with them
        (``_leave``), then join the processes this rank started, ending
        those still alive after the timeout. Idempotent; a no-op once the
        world is left (another mesh on it was closed)."""
        global _PROCESS
        if self._closed or self.size == 1 or _PROCESS is None:
            self._closed = True
            return
        if self.rank == 0:
            with self.controlled(("stop",)):
                pass
        self._closed = True
        try:
            _leave(_PROCESS)
        finally:
            deadline = time.monotonic() + self.timeout_s
            for proc in _PROCESS.procs:
                proc.join(timeout=max(0.0, deadline - time.monotonic()))
                if proc.is_alive():
                    proc.terminate()
            _PROCESS = None


# -- differentiable collectives (training) -------------------------------------------


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous(), ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.width = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.axis_index(ctx.axis) * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width), None, None, None


class _PermuteOnAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return mesh.ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return ctx.mesh.ppermute(grad.contiguous(), ctx.axis, inverse), None, None, None


def copy_to_axis(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """Megatron's f: the identity, whose backward all-reduces the gradient
    over ``axis`` (the input of a region whose ranks each use part of ``x``)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """Megatron's g: the all-reduce of ``x`` over ``axis`` (the ranks'
    partial sums), whose backward is the identity."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _ReduceFromAxis.apply(x, mesh, axis)


def gather_from_axis(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in axis order; the
    backward takes this rank's part of the (replicated) gradient."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _GatherFromAxis.apply(x, mesh, axis, dim)


def permute_on_axis(x: torch.Tensor, mesh: Mesh, axis: str, perm: list[tuple[int, int]]) -> torch.Tensor:
    """``Mesh.ppermute``, differentiable: the backward sends the gradient
    back along the inverse permutation (JAX's transpose of ``ppermute``)."""
    return _PermuteOnAxis.apply(x, mesh, axis, perm)


def replicated(method: Callable) -> Callable:
    """Replay a method on every rank: on rank 0 of a mesh outside another
    replayed call, the call (its object by handle, its arguments pickled) is
    sent to the workers before it runs here. ``self.mesh`` is the object's
    mesh, or None."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        mesh = self.mesh
        if mesh is None or not mesh.is_controller:
            return method(self, *args, **kwargs)
        with mesh.controlled(("call", self, method.__name__, args, kwargs)):
            return method(self, *args, **kwargs)

    return wrapper


# -- building a mesh --------------------------------------------------------------


def build_mesh(
    mesh_config: Mapping[str, Any] | None = None,
    devices: list[torch.device | str] | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """A (data, model) mesh over ``devices`` (one ``torch.device`` a rank;
    default: one rank per visible card, or the CPU alone).

    A 1 x 1 mesh makes no process group and no process. Otherwise the
    calling process becomes rank 0 and the other ranks start as processes of
    its own (``[cuda:0] * 2`` names two ranks that share one card, ``[cpu]
    * 4`` four CPU ranks), unless this process is already in a world (a
    torchrun world, or one an earlier ``build_mesh`` started and no
    ``close`` ended): then the mesh spans it, new groups over the same
    ranks, and each rank keeps the device it joined with.
    ``timeout_s`` bounds every collective and every wait for a worker.
    """
    if dist.is_initialized() and _PROCESS is not None:
        data, model = mesh_shape_from_config(mesh_config, _PROCESS.world)
        return _build({DATA_AXIS: data, MODEL_AXIS: model}, None, timeout_s)
    devices = [_normalize(d) for d in (devices if devices is not None else default_devices())]
    data, model = mesh_shape_from_config(mesh_config, len(devices))
    return _build({DATA_AXIS: data, MODEL_AXIS: model}, devices, timeout_s)


def _build_1d(axis: str, n: int, devices, timeout_s: float) -> Mesh:
    """A one-axis mesh of ``n`` ranks: the first ``n`` of ``devices``
    (default: one rank per visible card), or the running world's ranks."""
    if dist.is_initialized() and _PROCESS is not None:
        have = _PROCESS.world
        if have != n:
            raise ValueError(f"need {n} devices, have {have}" if have < n else
                             f"a {axis} mesh spans its world: {n} ranks asked of a world of {have}")
        return _build({axis: n}, None, timeout_s)
    devices = [_normalize(d) for d in (devices if devices is not None else default_devices())]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return _build({axis: n}, devices[:n], timeout_s)


def build_pipe_mesh(n_stages: int, devices: list[torch.device | str] | None = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A 1-D ("pipe",) mesh of ``n_stages`` ranks (JAX's ``build_pipe_mesh``)."""
    return _build_1d(PIPE_AXIS, n_stages, devices, timeout_s)


def build_cp_mesh(n_shards: int, devices: list[torch.device | str] | None = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A 1-D ("cp",) mesh of ``n_shards`` ranks (JAX's ``build_cp_mesh``)."""
    return _build_1d(CP_AXIS, n_shards, devices, timeout_s)


def build_expert_mesh(n_devices: int, devices: list[torch.device | str] | None = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A 1-D ("expert",) mesh of ``n_devices`` ranks (JAX's ``build_expert_mesh``)."""
    return _build_1d(EXPERT_AXIS, n_devices, devices, timeout_s)


def _build(axes: dict[str, int], devices: list[torch.device] | None, timeout_s: float) -> Mesh:
    """The mesh of ``axes`` on the running world (``devices`` None), or on
    a world of ``devices`` started here; a mesh of one rank starts nothing."""
    if devices is None:
        if _PROCESS.rank != 0:
            raise RuntimeError("worker ranks serve rank 0's calls: call serve(), not build_mesh()")
        world = _PROCESS.world
        return _controller_mesh(axes, [_PROCESS.device] * world, _PROCESS.backend, timeout_s)
    if math.prod(axes.values()) == 1:
        return Mesh(axes, devices)
    backend = choose_backend(devices)
    _spawn_world(devices, backend, timeout_s)
    atexit.register(_close_at_exit)
    return _controller_mesh(axes, devices, backend, timeout_s)


def _controller_mesh(axes: dict[str, int], devices, backend: str, timeout_s: float) -> Mesh:
    """Rank 0's mesh. The workers build their side (the same groups, made in
    the same order) from the ``mesh`` message, sent before rank 0 makes its
    groups; each answers with the device it holds."""
    global _CURRENT
    mesh = Mesh(axes, devices, backend, rank=0, timeout_s=timeout_s)
    seq = mesh._send(("mesh", axes, [str(d) for d in devices], backend, timeout_s))
    mesh._make_groups()
    mesh.devices = [devices[0]] + [torch.device(d) for d in mesh._settle(seq, failed=False)]
    _CURRENT = mesh
    shape = " ".join(f"{k}={v}" for k, v in axes.items())
    _log.info(f"event=mesh_built {shape} backend={backend} devices={','.join(str(d) for d in mesh.devices)}")
    return mesh


_CURRENT: Mesh | None = None


def _close_at_exit() -> None:
    """Close the last mesh; in a world that no mesh ever spanned, stop the
    workers all the same."""
    if _CURRENT is not None and not _CURRENT._closed:
        _CURRENT.close()
    elif _PROCESS is not None and _PROCESS.rank == 0:
        mesh = Mesh({DATA_AXIS: _PROCESS.world}, [_PROCESS.device] * _PROCESS.world, _PROCESS.backend,
                    timeout_s=_PROCESS.timeout_s)
        mesh.close()


def serve() -> None:
    """The worker loop of a rank other than 0: replay rank 0's messages
    until it stops the mesh. Each message's outcome (its value, or the
    traceback of what it raised) goes back through the store."""
    proc = _PROCESS
    if proc is None or proc.rank == 0:
        raise RuntimeError("serve() runs on a worker rank of an initialized world")
    store = proc.store
    mesh: Mesh | None = None
    refs: dict[int, Any] = {}
    seq = 0
    while True:
        seq += 1
        key = f"msg/{seq}"
        while not store.check([key]):  # idle: no collective, so no timeout
            time.sleep(0.002)
        raw_refs, body, drops = pickle.loads(_take(store, key))
        if mesh is not None and drops:
            for handle in drops:
                mesh._objects.pop(handle, None)
            gc.collect()  # an engine's modules hold cycles: free its device memory now
        ok, value = True, None
        try:
            refs.update(pickle.loads(raw_refs))
            message = _Unpickler(io.BytesIO(body), mesh, refs).load()
            op = message[0]
            if op == "stop":
                _put(store, f"out/{seq}/{proc.rank}", pickle.dumps((True, None)))
                break
            if op == "mesh":
                _, axes, devices, backend, timeout_s = message
                if mesh is not None:  # a new mesh on this world: the old one's objects go
                    mesh._objects.clear()
                    gc.collect()
                mine = [torch.device(d) for d in devices]
                mine[proc.rank] = proc.device
                mesh = Mesh(axes, mine, backend, rank=proc.rank, timeout_s=timeout_s)
                mesh._make_groups()
                value = str(proc.device)
            elif op == "new":
                _, cls, args, kwargs = message
                cls(*args, **kwargs)  # the object registers itself with the mesh
            elif op == "run":
                _, fn, args, kwargs = message
                value = fn(*args, **kwargs)
            elif op == "call":
                _, target, name, args, kwargs = message
                getattr(target, name)(*args, **kwargs)
            else:
                raise ValueError(f"unknown mesh message {op!r}")
        except Exception:
            ok, value = False, traceback.format_exc()
            _log.warning(f"event=mesh_worker_raised rank={proc.rank} seq={seq}\n{value}")
        _put(store, f"out/{seq}/{proc.rank}", pickle.dumps((ok, value), protocol=pickle.HIGHEST_PROTOCOL))
        # Hold nothing of this message while the next one's drops are freed.
        message = value = target = args = kwargs = fn = cls = None
    if mesh is not None:
        mesh._objects.clear()
        mesh._closed = True
    _leave(proc)


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, mesh: Mesh | None, refs: dict[int, Any]):
        super().__init__(file)
        self.mesh, self.refs = mesh, refs

    def persistent_load(self, pid):
        kind = pid[0]
        if kind == "mesh":
            return self.mesh
        if kind == "obj":
            return self.mesh._objects[pid[1]]
        return self.refs[pid[1]]
