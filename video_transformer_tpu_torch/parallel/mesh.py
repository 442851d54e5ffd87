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
import logging
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
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshWorkerError",
    "build_mesh",
    "choose_backend",
    "default_devices",
    "distributed_init_kwargs",
    "maybe_initialize_distributed",
    "mesh_devices",
    "mesh_shape_from_config",
    "replicated",
    "serve",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
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
    """This rank's view of a (data, model) mesh: its device, its data and
    model groups, the collectives the model needs, and (on rank 0 of a world
    it controls) the channel to the worker ranks."""

    def __init__(self, data: int, model: int, devices: list[torch.device], backend: str | None = None,
                 rank: int = 0, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.data, self.model = int(data), int(model)
        self.devices = list(devices)
        self.backend = backend
        self.rank = int(rank)
        self.timeout_s = float(timeout_s)
        self.data_group = self.model_group = None
        self._depth = 0
        self._next_handle = 0
        self._objects: dict[int, Any] = {}  # workers: the replayed objects
        self._handles: weakref.WeakValueDictionary = weakref.WeakValueDictionary()  # rank 0: handle -> object
        self._refs: dict[int, tuple[int, Any]] = {}  # rank 0: id(obj) -> (ref id, obj) sent by reference
        self._drops: list[int] = []
        self._closed = False
        self.collectives = 0
        """Collectives this rank has issued on the data and model groups."""

    def _make_groups(self) -> None:
        """The data and model groups. Every rank of the world creates every
        group, in one order (a ``new_group`` rule)."""
        timeout = timedelta(seconds=self.timeout_s)
        if self.size > 1:
            for m in range(self.model):
                group = dist.new_group([d * self.model + m for d in range(self.data)], timeout=timeout)
                if m == self.model_index:
                    self.data_group = group
            for d in range(self.data):
                group = dist.new_group([d * self.model + m for m in range(self.model)], timeout=timeout)
                if d == self.data_index:
                    self.model_group = group

    # -- shape -------------------------------------------------------------

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def is_controller(self) -> bool:
        """Rank 0 of a mesh of more than one rank: it sends the calls."""
        return self.rank == 0 and self.size > 1 and not self._closed

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, backend={self.backend}, "
                f"devices={[str(d) for d in self.devices]})")

    # -- collectives (the data plane) ------------------------------------------------

    def _group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group

    def axis_size(self, axis: str) -> int:
        return self.data if axis == DATA_AXIS else self.model

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def all_reduce(self, tensor: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """The reduction of ``tensor`` over ``axis`` (a new tensor of its
        dtype; the input when the axis has one rank). Half-precision floats
        are reduced in float32 and rounded once (a max is exact)."""
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
        rank order (the input when the axis has one rank)."""
        n = self.axis_size(axis)
        if n == 1:
            return tensor
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor, group=self._group(axis))
        self.collectives += 1
        return torch.cat(parts, dim=dim)

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
        """Stop the workers (they leave ``serve``), join the processes this
        rank started and leave the world. Idempotent."""
        global _PROCESS
        if self._closed or self.size == 1:
            self._closed = True
            return
        if self.rank == 0:
            with self.controlled(("stop",)):
                pass
            procs = _PROCESS.procs
            for proc in procs:
                proc.join(timeout=self.timeout_s)
                if proc.is_alive():
                    proc.terminate()
        self._closed = True
        if dist.is_initialized():
            dist.destroy_process_group()
        _PROCESS = None


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
        world = _PROCESS.world
        data, model = mesh_shape_from_config(mesh_config, world)
        if _PROCESS.rank != 0:
            raise RuntimeError("worker ranks serve rank 0's calls: call serve(), not build_mesh()")
        return _controller_mesh(data, model, [_PROCESS.device] * world, _PROCESS.backend, timeout_s)
    devices = [_normalize(d) for d in (devices if devices is not None else default_devices())]
    data, model = mesh_shape_from_config(mesh_config, len(devices))
    if data * model == 1:
        return Mesh(1, 1, devices)
    backend = choose_backend(devices)
    _spawn_world(devices, backend, timeout_s)
    atexit.register(_close_at_exit)
    return _controller_mesh(data, model, devices, backend, timeout_s)


def _controller_mesh(data: int, model: int, devices, backend: str, timeout_s: float) -> Mesh:
    """Rank 0's mesh. The workers build their side (the same groups, made in
    the same order) from the ``mesh`` message, sent before rank 0 makes its
    groups; each answers with the device it holds."""
    global _CURRENT
    mesh = Mesh(data, model, devices, backend, rank=0, timeout_s=timeout_s)
    seq = mesh._send(("mesh", data, model, [str(d) for d in devices], backend, timeout_s))
    mesh._make_groups()
    mesh.devices = [devices[0]] + [torch.device(d) for d in mesh._settle(seq, failed=False)]
    _CURRENT = mesh
    _log.info(
        f"event=mesh_built data={data} model={model} backend={backend} "
        f"devices={','.join(str(d) for d in mesh.devices)}"
    )
    return mesh


_CURRENT: Mesh | None = None


def _close_at_exit() -> None:
    """Close the last mesh; in a world that no mesh ever spanned, stop the
    workers all the same."""
    if _CURRENT is not None and not _CURRENT._closed:
        _CURRENT.close()
    elif _PROCESS is not None and _PROCESS.rank == 0:
        mesh = Mesh(_PROCESS.world, 1, [_PROCESS.device] * _PROCESS.world, _PROCESS.backend,
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
                _, data, model, devices, backend, timeout_s = message
                if mesh is not None:  # a new mesh on this world: the old one's objects go
                    mesh._objects.clear()
                    gc.collect()
                mine = [torch.device(d) for d in devices]
                mine[proc.rank] = proc.device
                mesh = Mesh(data, model, mine, backend, rank=proc.rank, timeout_s=timeout_s)
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
    if mesh is not None:
        mesh._objects.clear()
        mesh._closed = True
    if dist.is_initialized():
        dist.destroy_process_group()


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
