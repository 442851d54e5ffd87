"""Which collectives the gloo backend takes on CUDA tensors, two ranks on one card.

    python tools/gloo_cuda_probe.py

Starts a second process, joins it over a TCP store on a port the OS picks,
and tries all_reduce (sum and max, f32 and bf16), broadcast, all_gather
(f32, bf16 and int64, the values checked) and point-to-point exchange
(``isend``/``irecv`` both ways at once, the values checked) on ``cuda:0``
tensors in both ranks. The exchange runs last, in a world of two fresh
processes of its own, since a backend that cannot read device memory may
abort the process: its outcome is then the processes' exit codes. Prints
one JSON line: each collective's outcome ("ok", or the error's first
line), the ms of an f32 all_reduce at 1 MiB, 25 MiB (one tensor-parallel
activation of base, [2, 3072, 1024]) and 256 MiB (a gradient bucket) and
of an f32 all_gather at 25 MiB, and the card's name. ``parallel/mesh.py``
serves on what this finds: all_reduce and all_gather, and ``ppermute``
as an all_gather (on an H100, gloo aborts an isend of a CUDA tensor:
``writev ... Bad address``).
"""

from __future__ import annotations

import json
import multiprocessing
import socket
import time
from datetime import timedelta

import torch
import torch.distributed as dist

SIZES_MIB = (1, 25, 256)


def _gather_check(rank: int, dev: torch.device, dtype: torch.dtype) -> None:
    parts = [torch.empty(4, device=dev, dtype=dtype) for _ in range(2)]
    dist.all_gather(parts, torch.full((4,), rank + 1, device=dev, dtype=dtype))
    if [int(p[0]) for p in parts] != [1, 2]:
        raise ValueError(f"gathered {[p.tolist() for p in parts]}")


def _exchange(rank: int, send: torch.Tensor, recv: torch.Tensor) -> None:
    """Both ranks send and receive at once (a two-rank ring's ppermute)."""
    ops = [dist.isend(send, 1 - rank), dist.irecv(recv, 1 - rank)]
    for op in ops:
        op.wait()


def _exchange_check(rank: int, dev: torch.device) -> None:
    recv = torch.zeros(4, device=dev)
    _exchange(rank, torch.full((4,), float(rank + 1), device=dev), recv)
    torch.cuda.synchronize()
    if recv.tolist() != [float(2 - rank)] * 4:
        raise ValueError(f"received {recv.tolist()}")


def _ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / reps


def _trials(rank: int) -> dict:
    dev = torch.device("cuda", 0)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:  # the probe records what a backend refuses
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"

    x = torch.full((4,), float(rank + 1), device=dev)
    attempt("all_reduce_sum_f32", lambda: dist.all_reduce(x))
    attempt("all_reduce_max_f32", lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX))
    attempt("all_reduce_sum_bf16", lambda: dist.all_reduce(torch.ones(4, device=dev, dtype=torch.bfloat16)))
    attempt("broadcast_f32", lambda: dist.broadcast(x, src=0))
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16), ("i64", torch.int64)):
        attempt(f"all_gather_{name}", lambda dtype=dtype: _gather_check(rank, dev, dtype))
    for mib in SIZES_MIB:
        big = torch.ones(mib << 18, device=dev)
        out[f"all_reduce_{mib}mib_f32_ms"] = _ms(lambda: dist.all_reduce(big), 20 if mib < 100 else 5)
        del big
    act = torch.ones(25 << 18, device=dev)
    parts = [torch.empty_like(act) for _ in range(2)]
    out["all_gather_25mib_f32_ms"] = _ms(lambda: dist.all_gather(parts, act), 20)
    return out


def _exchange_rank(rank: int, port: int, queue) -> None:
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0, timeout=timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2, timeout=timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    _exchange_check(rank, dev)
    act = torch.ones(25 << 18, device=dev)
    recv = torch.empty_like(act)
    queue.put((rank, _ms(lambda: _exchange(rank, act, recv), 20)))
    dist.destroy_process_group()


def _exchange_world() -> dict:
    """isend/irecv in a world of two fresh processes: "ok" and the ms of a
    25 MiB exchange, or each process's exit code."""
    with socket.socket() as sock:  # a port the OS picks, for rank 0 of the exchange's world
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_exchange_rank, args=(r, port, queue), daemon=True) for r in range(2)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(timeout=120)
        if proc.is_alive():
            proc.kill()
    codes = [proc.exitcode for proc in procs]
    if codes != [0, 0]:
        return {"isend_irecv_f32": f"the ranks ended with exit codes {codes}"}
    times = dict(queue.get(timeout=10) for _ in range(2))
    return {"isend_irecv_f32": "ok", "isend_irecv_25mib_f32_ms": times[0]}


def _rank(rank: int, port: int, queue) -> None:
    store = dist.TCPStore("127.0.0.1", port, 2, False, timeout=timedelta(seconds=120))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2, timeout=timedelta(seconds=120))
    queue.put(_trials(rank))
    dist.destroy_process_group()


def main() -> None:
    store = dist.TCPStore("127.0.0.1", 0, 2, True, timeout=timedelta(seconds=120), wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    worker = ctx.Process(target=_rank, args=(1, store.port, queue), daemon=True)
    worker.start()
    dist.init_process_group("gloo", store=store, rank=0, world_size=2, timeout=timedelta(seconds=120))
    mine = _trials(0)
    theirs = queue.get(timeout=120)
    worker.join(timeout=60)
    dist.destroy_process_group()
    print(json.dumps({"probe": "gloo_cuda", "card": torch.cuda.get_device_name(0), "rank0": mine, "rank1": theirs,
                      "exchange": _exchange_world()}))


if __name__ == "__main__":
    main()
