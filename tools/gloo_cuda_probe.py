"""Which collectives the gloo backend takes on CUDA tensors, two ranks on one card.

    python tools/gloo_cuda_probe.py

Starts a second process, joins it over a TCP store on a port the OS picks,
and tries all_reduce (sum and max, f32 and bf16), broadcast and all_gather
(f32, bf16 and int64, the values checked) on ``cuda:0`` tensors in both
ranks. Prints one JSON line: each collective's outcome ("ok", or the
error's first line), the ms of a 1 MiB f32 all_reduce, and the card's name.
``parallel/mesh.py`` serves on the two collectives this finds: all_reduce
and all_gather.
"""

from __future__ import annotations

import json
import multiprocessing
import time
from datetime import timedelta

import torch
import torch.distributed as dist


def _gather_check(rank: int, dev: torch.device, dtype: torch.dtype) -> None:
    parts = [torch.empty(4, device=dev, dtype=dtype) for _ in range(2)]
    dist.all_gather(parts, torch.full((4,), rank + 1, device=dev, dtype=dtype))
    if [int(p[0]) for p in parts] != [1, 2]:
        raise ValueError(f"gathered {[p.tolist() for p in parts]}")


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
    big = torch.ones(1 << 18, device=dev)
    for _ in range(3):
        dist.all_reduce(big)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(big)
    torch.cuda.synchronize()
    out["all_reduce_1mib_f32_ms"] = (time.perf_counter() - start) * 1e3 / 20
    return out


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
    print(json.dumps({"probe": "gloo_cuda", "card": torch.cuda.get_device_name(0), "rank0": mine, "rank1": theirs}))


if __name__ == "__main__":
    main()
