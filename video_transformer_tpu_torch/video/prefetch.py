"""Host-side prefetching: overlap frame decode with device compute.

This package's own copy of the JAX package's ``video/prefetch.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

The segmented analysis loop alternates host decode (CPU/IO-bound) with
device generation (device-bound). ``prefetch_map`` runs the producer one step
ahead on a worker thread so decode of chunk i+1 overlaps generation of
chunk i — the standard input-pipeline overlap, kept deliberately simple
(lookahead 1, one worker) because host decode must never starve the host of
RAM for staged frames.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

__all__ = ["prefetch_map"]

T = TypeVar("T")
R = TypeVar("R")


def prefetch_map(
    fn: Callable[[T], R], items: Iterable[T], lookahead: int = 1
) -> Iterator[R]:
    """Yield fn(item) for each item, computing up to ``lookahead`` ahead.

    Exceptions raised by fn surface at the corresponding yield point, in
    order — identical semantics to ``map`` with overlap.
    """
    items = iter(items)
    if lookahead <= 0:
        yield from map(fn, items)
        return

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = []
        try:
            for _ in range(lookahead + 1):
                pending.append(pool.submit(fn, next(items)))
        except StopIteration:
            pass
        while pending:
            result = pending.pop(0)
            try:
                pending.append(pool.submit(fn, next(items)))
            except StopIteration:
                pass
            yield result.result()
