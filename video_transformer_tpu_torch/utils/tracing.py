"""Tracing and profiling: structured span events and torch.profiler traces.

This package's own copy of the JAX package's ``utils/tracing.py``, with the
same span schema:

- ``span(name)``: context manager timing a phase, logging
  ``event=span name=<x> elapsed_ms=<t>`` at debug level on the
  ``video_transformer`` logger and accumulating per-name totals. The span
  is a ``torch.profiler.record_function`` range, so ``device_trace``'s
  timeline names it; with ``nvtx=True`` (the engine passes it when its
  device is CUDA) it is also an NVTX range.
- ``Tracer.summary()``: per-span aggregates for reports.
- ``device_trace(dir)``: ``torch.profiler`` around a block (host activity,
  and CUDA activity where CUDA is present: a warm-up step, then a padded
  recording window), exported as a Chrome trace into ``dir``.

A span measures host time. The engine's spans close after the host has
read the work's results back from the device, so they cover that work.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Iterator

import torch

__all__ = ["Tracer", "tracer", "span", "device_trace"]


class Tracer:
    """Thread-safe span accumulator."""

    def __init__(self, logger: logging.Logger | None = None):
        self.logger = logger or logging.getLogger("video_transformer")
        self._lock = threading.Lock()
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, nvtx: bool = False, **fields: Any) -> Iterator[None]:
        """Time the block as ``name``; ``fields`` join the log line. With
        ``nvtx`` the block is also an NVTX range (CUDA callers only)."""
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        start = time.perf_counter()
        try:
            with torch.profiler.record_function(name):  # names the span in device_trace's timeline
                yield
        finally:
            elapsed = time.perf_counter() - start
            if nvtx:
                torch.cuda.nvtx.range_pop()
            with self._lock:
                self._totals[name] += elapsed
                self._counts[name] += 1
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            self.logger.debug(
                f"event=span name={name} elapsed_ms={elapsed * 1000:.1f}"
                + (f" {extra}" if extra else "")
            )

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": round(self._totals[name], 4),
                    "count": self._counts[name],
                    "mean_ms": round(self._totals[name] / self._counts[name] * 1000, 2),
                }
                for name in self._totals
            }

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


#: Process-global tracer used by the engine's entry points.
tracer = Tracer()


def span(name: str, **fields: Any):
    """Shorthand for the global tracer's span."""
    return tracer.span(name, **fields)


# Two defences of ``device_trace``'s records, each measured on an H100 with
# the other taken out (``chip_smoke.py``'s ``tracing`` line, and
# ``tools/trace_window_probe.py``). The profiler keeps only the device
# records whose timestamps fall inside its recording window.
# - Late in a long process, CUPTI stamps the first kernel records after it
#   starts collecting far outside any window, in every other session; so a
#   warm-up step of ``WARMUP_LAUNCHES`` small kernels, whose records are
#   discarded, runs before the window opens.
# - CUPTI places kernels up to milliseconds before their launches on the
#   host's clock; so ``WINDOW_PAD_S`` passes inside the window on either side
#   of the block.
WARMUP_LAUNCHES = 256
WINDOW_PAD_S = 0.02


@contextlib.contextmanager
def device_trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile a block with ``torch.profiler`` and export a Chrome trace
    (``trace.json``) into ``log_dir``; yields the profiler. Where CUDA is
    present the session first runs a warm-up step of ``WARMUP_LAUNCHES``
    small kernels, and the device is idle and ``WINDOW_PAD_S`` has passed on
    either side of the block inside the recording window."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        if cuda:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                x += 1
            torch.cuda.synchronize()
        prof.step()
        if cuda:
            time.sleep(WINDOW_PAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
    prof.export_chrome_trace(str(out / "trace.json"))
