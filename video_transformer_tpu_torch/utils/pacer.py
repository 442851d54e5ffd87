"""Call pacing and retry for the inference queue (and optional cloud seams).

This package's own copy of the JAX package's ``utils/pacer.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

Local inference on the card needs no rate limiting, so the default min-interval is 0
— the pacer then only provides retry-with-backoff around transient failures
(a rate-limited shared device). When a deployment routes calls through
a shared cloud fallback, the same machinery provides the reference's
behavior: thread-safe min-interval pacing, rate-limit-only retries with
server-suggested delays, exponential backoff with jitter, and a bounded
total wait (reference src/utils/gemini_throttle.py). Unlike the JAX
package's copy, an error from torch or naming CUDA is never taken for a
rate limit: it raises through ``call_with_retry`` at once.
"""

from __future__ import annotations

import logging
import random
import re
import threading
import time
from typing import Any, Callable

__all__ = ["InferencePacer", "RateLimitError"]


class RateLimitError(RuntimeError):
    """A retryable rate-limit signal (HTTP 429 analog)."""

    def __init__(self, message: str, retry_after: float | None = None):
        super().__init__(message)
        self.retry_after = retry_after


_RETRY_DELAY_RE = re.compile(
    r"(?:retryDelay|retry-after|retry_after)[\"':\s]*([0-9.]+)", re.IGNORECASE
)


def _is_device_error(exc: Exception) -> bool:
    """An error raised by torch (its module) or naming CUDA."""
    module = type(exc).__module__ or ""
    return module.split(".")[0] == "torch" or "CUDA" in str(exc)


class InferencePacer:
    """Thread-safe min-interval pacing + bounded retry."""

    def __init__(
        self,
        min_interval: float = 0.0,
        files_op_interval: float = 0.0,
        max_retries: int = 10,
        max_total_wait: float = 600.0,
        logger: logging.Logger | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.min_interval = float(min_interval)
        self.files_op_interval = float(files_op_interval)
        self.max_retries = int(max_retries)
        self.max_total_wait = float(max_total_wait)
        self.logger = logger or logging.getLogger("video_transformer")
        self._sleep = sleep
        self._clock = clock
        self._lock = threading.Lock()
        self._last_call = 0.0

    # -- pacing ---------------------------------------------------------------

    def _wait(self, interval: float) -> None:
        if interval <= 0:
            return
        with self._lock:
            now = self._clock()
            gap = self._last_call + interval - now
            if gap > 0:
                self._sleep(gap)
            self._last_call = self._clock()

    def wait_before_call(self) -> None:
        self._wait(self.min_interval)

    def wait_for_files_op(self) -> None:
        self._wait(self.files_op_interval)

    # -- retry ----------------------------------------------------------------

    @staticmethod
    def is_rate_limit_error(exc: Exception) -> bool:
        """A rate-limit signal, by type or by its message. A device error
        is never one, whatever its message holds: a CUDA out-of-memory
        message can name "429.00 MiB", and a CUDA fault is sticky, so a
        retry would only wait before raising it again."""
        if isinstance(exc, RateLimitError):
            return True
        if _is_device_error(exc):
            return False
        message = str(exc)
        return "429" in message or "RESOURCE_EXHAUSTED" in message

    @staticmethod
    def extract_retry_delay(exc: Exception) -> float | None:
        if isinstance(exc, RateLimitError) and exc.retry_after is not None:
            return exc.retry_after
        match = _RETRY_DELAY_RE.search(str(exc))
        if match:
            try:
                return float(match.group(1))
            except ValueError:
                return None
        return None

    def call_with_retry(
        self,
        fn: Callable[..., Any],
        *args: Any,
        on_retry_callback: Callable[[int, Exception], None] | None = None,
        log_context: dict[str, Any] | None = None,
        **kwargs: Any,
    ) -> Any:
        """Run fn with pacing; retry only rate-limit errors, others raise.

        Wait schedule: server-suggested delay when present, else 30 * 2^n
        with ±10% jitter, bounded by max_total_wait cumulative.
        """
        total_wait = 0.0
        context = " ".join(f"{k}={v}" for k, v in (log_context or {}).items())
        for attempt in range(self.max_retries + 1):
            self.wait_before_call()
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not self.is_rate_limit_error(exc) or attempt >= self.max_retries:
                    raise
                if on_retry_callback is not None:
                    on_retry_callback(attempt + 1, exc)
                delay = self.extract_retry_delay(exc)
                if delay is None:
                    delay = 30.0 * (2**attempt)
                delay *= random.uniform(0.9, 1.1)
                if total_wait + delay > self.max_total_wait:
                    self.logger.error(
                        f"event=retry_budget_exhausted waited={total_wait:.0f}s {context}"
                    )
                    raise
                self.logger.warning(
                    f"event=rate_limited attempt={attempt + 1} wait={delay:.1f}s "
                    f"{context}"
                )
                self._sleep(delay)
                total_wait += delay
        raise RuntimeError("unreachable")
