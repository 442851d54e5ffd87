"""Logging setup: one named logger with file + stream handlers.

This package's own copy of the JAX package's ``utils/logger.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

Structured ``event=`` log lines (video_start / video_complete /
video_failed, pacer retry fields, engine events) form a tested
observability contract (tests/test_observability.py; the reference pins
the same event schema from src/pipeline.py:128,316,331). The logger name
and line format are part of that contract.
"""

from __future__ import annotations

import logging
from pathlib import Path

__all__ = ["setup_logging", "LOGGER_NAME"]

LOGGER_NAME = "video_transformer"
_LINE_FORMAT = "%(asctime)s [%(levelname)s] %(message)s"


def _handlers(log_file: Path) -> list[logging.Handler]:
    formatter = logging.Formatter(_LINE_FORMAT)
    built: list[logging.Handler] = [
        logging.FileHandler(log_file, encoding="utf-8"),
        logging.StreamHandler(),
    ]
    for handler in built:
        handler.setFormatter(formatter)
    return built


def setup_logging(
    log_dir: str | Path, log_name: str = "run.log", level: int = logging.INFO
) -> logging.Logger:
    """Create (idempotently) the framework logger writing to log_dir/log_name.

    Re-invocations return the already-configured logger — components call
    this freely without duplicating handlers.
    """
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    if logger.handlers:
        return logger

    log_path = Path(log_dir)
    log_path.mkdir(parents=True, exist_ok=True)
    for handler in _handlers(log_path / log_name):
        logger.addHandler(handler)
    logger.propagate = False
    return logger
