"""Watch-folder serving runtime.

Production deployments stage videos on shared storage; this service watches
an input directory, processes new arrivals through the full pipeline, and
writes notes/blueprints to the output layout — the long-running counterpart
to the one-shot CLI (the reference ships only one-shot batch mode,
main.py:257-344). Progress tracking makes the service crash-safe: restarts
resume where they left off.

CLI: python -m video_transformer_tpu_torch.pipeline.service --input data/input \\
        [--config CONFIG.json] [--poll 10] [--once] [--device cuda|cpu]

This package's own copy of the JAX package's ``pipeline/service.py``, on
the port's ``VideoPipeline`` (``device`` "cuda" by default).
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
from pathlib import Path

from ..contracts import ProcessResult
from ..utils.config import DEFAULT_CONFIG_PATH, load_config
from ..utils.counter import APICounter
from ..utils.logger import setup_logging
from ..utils.progress import ProgressTracker
from .pipeline import VideoPipeline

__all__ = ["WatchService", "main"]

VIDEO_SUFFIXES = {".npzv", ".npz", ".y4m", ".mp4", ".mkv", ".webm", ".mov"}


class WatchService:
    """Polls an input directory and pipes new videos through the pipeline."""

    def __init__(
        self,
        config: dict,
        logger: logging.Logger,
        input_dir: str | Path,
        poll_interval: float = 10.0,
        pipeline: VideoPipeline | None = None,
        device: str = "cuda",
    ):
        self.logger = logger
        self.input_dir = Path(input_dir)
        self.poll_interval = float(poll_interval)
        temp_dir = Path(config["system"].get("temp_dir", "./data/temp"))
        self.tracker = ProgressTracker(temp_dir / "service_progress.json", logger)
        self.pipeline = pipeline or VideoPipeline(
            config=config,
            logger=logger,
            api_counter=APICounter(
                max_calls=int(config["system"].get("max_api_calls", 20))
            ),
            progress_tracker=self.tracker,
            device=device,
        )
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def scan(self) -> list[Path]:
        """Unprocessed video files, oldest first (stable processing order).

        Failed videos are skipped too — a crashing input must not be retried
        every poll (it would drain the shared call budget); the operator
        clears it via ProgressTracker.reset() or by removing the file.
        """
        if not self.input_dir.exists():
            return []
        candidates = [
            p
            for p in self.input_dir.iterdir()
            if p.is_file() and p.suffix.lower() in VIDEO_SUFFIXES
        ]
        candidates.sort(key=lambda p: (p.stat().st_mtime, p.name))
        return [
            p
            for p in candidates
            if not self.tracker.is_processed(p.stem)
            and not self.tracker.is_failed(p.stem)
        ]

    def process_pending(self) -> list[ProcessResult]:
        results: list[ProcessResult] = []
        for path in self.scan():
            if self._stop.is_set():
                break
            self.logger.info(f"event=service_pickup video={path.name}")
            result = self.pipeline.process_single_video(str(path))
            results.append(result)
            if not result.success:
                # Record the failure so later scans skip this file (see
                # scan()); the pipeline's own tracker.mark_failed only runs
                # for some failure classes, so mark here unconditionally.
                self.tracker.mark_failed(result.video_id, result.error_message or "")
                self.logger.warning(
                    f"event=service_video_failed video={path.name} "
                    f"error={result.error_message}"
                )
        return results

    def run(self, once: bool = False) -> int:
        """Serve until stopped; returns the number of videos processed."""
        processed = 0
        self.logger.info(
            f"event=service_start input={self.input_dir} poll={self.poll_interval}s"
        )
        while not self._stop.is_set():
            results = self.process_pending()
            processed += sum(1 for r in results if r.success)
            if once:
                break
            self._stop.wait(self.poll_interval)
        self.logger.info(f"event=service_stop processed={processed}")
        return processed


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="watch-folder analysis service")
    parser.add_argument("--input", required=True, help="directory to watch")
    parser.add_argument("--config", default=str(DEFAULT_CONFIG_PATH))
    parser.add_argument("--poll", type=float, default=10.0)
    parser.add_argument("--once", action="store_true", help="single scan then exit")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    logger = setup_logging(
        config["system"].get("log_dir", "./data/output/logs"),
        log_name="service.log",
    )
    service = WatchService(config, logger, args.input, poll_interval=args.poll, device=args.device)
    try:
        service.run(once=args.once)
    except KeyboardInterrupt:
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
