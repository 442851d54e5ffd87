"""Command-line interface.

Same surface as the reference (main.py:257-344):

  python -m video_transformer_tpu_torch --url URL | --batch FILE [--sharded]
      [--config PATH] [--output-dir PATH] [--max-api-calls N]
      [--no-checkpoint] [--verbose] [--device {cuda,cpu}]

URLs may also be local video paths (.npzv/.y4m/.mp4), which skip the
downloader — the normal mode on a GPU host where videos are staged on disk.

This package's own copy of the JAX package's ``cli.py``. ``--config`` takes
the port's JSON config (``utils/config.json`` by default; a YAML path is
refused with the JSON file's name: the card machine has no ``yaml``).
``--device`` (default ``cuda``) places the engine; ``cpu`` runs the
kernels' plain versions. There is one device, so no distributed start-up.
An error from torch or naming CUDA propagates out of ``main`` (exit code 1
and its traceback under ``python -m``); the exit codes are otherwise the
JAX CLI's (``tests/test_torch_cli.py``).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from .contracts import BatchResult, ProcessResult
from .pipeline.pipeline import VideoPipeline
from .utils.config import DEFAULT_CONFIG_PATH, load_config
from .utils.counter import APICounter
from .utils.logger import setup_logging
from .utils.progress import ProgressTracker
from .utils.proxy import verify_proxy_connection

__all__ = ["VideoTransformerCLI", "main"]


class VideoTransformerCLI:
    def __init__(self, args: argparse.Namespace):
        self.args = args

    def run(self) -> int:
        config_path = Path(self.args.config or DEFAULT_CONFIG_PATH)
        if config_path.suffix.lower() in (".yaml", ".yml"):
            raise SystemExit(
                f"--config takes the JSON config (e.g. {DEFAULT_CONFIG_PATH}), "
                f"not YAML: {config_path}"
            )
        config = load_config(config_path)

        if self.args.output_dir:
            config["system"]["output_dir"] = self.args.output_dir
        if self.args.max_api_calls is not None:
            config["system"]["max_api_calls"] = self.args.max_api_calls

        level = logging.DEBUG if self.args.verbose else logging.INFO
        logger = setup_logging(config["system"].get("log_dir", "./data/output/logs"),
                               level=level)

        self._health_check(config, logger)

        api_counter = APICounter(
            max_calls=int(config["system"].get("max_api_calls", 20))
        )

        progress_tracker = None
        if not self.args.no_checkpoint:
            temp_dir = Path(config["system"].get("temp_dir", "./data/temp"))
            progress_tracker = ProgressTracker(temp_dir / "progress.json", logger)

        pipeline = VideoPipeline(
            config=config,
            logger=logger,
            api_counter=api_counter,
            progress_tracker=progress_tracker,
            device=self.args.device,
        )

        if self.args.url:
            result = pipeline.process_single_video(self.args.url)
            self._print_single_result(result)
            return 0 if result.success else 1

        urls = self._load_url_list(self.args.batch)
        if progress_tracker is not None:
            urls = [
                url
                for url in urls
                if not progress_tracker.is_processed(
                    pipeline._extract_video_id(url)
                )
            ]
        if not urls:
            logger.info("所有视频均已处理")
            return 0
        if self.args.sharded:
            batch_result = pipeline.process_batch_sharded(urls)
        else:
            batch_result = pipeline.process_batch(urls)
        self._print_batch_result(batch_result)
        return 0 if batch_result.failed == 0 else 1

    @staticmethod
    def _health_check(config: dict, logger: logging.Logger) -> None:
        """Local engine needs no services; the optional key-pool is probed
        only when configured, and its absence degrades gracefully
        (reference main.py:151-176)."""
        proxy = config.get("proxy", {}) or {}
        base_url = proxy.get("base_url")
        if not base_url:
            return
        if verify_proxy_connection(base_url, timeout=int(proxy.get("timeout", 5))):
            logger.info(f"代理号池健康检查通过: {base_url}")
        else:
            logger.info("代理号池不可用，使用本地推理引擎 (无外部 API)")

    @staticmethod
    def _load_url_list(path: str) -> list[str]:
        lines = Path(path).read_text(encoding="utf-8").splitlines()
        return [
            line.strip()
            for line in lines
            if line.strip() and not line.strip().startswith("#")
        ]

    @staticmethod
    def _print_single_result(result: ProcessResult) -> None:
        print("=" * 62)
        print(str(result))
        if result.document_path:
            print(f"  文档: {result.document_path}")
        if result.blueprint_path:
            print(f"  蓝图: {result.blueprint_path}")
        if result.error_message and not result.success:
            print(f"  错误: {result.error_message}")
        print("=" * 62)

    @staticmethod
    def _print_batch_result(batch: BatchResult) -> None:
        print("=" * 62)
        print(str(batch))
        for item in batch.results:
            print(f"  {item}")
        print("=" * 62)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="video_transformer_tpu_torch",
        description="video knowledge-note pipeline on one CUDA card",
    )
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--url", help="single video URL or local path")
    source.add_argument("--batch", help="file with one URL/path per line")
    parser.add_argument("--config", help="config JSON path")
    parser.add_argument("--output-dir", help="override system.output_dir")
    parser.add_argument(
        "--max-api-calls", type=int, default=None, help="model-call budget"
    )
    parser.add_argument(
        "--no-checkpoint", action="store_true", help="disable batch resume"
    )
    parser.add_argument(
        "--sharded",
        action="store_true",
        help="batch mode: shard analysis of all videos across devices",
    )
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the engine runs (cpu: the kernels' plain versions)",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return VideoTransformerCLI(args).run()
    except KeyboardInterrupt:
        print("\n中断退出")
        return 130


if __name__ == "__main__":
    sys.exit(main())
