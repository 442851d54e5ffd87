"""Batch-level checkpoint/resume: the progress file.

This package's own copy of the JAX package's ``utils/progress.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

The on-disk JSON — {processed: [...], failed: {id: {error, timestamp}},
last_updated} — is byte-compatible with the reference's resume checkpoint
(src/utils/progress_tracker.py), so progress files written by either
implementation resume under the other. Log strings are part of the
observability contract (tests/test_observability.py).
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path
from typing import Any

__all__ = ["ProgressTracker"]

def _empty_progress() -> dict[str, Any]:
    return {"processed": [], "failed": {}, "last_updated": None}


class ProgressTracker:
    """Tracks processed/failed video IDs across pipeline runs."""

    def __init__(self, progress_file: str | Path, logger: logging.Logger):
        self.progress_file = Path(progress_file)
        self.logger = logger
        self.progress_file.parent.mkdir(parents=True, exist_ok=True)
        self.data = self._read_or_init()

    # -- persistence ---------------------------------------------------------

    def _read_or_init(self) -> dict[str, Any]:
        try:
            loaded = json.loads(self.progress_file.read_text(encoding="utf-8"))
            self.logger.info(
                f"已加载进度文件: {len(loaded.get('processed', []))} 个已处理, "
                f"{len(loaded.get('failed', {}))} 个失败"
            )
            return loaded
        except FileNotFoundError:
            pass
        except Exception as exc:  # corrupt file: start fresh
            self.logger.warning(f"加载进度文件失败: {exc}, 使用空进度")

        fresh = _empty_progress()
        if not self._write(fresh):
            self.logger.warning("创建进度文件失败: 磁盘不可写")
        return fresh

    def _write(self, data: dict[str, Any]) -> bool:
        data["last_updated"] = datetime.now().isoformat()
        try:
            self.progress_file.write_text(
                json.dumps(data, ensure_ascii=False, indent=2), encoding="utf-8"
            )
        except OSError:
            return False
        return True

    def _save(self) -> None:
        if self._write(self.data):
            self.logger.debug(f"进度已保存到 {self.progress_file}")
        else:
            self.logger.error(f"保存进度失败: {self.progress_file}")

    # -- queries ---------------------------------------------------------------

    def is_processed(self, video_id: str) -> bool:
        return video_id in self.data["processed"]

    def is_failed(self, video_id: str) -> bool:
        return video_id in self.data["failed"]

    def get_failed_videos(self) -> dict[str, dict[str, str]]:
        return self.data["failed"]

    def get_statistics(self) -> dict[str, int]:
        return {
            "processed_count": len(self.data["processed"]),
            "failed_count": len(self.data["failed"]),
        }

    def filter_unprocessed(self, video_ids: list[str]) -> list[str]:
        keep = [vid for vid in video_ids if not self.is_processed(vid)]
        if len(keep) != len(video_ids):
            self.logger.info(f"跳过 {len(video_ids) - len(keep)} 个已处理视频")
        return keep

    # -- updates -----------------------------------------------------------------

    def mark_processed(self, video_id: str) -> None:
        if self.is_processed(video_id):
            return
        self.data["processed"].append(video_id)
        self.data["failed"].pop(video_id, None)  # a success clears the failure
        self._save()
        self.logger.info(f"已标记 {video_id} 为处理完成")

    def mark_failed(self, video_id: str, error_message: str) -> None:
        self.data["failed"][video_id] = {
            "error": error_message,
            "timestamp": datetime.now().isoformat(),
        }
        self._save()
        self.logger.warning(f"已标记 {video_id} 为处理失败: {error_message}")

    def reset(self) -> None:
        self.data = _empty_progress()
        self._save()
        self.logger.info("进度已重置")
