"""Video acquisition: yt-dlp wrapper with local-file passthrough.

This package's own copy of the JAX package's ``pipeline/downloader.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

Capability parity with reference src/downloader/video_downloader.py:
resolution-capped yt-dlp downloads with Bilibili headers, human-like retry
delays, 403/429 special-casing, size validation, batch downloads with
politeness gaps. Additions for on-device deployments: local paths and file://
URLs pass straight through (clusters typically stage videos on shared
storage, not the public internet), and yt-dlp is an optional dependency —
a clear error explains when it is needed.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Any
from urllib.parse import urlparse

__all__ = ["VideoDownloader"]

_NATIVE_SUFFIXES = {".npzv", ".npz", ".y4m", ".mp4", ".mkv", ".webm", ".mov"}


class VideoDownloader:
    def __init__(self, config: dict[str, Any], logger: logging.Logger | None = None):
        self.logger = logger or logging.getLogger("video_transformer")
        downloader_config = config.get("downloader", {}) or {}
        self.retry_times = int(downloader_config.get("retry_times", 3))
        self.video_format = downloader_config.get("video_format", "mp4")
        self.max_resolution = int(downloader_config.get("max_resolution", 360))
        self.sleep_interval = float(downloader_config.get("sleep_interval", 2))
        self.max_sleep_interval = float(downloader_config.get("max_sleep_interval", 4))
        system = config.get("system", {}) or {}
        self.temp_dir = Path(system.get("temp_dir", "./data/temp")) / "downloads"

    # -- public API ----------------------------------------------------------

    def download_video(self, url: str) -> Path | None:
        """Fetch one video; returns the local path or None on failure."""
        local = self._resolve_local(url)
        if local is not None:
            if local.exists():
                self.logger.info(f"event=download_local path={local}")
                return local
            self.logger.error(f"本地视频不存在: {local}")
            return None

        self.temp_dir.mkdir(parents=True, exist_ok=True)
        for attempt in range(1, self.retry_times + 1):
            try:
                path = self._ytdlp_download(url)
                if path and self.validate_video(path):
                    return path
                self.logger.warning(f"下载的视频未通过校验 (attempt {attempt})")
            except PermissionError as exc:  # 403/429 class errors
                wait = random.uniform(10, 20) * attempt
                self.logger.warning(
                    f"下载被限流/拒绝 (attempt {attempt}): {exc}; 等待 {wait:.0f}s"
                )
                time.sleep(wait)
            except Exception as exc:
                self.logger.warning(f"下载失败 (attempt {attempt}): {exc}")
                time.sleep(random.uniform(self.sleep_interval, self.max_sleep_interval))
        return None

    def validate_video(self, path: str | Path) -> bool:
        """Exists and is plausibly a video (>= 500KB unless a native clip)."""
        path = Path(path)
        if not path.exists():
            return False
        if path.suffix.lower() in {".npzv", ".npz", ".y4m"}:
            return path.stat().st_size > 0
        return path.stat().st_size >= 500 * 1024

    def download_from_file(self, url_file: str | Path) -> list[Path]:
        """Batch download with politeness gaps between requests."""
        urls = [
            line.strip()
            for line in Path(url_file).read_text(encoding="utf-8").splitlines()
            if line.strip() and not line.strip().startswith("#")
        ]
        paths: list[Path] = []
        for idx, url in enumerate(urls):
            result = self.download_video(url)
            if result is not None:
                paths.append(result)
            if idx < len(urls) - 1 and self._resolve_local(url) is None:
                time.sleep(random.uniform(3, 5))
        return paths

    def cleanup_temp_files(self) -> int:
        """Delete downloaded temp files; returns the number removed."""
        if not self.temp_dir.exists():
            return 0
        removed = 0
        for path in self.temp_dir.iterdir():
            if path.is_file():
                path.unlink()
                removed += 1
        return removed

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _resolve_local(url: str) -> Path | None:
        """Local path / file:// URL passthrough."""
        parsed = urlparse(url)
        if parsed.scheme == "file":
            return Path(parsed.path)
        if parsed.scheme in ("http", "https"):
            return None
        candidate = Path(url)
        if candidate.suffix.lower() in _NATIVE_SUFFIXES or candidate.exists():
            return candidate
        return None

    def _ydl_opts(self, output_template: str) -> dict[str, Any]:
        return {
            "format": (
                f"bestvideo[height<={self.max_resolution}]+bestaudio/"
                f"best[height<={self.max_resolution}]/best"
            ),
            "outtmpl": output_template,
            "merge_output_format": self.video_format,
            "noplaylist": True,
            "quiet": True,
            "no_warnings": True,
            "proxy": "",
            "sleep_interval": self.sleep_interval,
            "max_sleep_interval": self.max_sleep_interval,
            "http_headers": {"Referer": "https://www.bilibili.com/"},
        }

    def _ytdlp_download(self, url: str) -> Path | None:
        try:
            import yt_dlp  # type: ignore[import-not-found]
        except ImportError as exc:
            raise RuntimeError(
                "yt-dlp is not installed; remote URLs need it "
                "(local paths and file:// URLs work without it)"
            ) from exc

        template = str(self.temp_dir / "%(id)s.%(ext)s")
        with yt_dlp.YoutubeDL(self._ydl_opts(template)) as ydl:
            try:
                info = ydl.extract_info(url, download=True)
            except yt_dlp.utils.DownloadError as exc:  # type: ignore[attr-defined]
                message = str(exc)
                if "403" in message or "429" in message:
                    raise PermissionError(message) from exc
                raise
        if info is None:
            return None
        filename = ydl.prepare_filename(info)
        path = Path(filename).with_suffix(f".{self.video_format}")
        return path if path.exists() else Path(filename)
