"""Long-video segmentation: planning, extraction, and the resume manifest.

This package's own copy of the JAX package's ``video/segmenter.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

Segments have core (effective) ranges plus ±overlap extraction ranges. The
JSON manifest — {version, video_id, created_at, segment_seconds,
overlap_seconds, segments: [{id, start, end, effective_start, effective_end,
file_path, status, attempts, error}]} — is the per-segment resume checkpoint
and is byte-compatible with the reference's
(src/utils/video_segmenter.py:170-266) so manifests interoperate.

The manifest doubles as the batch descriptor: pending segments are decoded
and analyzed as one batch (or swept through the continuous batcher) instead
of the reference's sequential loop.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import TypedDict, cast

from .containers import probe_clip, read_frames, write_npzv

__all__ = [
    "SegmentInfo",
    "SegmentEntry",
    "SegmentManifest",
    "plan_segments",
    "extract_segment",
    "snap_to_keyframe",
    "get_segment_dir",
    "get_manifest_path",
    "create_manifest",
    "load_manifest",
    "save_manifest",
    "load_or_create_manifest",
    "pending_segments",
    "update_segment_status",
]

_STATUS_DONE = "completed"


@dataclass(frozen=True)
class SegmentInfo:
    segment_id: int
    start: float  # extraction range (± overlap)
    end: float
    effective_start: float  # core range (merge uses these)
    effective_end: float

    def manifest_entry(self, clip_path: Path) -> "SegmentEntry":
        return {
            "id": self.segment_id,
            "start": self.start,
            "end": self.end,
            "effective_start": self.effective_start,
            "effective_end": self.effective_end,
            "file_path": str(clip_path),
            "status": "pending",
            "attempts": 0,
            "error": None,
        }


class SegmentEntry(TypedDict):
    id: int
    start: float
    end: float
    effective_start: float
    effective_end: float
    file_path: str
    status: str  # pending -> processing -> completed / failed / skipped
    attempts: int
    error: str | None


class SegmentManifest(TypedDict):
    version: int
    video_id: str
    created_at: str
    segment_seconds: float
    overlap_seconds: float
    segments: list[SegmentEntry]


def _core_ranges(duration: float, step: float):
    """Yield (start, end) core tiles covering [0, duration)."""
    start = 0.0
    while start < duration:
        yield start, min(start + step, duration)
        start = min(start + step, duration)


def plan_segments(
    duration: float, segment_seconds: float, overlap_seconds: float
) -> list[SegmentInfo]:
    """Tile [0, duration) into cores of ``segment_seconds``; each segment's
    extraction range widens by ``overlap_seconds`` across interior
    boundaries only (the first segment starts at 0, the last ends at
    duration, exactly)."""
    if duration <= 0 or segment_seconds <= 0:
        return []
    pad = max(overlap_seconds, 0.0)

    plan: list[SegmentInfo] = []
    for core_start, core_end in _core_ranges(duration, segment_seconds):
        lo = core_start if core_start <= 0 else max(core_start - pad, 0.0)
        hi = duration if core_end >= duration else min(core_end + pad, duration)
        if hi <= lo:
            break
        plan.append(SegmentInfo(len(plan), lo, hi, core_start, core_end))
    return plan


# ---------------------------------------------------------------------------
# Clip extraction
# ---------------------------------------------------------------------------


def extract_segment(
    input_path: str | Path, start: float, end: float,
    output_path: str | Path, stream_copy: bool = True,
) -> bool:
    """Materialize one segment clip on disk.

    Native containers are sliced in-process into an ``.npzv`` clip (exact,
    no re-encode); other containers use ffmpeg stream-copy with a re-encode
    fallback when available. Returns False on any failure.
    """
    if end - start <= 0:
        return False
    src, dst = Path(input_path), Path(output_path)
    dst.parent.mkdir(parents=True, exist_ok=True)

    meta = probe_clip(src)
    if meta is not None and meta.container in {"npzv", "y4m"}:
        return _slice_native(src, start, end, dst, meta.fps)
    if shutil.which("ffmpeg") is None:
        return False
    return _slice_ffmpeg(src, start, end, dst, stream_copy)


def _slice_native(src: Path, start: float, end: float, dst: Path, fps: float) -> bool:
    try:
        rate = fps if fps > 0 else 30.0
        count = max(int(round((end - start) * rate)), 1)
        frames = read_frames(src, count, start=start, end=end)
        target = dst
        if target.suffix.lower() not in {".npzv", ".npz"}:
            target = target.with_suffix(".npzv")
        write_npzv(target, frames, rate)
        if target != dst:
            shutil.move(str(target), str(dst))
    except (ValueError, OSError, RuntimeError):
        return False
    return dst.exists() and dst.stat().st_size > 0


def _slice_ffmpeg(
    src: Path, start: float, end: float, dst: Path, stream_copy: bool
) -> bool:
    head = [
        "ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
        "-ss", f"{start:.3f}", "-i", str(src),
        "-t", f"{end - start:.3f}", "-movflags", "+faststart",
    ]
    codec_attempts = []
    if stream_copy:
        codec_attempts.append(["-c", "copy"])
    codec_attempts.append(
        ["-c:v", "libx264", "-preset", "veryfast", "-crf", "23",
         "-c:a", "aac", "-b:a", "128k"]
    )
    for codec in codec_attempts:
        try:
            proc = subprocess.run(
                head + codec + [str(dst)],
                capture_output=True, text=True, timeout=120,
            )
        except (FileNotFoundError, OSError, subprocess.TimeoutExpired):
            return False
        if proc.returncode == 0 and dst.exists() and dst.stat().st_size > 0:
            return True
        if dst.exists():
            dst.unlink()
    return False


def snap_to_keyframe(video_path: str | Path, timestamp: float) -> float:
    """Keyframe snapping hook (identity for native containers — every frame
    is independently addressable)."""
    _ = video_path
    return max(0.0, float(timestamp))


# ---------------------------------------------------------------------------
# Manifest lifecycle
# ---------------------------------------------------------------------------


def get_segment_dir(video_id: str, temp_dir: str | Path) -> Path:
    return Path(temp_dir) / "segments" / video_id


def get_manifest_path(video_id: str, temp_dir: str | Path) -> Path:
    return get_segment_dir(video_id, temp_dir) / "manifest.json"


def create_manifest(
    *, video_id: str, duration: float, segment_seconds: float,
    overlap_seconds: float, temp_dir: str | Path,
) -> SegmentManifest:
    segment_dir = get_segment_dir(video_id, temp_dir)
    segment_dir.mkdir(parents=True, exist_ok=True)
    entries = [
        seg.manifest_entry(segment_dir / f"segment_{seg.segment_id:04d}.mp4")
        for seg in plan_segments(duration, segment_seconds, overlap_seconds)
    ]
    manifest = cast(SegmentManifest, dict(
        version=1,
        video_id=video_id,
        created_at=datetime.now(timezone.utc).isoformat(),
        segment_seconds=segment_seconds,
        overlap_seconds=overlap_seconds,
        segments=entries,
    ))
    save_manifest(get_manifest_path(video_id, temp_dir), manifest)
    return manifest


def load_manifest(manifest_path: str | Path) -> SegmentManifest:
    raw = Path(manifest_path).read_text(encoding="utf-8")
    return cast(SegmentManifest, json.loads(raw))


def save_manifest(manifest_path: str | Path, manifest: SegmentManifest) -> None:
    path = Path(manifest_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(manifest, indent=2, ensure_ascii=True), encoding="utf-8"
    )


def load_or_create_manifest(
    *, video_id: str, duration: float, segment_seconds: float,
    overlap_seconds: float, temp_dir: str | Path,
) -> SegmentManifest:
    existing = get_manifest_path(video_id, temp_dir)
    if existing.exists():
        return load_manifest(existing)
    return create_manifest(
        video_id=video_id, duration=duration,
        segment_seconds=segment_seconds, overlap_seconds=overlap_seconds,
        temp_dir=temp_dir,
    )


def pending_segments(manifest: SegmentManifest) -> list[SegmentEntry]:
    return [s for s in manifest["segments"] if s["status"] != _STATUS_DONE]


def update_segment_status(
    manifest: SegmentManifest, segment_id: int, status: str,
    *, error: str | None = None, increment_attempts: bool = False,
) -> None:
    entry = next(
        (s for s in manifest["segments"] if s["id"] == segment_id), None
    )
    if entry is None:
        logging.getLogger(__name__).warning(
            "Segment id %s not found in manifest", segment_id
        )
        return
    entry["status"] = status
    if error is not None:
        entry["error"] = error
    if increment_attempts:
        entry["attempts"] += 1
