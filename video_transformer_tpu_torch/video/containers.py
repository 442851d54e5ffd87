"""Self-contained video containers.

This package's own copy of the JAX package's ``video/containers.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

The framework owns its decode path (the reference shelled out to ffmpeg,
content_analyzer.py:192-217; GPU hosts should not depend on an ffmpeg
binary). Supported sources:

- ``.npzv`` / ``.npz``: our clip format — a numpy archive with ``frames``
  (uint8 [T, H, W, 3]) and ``fps`` (float). Fast, exact, used by tests,
  and benchmarks.
- ``.y4m``: uncompressed YUV4MPEG2 (420) — the standard raw interchange
  format every encoder can emit. Decoded with numpy: the JAX package's
  C++ fast path (``video/native_reader.py``) is not ported.
- anything else (``.mp4``...): delegated to ffmpeg when the binary exists.

All readers express *time-range + frame-count* access so long-video segments
never require re-containerizing: decoding IS segment extraction.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = [
    "ClipMeta",
    "probe_clip",
    "read_frames",
    "write_npzv",
    "write_y4m",
    "ffmpeg_available",
]

_NPZ_SUFFIXES = {".npzv", ".npz"}
_Y4M_SUFFIX = ".y4m"


@dataclass(frozen=True)
class ClipMeta:
    """Container-level metadata."""

    duration: float
    fps: float
    num_frames: int
    width: int
    height: int
    container: str  # "npzv" | "y4m" | "ffmpeg"


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


# ---------------------------------------------------------------------------
# NPZV clips
# ---------------------------------------------------------------------------


def write_npzv(path: str | Path, frames: np.ndarray, fps: float) -> None:
    """Write a clip archive. frames: uint8 [T, H, W, 3]."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [T, H, W, 3], got {frames.shape}")
    # Write through a file handle: np.savez would otherwise append ".npz".
    with open(Path(path), "wb") as f:
        np.savez(f, frames=frames.astype(np.uint8), fps=np.float64(fps))


def _read_npzv(path: Path) -> tuple[np.ndarray, float]:
    with np.load(path) as archive:
        frames = np.asarray(archive["frames"], dtype=np.uint8)
        fps = float(archive["fps"])
    return frames, fps


def _npzv_meta(path: Path) -> tuple[tuple[int, ...], float]:
    """Read (frames shape, fps) from the archive WITHOUT materializing the
    frames array — probing must stay O(header) on the decode hot path."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        with zf.open("frames.npy") as f:
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
        with zf.open("fps.npy") as f:
            fps = float(np.lib.format.read_array(f))
    return shape, fps


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2, 4:2:0)
# ---------------------------------------------------------------------------


def write_y4m(path: str | Path, frames: np.ndarray, fps: float) -> None:
    """Write RGB frames as a 4:2:0 Y4M stream (dimensions must be even)."""
    t, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError("Y4M 4:2:0 requires even dimensions")
    fps_num = int(round(fps * 1000))
    header = f"YUV4MPEG2 W{w} H{h} F{fps_num}:1000 Ip A1:1 C420jpeg\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        for frame in frames:
            y, u, v = _rgb_to_yuv420(frame)
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


def _rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    y8 = np.clip(y, 0, 255).astype(np.uint8)
    # 2x2 box subsample chroma
    u8 = np.clip(u.reshape(u.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3)), 0, 255)
    v8 = np.clip(v.reshape(v.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3)), 0, 255)
    return y8, u8.astype(np.uint8), v8.astype(np.uint8)


def _yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    yf = y.astype(np.float32)
    h, w = y.shape
    # Chroma planes are ceil-half sized; crop the upsample for odd dims.
    uf = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)[:h, :w].astype(np.float32) - 128.0
    vf = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)[:h, :w].astype(np.float32) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


@dataclass(frozen=True)
class _Y4MLayout:
    width: int
    height: int
    fps: float
    header_len: int
    frame_size: int  # payload bytes per frame (420)
    num_frames: int


def _parse_y4m_header(path: Path) -> _Y4MLayout:
    with open(path, "rb") as f:
        header = f.readline()
    if not header.startswith(b"YUV4MPEG2"):
        raise ValueError(f"Not a Y4M file: {path}")
    width = height = 0
    fps = 0.0
    for token in header.decode("ascii", "replace").split():
        if token.startswith("W"):
            width = int(token[1:])
        elif token.startswith("H"):
            height = int(token[1:])
        elif token.startswith("F"):
            num, den = token[1:].split(":")
            fps = float(num) / float(den)
    if not width or not height or fps <= 0:
        raise ValueError(f"Malformed Y4M header in {path}")
    # 4:2:0 chroma planes are ceil-half sized in each dimension (odd-dim
    # streams exist in the wild even though our writer refuses them).
    frame_size = width * height + 2 * (((width + 1) // 2) * ((height + 1) // 2))
    total = path.stat().st_size - len(header)
    per_frame = len(b"FRAME\n") + frame_size
    num_frames = max(total // per_frame, 0)
    return _Y4MLayout(width, height, fps, len(header), frame_size, int(num_frames))


def _read_y4m_frames(path: Path, indices: np.ndarray) -> np.ndarray:
    # Seek to each selected frame only: the pages of the others are never
    # read.
    layout = _parse_y4m_header(path)
    per_frame = len(b"FRAME\n") + layout.frame_size
    w, h = layout.width, layout.height
    y_size = w * h
    cw, ch = (w + 1) // 2, (h + 1) // 2
    c_size = cw * ch
    frames = np.empty((len(indices), h, w, 3), dtype=np.uint8)
    with open(path, "rb") as f:
        for out_idx, frame_idx in enumerate(indices):
            offset = layout.header_len + int(frame_idx) * per_frame
            f.seek(offset)
            marker = f.read(6)
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"Bad frame marker at index {frame_idx} in {path}")
            payload = f.read(layout.frame_size)
            y = np.frombuffer(payload[:y_size], np.uint8).reshape(h, w)
            u = np.frombuffer(payload[y_size : y_size + c_size], np.uint8).reshape(
                ch, cw
            )
            v = np.frombuffer(payload[y_size + c_size :], np.uint8).reshape(
                ch, cw
            )
            frames[out_idx] = _yuv420_to_rgb(y, u, v)
    return frames


# ---------------------------------------------------------------------------
# ffmpeg delegation (optional)
# ---------------------------------------------------------------------------


def _ffprobe_meta(path: Path) -> ClipMeta | None:
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return None
    cmd = [
        ffprobe, "-v", "error", "-select_streams", "v:0",
        "-show_entries", "stream=width,height,r_frame_rate,nb_frames:format=duration",
        "-of", "default=noprint_wrappers=1", str(path),
    ]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True, timeout=15)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if result.returncode != 0:
        return None
    info: dict[str, str] = {}
    for line in (result.stdout or "").splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            info[k.strip()] = v.strip()
    try:
        duration = float(info.get("duration", "0") or 0)
        rate = info.get("r_frame_rate", "0/1")
        num, den = rate.split("/")
        fps = float(num) / float(den) if float(den) else 0.0
        width = int(info.get("width", "0") or 0)
        height = int(info.get("height", "0") or 0)
        nb = int(info.get("nb_frames", "0") or 0)
        if nb <= 0 and fps > 0:
            nb = int(duration * fps)
        return ClipMeta(duration, fps, nb, width, height, "ffmpeg")
    except (ValueError, ZeroDivisionError):
        return None


def _ffmpeg_read_frames(
    path: Path, start: float, end: float, num_frames: int
) -> np.ndarray:
    meta = _ffprobe_meta(path)
    if meta is None or meta.width <= 0:
        raise RuntimeError(f"ffprobe failed for {path}")
    duration = max(end - start, 1e-6)
    fps_out = num_frames / duration
    cmd = [
        "ffmpeg", "-v", "error", "-ss", f"{start:.3f}", "-i", str(path),
        "-t", f"{duration:.3f}", "-vf", f"fps={fps_out:.6f}",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-frames:v", str(num_frames), "-",
    ]
    result = subprocess.run(cmd, capture_output=True, timeout=300)
    if result.returncode != 0:
        raise RuntimeError(f"ffmpeg decode failed: {result.stderr[-500:]!r}")
    frame_bytes = meta.width * meta.height * 3
    count = len(result.stdout) // frame_bytes
    frames = np.frombuffer(
        result.stdout[: count * frame_bytes], np.uint8
    ).reshape(count, meta.height, meta.width, 3)
    if count < num_frames and count > 0:
        # Pad by repeating the last frame to keep shapes static.
        pad = np.repeat(frames[-1:], num_frames - count, axis=0)
        frames = np.concatenate([frames, pad], axis=0)
    elif count == 0:
        raise RuntimeError(f"ffmpeg produced no frames for {path}")
    return frames


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def probe_clip(path: str | Path) -> ClipMeta | None:
    """Probe container metadata; None if unreadable."""
    p = Path(path)
    if not p.exists():
        return None
    suffix = p.suffix.lower()
    try:
        if suffix in _NPZ_SUFFIXES:
            (t, h, w, _), fps = _npzv_meta(p)
            duration = t / fps if fps > 0 else 0.0
            return ClipMeta(duration, fps, t, w, h, "npzv")
        if suffix == _Y4M_SUFFIX:
            layout = _parse_y4m_header(p)
            duration = layout.num_frames / layout.fps if layout.fps > 0 else 0.0
            return ClipMeta(
                duration, layout.fps, layout.num_frames, layout.width,
                layout.height, "y4m",
            )
    except (ValueError, OSError, KeyError):
        return None
    return _ffprobe_meta(p)


def read_frames(
    path: str | Path,
    num_frames: int,
    start: float = 0.0,
    end: float | None = None,
) -> np.ndarray:
    """Uniformly sample ``num_frames`` RGB frames from [start, end) seconds.

    Returns uint8 [num_frames, H, W, 3] at native resolution. Static output
    shape regardless of source length (short sources repeat frames), which
    keeps downstream jit compilation cache-friendly.
    """
    p = Path(path)
    meta = probe_clip(p)
    if meta is None:
        raise FileNotFoundError(f"Cannot probe video: {p}")
    if end is None or end <= 0:
        end = meta.duration

    if meta.container == "ffmpeg":
        return _ffmpeg_read_frames(p, start, float(end), num_frames)

    total = max(meta.num_frames, 1)
    fps = meta.fps if meta.fps > 0 else 30.0
    first = int(np.clip(round(start * fps), 0, total - 1))
    last = int(np.clip(round(float(end) * fps), first + 1, total))
    # Midpoint sampling: centers of num_frames equal bins over [first, last).
    span = last - first
    centers = first + ((np.arange(num_frames) + 0.5) * span / num_frames)
    indices = np.clip(centers.astype(np.int64), first, last - 1)

    if meta.container == "npzv":
        frames, _ = _read_npzv(p)
        return frames[indices]
    return _read_y4m_frames(p, indices)
