"""ctypes binding for the native frame-decode shim (``csrc/host/framereader.cpp``).

The port's counterpart of the JAX package's ``video/native_reader.py``,
over the port's own copy of the C++ source. At first use the shim is built
with ``g++ -O3 -fPIC -shared -std=c++17`` into ``build/vtx_host/`` under the
repository root, named by a hash of the source and the flags; the build
writes a temporary file and renames it into place, so that processes
building at once never load a half-written library.

This is host code, not a device kernel: when the shim does not build or
load, the reader falls back to the numpy decoder in ``containers.py``, as
the JAX package does, but logs ``event=native_reader_unavailable`` once,
and ``containers.Y4M_ROUTES`` counts which route each read took.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["native_available", "y4m_decode_frames", "y4m_meta"]

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "framereader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vtx_host"
_CXX = "g++"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libframereader_{digest}.so"


def _build(target: Path) -> str | None:
    """Compile the shim into ``target``; None on success, else the reason."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem + ".", suffix=".tmp", dir=target.parent)
    os.close(fd)
    try:
        result = subprocess.run(
            [_CXX, *_FLAGS, "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True, timeout=120,
        )
        if result.returncode != 0:
            return f"compiler exit {result.returncode}: {result.stderr.strip()[:200]}"
        os.replace(tmp, target)
        return None
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"{type(exc).__name__}: {exc}"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _lib_path()
        reason = None if path.exists() else _build(path)
        if reason is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                reason = f"load failed: {exc}"
        if reason is not None:
            _load_failed = True
            logging.getLogger("video_transformer").warning(
                f"event=native_reader_unavailable source={_SOURCE.name} reason={reason!r}: .y4m decodes with numpy"
            )
            return None
        lib.y4m_parse_header.restype = ctypes.c_int
        lib.y4m_parse_header.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.y4m_decode_frames.restype = ctypes.c_int
        lib.y4m_decode_frames.argtypes = [
            # The stream as a read-only uint8 view: bytes and mmap-backed
            # buffers alike, with no copy of the whole file.
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.y4m_decode_frames_pooled.restype = ctypes.c_int
        lib.y4m_decode_frames_pooled.argtypes = lib.y4m_decode_frames.argtypes
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def y4m_meta(data) -> tuple[int, int, float] | None:
    """(width, height, fps) from a Y4M buffer (bytes, mmap or view), or None."""
    lib = _load()
    if lib is None:
        return None
    # The header is small: a bytes copy of the first 4 KiB keeps the
    # c_char_p interface while the frame payload stays zero-copy.
    head = bytes(memoryview(data)[:4096])
    w, h, num, den = (ctypes.c_int32() for _ in range(4))
    header = lib.y4m_parse_header(head, len(head), ctypes.byref(w), ctypes.byref(h), ctypes.byref(num),
                                  ctypes.byref(den))
    if header < 0:
        return None
    return w.value, h.value, num.value / max(den.value, 1)


def y4m_decode_frames(data, indices: np.ndarray, pooled: bool = False) -> np.ndarray | None:
    """Selected frames as RGB uint8 [N, H, W, 3]; None when the shim is
    unusable or refuses the stream (odd dimensions, an index out of range).

    ``data`` is any buffer over the Y4M stream: bytes or an mmap view (only
    the pages of the selected frames are read). ``pooled=True`` also
    average-pools 2x2 in the same pass (half resolution).
    """
    lib = _load()
    if lib is None:
        return None
    meta = y4m_meta(data)
    if meta is None:
        return None
    width, height, _ = meta
    if pooled and (width % 2 or height % 2):
        pooled = False
    out_w, out_h = (width // 2, height // 2) if pooled else (width, height)
    buf = np.frombuffer(data, dtype=np.uint8)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(indices), out_h, out_w, 3), dtype=np.uint8)
    fn = lib.y4m_decode_frames_pooled if pooled else lib.y4m_decode_frames
    if fn(buf, len(buf), indices, len(indices), out) != len(indices):
        return None
    return out
