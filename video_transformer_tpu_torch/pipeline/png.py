"""A PNG codec in numpy and the standard library (the port imports no PIL).

``encode_png`` writes 8-bit RGB, non-interlaced: IHDR, one IDAT, IEND, each
with its CRC. ``decode_png`` reads 8-bit L, RGB and RGBA, non-interlaced,
with any of the five row filters, and raises ``ValueError`` for every other
PNG (palette, 16-bit, interlaced, grey + alpha) and for damaged data (a bad
signature or CRC, a truncated stream, missing chunks). ``to_luma`` converts
as PIL's ``convert("L")`` does (ITU-R 601-2 weights in 16-bit fixed point).

The rows are unfiltered along anti-diagonals: a byte depends on its left,
upper and upper-left neighbours only, so every pixel of a diagonal is
reconstructed in one vectorized step (H + W - 1 steps for an H x W image).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_png", "decode_png", "to_luma"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel (L, RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(rgb: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] image (every row filter 0, None)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {rgb.shape}")
    height, width = rgb.shape[:2]
    rows = np.zeros((height, 1 + 3 * width), np.uint8)
    rows[:, 1:] = rgb.reshape(height, 3 * width)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, through IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG: bad signature")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        if struct.unpack(">I", data[end:end + 4])[0] != zlib.crc32(kind + payload):
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _header(payload: bytes) -> tuple[int, int, int]:
    if len(payload) != 13:
        raise ValueError("PNG IHDR of the wrong length")
    width, height, depth, colour, compression, filtering, interlace = struct.unpack(">IIBBBBB", payload)
    if width == 0 or height == 0:
        raise ValueError("PNG of zero size")
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {colour}, interlace {interlace}")
    return width, height, _CHANNELS[colour]


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, channels: int) -> np.ndarray:
    """Reconstruct [H, W, C] from the filtered scanlines (filter byte first)."""
    types = raw[:, 0].astype(np.int32)
    if types.max() > 4:
        raise ValueError(f"PNG row filter {int(types.max())} unknown")
    filtered = raw[:, 1:].reshape(height, width, channels).astype(np.int32)
    if not types.any():
        return filtered.astype(np.uint8)
    # Zero-padded on the top and the left: recon[y + 1, x + 1] is pixel (y, x).
    recon = np.zeros((height + 1, width + 1, channels), np.int32)
    rows_all = np.arange(height)
    for diag in range(height + width - 1):
        lo, hi = max(0, diag - width + 1), min(height - 1, diag)
        ys = rows_all[lo:hi + 1]
        xs = diag - ys
        a = recon[ys + 1, xs]
        b = recon[ys, xs + 1]
        c = recon[ys, xs]
        kind = types[ys][:, None]
        pred = np.where(kind == 1, a, np.where(kind == 2, b, np.where(
            kind == 3, (a + b) >> 1, np.where(kind == 4, _paeth(a, b, c), 0))))
        recon[ys + 1, xs + 1] = (filtered[ys, xs] + pred) & 0xFF
    return recon[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, C] (C = 1, 3 or 4) from PNG bytes; ``ValueError`` for
    anything but an intact 8-bit non-interlaced L, RGB or RGBA PNG."""
    header = None
    idat = []
    for kind, payload in _chunks(data):
        if header is None:
            if kind != b"IHDR":
                raise ValueError("PNG does not open with IHDR")
            header = _header(payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if not idat:
        raise ValueError("PNG without IDAT")
    width, height, channels = header
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"PNG data does not inflate: {exc}") from exc
    stride = 1 + width * channels
    if len(raw) != stride * height:
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {stride * height}")
    return _unfilter(np.frombuffer(raw, np.uint8).reshape(height, stride), height, width, channels)


def to_luma(pixels: np.ndarray) -> np.ndarray:
    """uint8 [H, W] luma of [H, W, C] pixels, as PIL's ``convert("L")``:
    (19595 R + 38470 G + 7471 B + 2^15) >> 16; L passes through, and the
    alpha of RGBA is dropped."""
    if pixels.shape[2] == 1:
        return pixels[:, :, 0]
    rgb = pixels[:, :, :3].astype(np.uint32)
    return ((rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470 + rgb[:, :, 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
