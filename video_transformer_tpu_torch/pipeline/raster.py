"""A small RGB rasterizer for the blueprint: what the JAX renderer asks of PIL.

The JAX package draws its blueprint with PIL (``video_transformer_tpu/
pipeline/visualizer.py::_local_render``); the port imports no PIL and the
card has no DejaVu font, so this module draws the same primitives into a numpy canvas, following
PIL's arithmetic where it is known:

- ``line`` at width > 1: PIL's wide line, a four-corner polygon around the
  segment with its end points truncated to integers, filled by scanlines
  (crossings rounded inward, as PIL's polygon filler rounds them);
- ``rounded_rectangle``: PIL's shape (the box rounded to integers, corner
  quarter-discs about the centres of PIL's corner boxes, an outline
  ``width`` px wide inside the box), the corners sampled at pixel centres
  where PIL walks its own ellipse rasterizer;
- ``text``: glyph coverage from ``glyphs.npz`` (written by
  ``tools/make_glyph_atlas.py`` from PIL and DejaVu), laid out as PIL's
  raqm layout lays it out (26.6 advances and kerning pairs, each glyph at
  its rounded pen position, the fractional start added to the pen), the
  glyphs' coverage combined by maximum, then blended once into the canvas
  with PIL's ``(a * (255 - m) + ink * m) / 255`` rounding;
- ``textbbox``: PIL's ``getbbox`` of the same layout (anchor ``la``).

Characters outside the atlas (U+0020-U+024F, U+0370-U+03FF, U+2000-U+22FF
where DejaVu has them) draw DejaVu's ``.notdef`` box, as PIL does for a
character the font lacks. ``tests/test_torch_visualizer.py`` holds a
rendered blueprint against PIL's pixel for pixel, within a stated share.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["Canvas", "Face", "load_face", "ATLAS_PATH"]

ATLAS_PATH = Path(__file__).resolve().parent / "glyphs.npz"
_NOTDEF = -1


def _round(x: float) -> int:
    """C's ``round``: halves away from zero."""
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def _pixel(x: int) -> int:
    """26.6 fixed point to whole pixels, rounded (FreeType's PIXEL)."""
    return (x + 32) >> 6


class Face:
    """One font at one pixel size, from the atlas."""

    def __init__(self, table: np.ndarray, masks: np.ndarray, kern: np.ndarray, ascender: int):
        self.table = table
        self.masks = masks
        self.ascender = int(ascender)
        self.index = {int(cp): i for i, cp in enumerate(table[:, 0])}
        self.kern = {(int(a), int(b)): int(d) for a, b, d in kern}

    def _row(self, ch: str) -> int:
        return self.index.get(ord(ch), self.index[_NOTDEF])

    def layout(self, text: str) -> list[tuple[int, int]]:
        """(table row, 26.6 pen position) of each glyph."""
        placed, pos, prev = [], 0, None
        for ch in text:
            row = self._row(ch)
            cp = int(self.table[row, 0])
            if prev is not None:
                pos += self.kern.get((prev, cp), 0)
            placed.append((row, pos))
            pos += int(self.table[row, 5])
            prev = cp
        return placed

    def getbbox(self, text: str) -> tuple[int, int, int, int]:
        """PIL's ``FreeTypeFont.getbbox(text)`` (anchor ``la``)."""
        x_min = x_max = y_top = y_bottom = 0
        for row, pos in self.layout(text):
            px = _pixel(pos)
            _, _, _, _, _, advance, _, bx0, bx1, top, bottom = (int(v) for v in self.table[row])
            x_max = max(x_max, _pixel(pos + advance), px + bx1)
            x_min = min(x_min, px + bx0)
            y_top, y_bottom = max(y_top, top), min(y_bottom, bottom)
        return x_min, self.ascender - y_top, x_max, self.ascender - y_bottom

    def coverage(self, text: str, start: tuple[float, float]) -> tuple[np.ndarray, tuple[int, int]]:
        """(uint8 mask, (dx, dy)): the text's coverage and where its top-left
        corner lies from the integer origin. Each glyph lies over the ones
        before it (``g + (m * (255 - g)) / 255``)."""
        # The start's fraction joins the pen in 26.6; FreeType's y axis
        # points up, so a downward fraction rounds its halves up.
        shift_x, shift_y = _round(start[0] * 64), -_pixel(-_round(start[1] * 64))
        spots = []
        for row, pos in self.layout(text):
            width, height, left, top = (int(v) for v in self.table[row, 1:5])
            if width and height:
                spots.append((row, _pixel(pos + shift_x) + left, shift_y + top, width, height))
        if not spots:
            return np.zeros((0, 0), np.uint8), (0, 0)
        x0 = min(s[1] for s in spots)
        y0 = min(s[2] for s in spots)
        x1 = max(s[1] + s[3] for s in spots)
        y1 = max(s[2] + s[4] for s in spots)
        mask = np.zeros((y1 - y0, x1 - x0), np.int32)
        for row, gx, gy, width, height in spots:
            offset = int(self.table[row, 6])
            glyph = self.masks[offset:offset + width * height].reshape(height, width).astype(np.int32)
            region = mask[gy - y0:gy - y0 + height, gx - x0:gx - x0 + width]
            region[:] = glyph + _div255(region * (255 - glyph))
        return mask.astype(np.uint8), (x0, y0)


@lru_cache(maxsize=None)
def _atlas() -> dict[str, np.ndarray]:
    with np.load(ATLAS_PATH, allow_pickle=False) as data:
        return {key: data[key] for key in data.files}


@lru_cache(maxsize=None)
def load_face(style: str, size: int) -> Face:
    """The atlas face ``style`` ("bold" or "regular") at ``size`` px;
    ``NotImplementedError`` for a size the atlas does not hold."""
    arrays = _atlas()
    key = f"{style}_{size}"
    if f"{key}/table" not in arrays:
        held = sorted({name.split("/")[0] for name in arrays})
        raise NotImplementedError(f"the glyph atlas holds no {key} face (it holds {held}); "
                                  "tools/make_glyph_atlas.py writes it")
    return Face(arrays[f"{key}/table"], arrays[f"{key}/masks"], arrays[f"{key}/kern"],
                int(arrays[f"{key}/metrics"][0]))


def _div255(value: np.ndarray) -> np.ndarray:
    tmp = value + 128
    return ((tmp >> 8) + tmp) >> 8


class Canvas:
    """An RGB image as uint8 [H, W, 3], drawn on as PIL's ``ImageDraw``."""

    def __init__(self, width: int, height: int, background: tuple[int, int, int]):
        self.pixels = np.empty((height, width, 3), np.uint8)
        self.pixels[:] = background
        self.height, self.width = height, width

    # -- fills ---------------------------------------------------------------

    def _hline(self, y: int, x0: int, x1: int, fill) -> None:
        """Pixels x0..x1 (inclusive) of row y, clipped."""
        if 0 <= y < self.height:
            x0, x1 = max(x0, 0), min(x1, self.width - 1)
            if x0 <= x1:
                self.pixels[y, x0:x1 + 1] = fill

    def polygon(self, vertices: list[tuple[int, int]], fill) -> None:
        """Scanline fill of an integer polygon: each row from y_min to
        y_max, crossings with the edges rounded inward (left up, right
        down); a horizontal edge is drawn as its own row."""
        edges = []
        for (xa, ya), (xb, yb) in zip(vertices, vertices[1:] + vertices[:1]):
            if ya == yb:
                self._hline(ya, min(xa, xb), max(xa, xb), fill)
                continue
            if ya > yb:
                xa, ya, xb, yb = xb, yb, xa, ya
            edges.append((ya, yb, xa, (xb - xa) / (yb - ya)))
        if not edges:
            return
        y_lo = max(min(e[0] for e in edges), 0)
        y_hi = min(max(e[1] for e in edges), self.height - 1)
        for y in range(y_lo, y_hi + 1):
            xs = sorted((y - e0) * slope + x0 for e0, e1, x0, slope in edges if e0 <= y <= e1)
            if len(xs) >= 2:
                self._hline(y, math.ceil(xs[0] - 1e-9), math.floor(xs[-1] + 1e-9), fill)

    def line(self, points: list[tuple[float, float]], fill, width: int) -> None:
        """PIL's wide line through ``points`` (width > 1)."""
        for (xa, ya), (xb, yb) in zip(points, points[1:]):
            x0, y0, x1, y1 = int(xa), int(ya), int(xb), int(yb)
            dx, dy = x1 - x0, y1 - y0
            if dx == 0 and dy == 0:
                self._hline(y0, x0, x0, fill)
                continue
            big = math.hypot(dx, dy)
            small = (width - 1) / 2.0
            ratio_max = math.ceil(small) / big
            ratio_min = math.floor(small) / big
            dxmin, dxmax = math.floor(ratio_min * dy), math.floor(ratio_max * dy)
            dymin, dymax = math.floor(ratio_min * dx), math.floor(ratio_max * dx)
            self.polygon([(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                          (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)], fill)

    def rounded_rectangle(self, box, radius: int, fill, outline, width: int) -> None:
        """PIL's ``rounded_rectangle`` with a fill and an outline ``width`` px
        wide inside the box: the box rounded to integers, each corner a
        quarter-disc of radius ``radius + 1/2`` about the centre of PIL's
        corner box, sampled at pixel centres (PIL walks its own ellipse
        rasterizer there). A radius past half the box is cut to half the
        shorter side (PIL draws an ellipse when both sides are that short)."""
        x0, y0, x1, y1 = (round(v) for v in box)
        x0c, y0c = max(x0, 0), max(y0, 0)
        x1c, y1c = min(x1, self.width - 1), min(y1, self.height - 1)
        if x0c > x1c or y0c > y1c:
            return
        r = min(radius, (x1 - x0) // 2, (y1 - y0) // 2)
        xs = np.arange(x0c, x1c + 1, dtype=np.float64)
        ys = np.arange(y0c, y1c + 1, dtype=np.float64)
        # Distance from each pixel centre to the rectangle of corner centres.
        dx = np.maximum(np.maximum(x0 + r - xs, xs - (x1 - r)), 0.0)
        dy = np.maximum(np.maximum(y0 + r - ys, ys - (y1 - r)), 0.0)
        dist = np.sqrt(dx[None, :] ** 2 + dy[:, None] ** 2)
        outer = r + 0.5
        region = self.pixels[y0c:y1c + 1, x0c:x1c + 1]
        region[dist <= outer] = outline
        region[dist <= outer - width] = fill

    # -- text ----------------------------------------------------------------

    def textbbox(self, xy: tuple[float, float], text: str, face: Face) -> tuple[float, float, float, float]:
        x0, y0, x1, y1 = face.getbbox(text)
        return x0 + xy[0], y0 + xy[1], x1 + xy[0], y1 + xy[1]

    def text(self, xy: tuple[float, float], text: str, face: Face, fill) -> None:
        start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
        mask, (dx, dy) = face.coverage(text, start)
        left, top = int(xy[0]) + dx, int(xy[1]) + dy
        height, width = mask.shape
        ya, yb = max(top, 0), min(top + height, self.height)
        xa, xb = max(left, 0), min(left + width, self.width)
        if ya >= yb or xa >= xb:
            return
        m = mask[ya - top:yb - top, xa - left:xb - left].astype(np.int32)[:, :, None]
        region = self.pixels[ya:yb, xa:xb]
        ink = np.asarray(fill, np.int32)
        region[:] = _div255(region.astype(np.int32) * (255 - m) + ink * m).astype(np.uint8)


# -- resampling ----------------------------------------------------------------

_PRECISION_BITS = 22  # PIL's 8-bit resample: 32 - 8 - 2


def _bicubic(x: float) -> float:
    """PIL's bicubic kernel (a = -0.5), support 2."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the whole
    axis: (first source index [out], int64 weights [out, ksize])."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(k)
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            scaled = w * (1 << _PRECISION_BITS)
            weights[xx, x] = int(-0.5 + scaled) if w < 0 else int(0.5 + scaled)
        starts[xx] = xmin
    return starts, weights


def _resample_axis(pixels: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = pixels.shape[axis]
    starts, weights = _coefficients(in_size, out_size)
    src = np.moveaxis(pixels.astype(np.int64), axis, 0)
    padded = np.concatenate([src, np.zeros((weights.shape[1],) + src.shape[1:], np.int64)])
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    extra = (slice(None),) + (None,) * (src.ndim - 1)
    for tap in range(weights.shape[1]):
        acc += padded[starts + tap] * weights[:, tap][extra]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] resized as PIL's ``Image.resize((width, height))``
    does for an RGB image (bicubic, the default): a horizontal pass, then a
    vertical one, each in 22-bit fixed point, clipped to 0..255."""
    if (pixels.shape[1], pixels.shape[0]) == (width, height):
        return pixels.copy()
    if pixels.shape[1] != width:
        pixels = _resample_axis(pixels, width, 1)
    if pixels.shape[0] != height:
        pixels = _resample_axis(pixels, height, 0)
    return pixels
