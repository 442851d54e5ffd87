#!/usr/bin/env python3
"""Write the blueprint renderer's glyph atlas from PIL and the DejaVu fonts.

The PyTorch port draws its blueprint PNG without PIL or fonts (it imports
no PIL, and the card has no DejaVu font), so the text the JAX renderer draws with PIL and DejaVu Sans
(``video_transformer_tpu/pipeline/visualizer.py``: Bold at ``width // 36``
for the title, Sans at ``width // 56`` for the nodes) is committed as an
atlas. This tool runs on a host that has PIL (with its raqm layout), the
fonts and fontTools:

  python tools/make_glyph_atlas.py [OUT.npz]

(default ``video_transformer_tpu_torch/pipeline/glyphs.npz``, about 1.9 MB
compressed). Sizes: the canvas widths of ``image_size`` 1K, 2K and 4K
(1280, 2048 and 3840 px), so six faces.

For each face (``bold_<px>``, ``regular_<px>``) the file holds, keyed
``<face>/<name>``: ``table`` int32 [n, 11] (code point, -1 for ``.notdef``;
mask width and height; mask left and top from the text origin, the top of
the ascender line, at integer pen position 0; the advance in 26.6 pixels;
the offset of the mask in ``masks``; the glyph's box for ``textbbox`` as
x0, x1, y-up top, y-up bottom, each clamped as PIL clamps a one-glyph
box); ``masks`` uint8 (each glyph's coverage, its ink box, row-major);
``kern`` int32 [m, 3] (first and second code point, the pair's 26.6
adjustment as PIL's layout applies it); ``metrics`` int32 [ascender px].
The ranges: U+0020-U+024F, U+0370-U+03FF, U+2000-U+22FF, each code point
the font maps; any other character draws ``.notdef``. Nothing is pickled.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "video_transformer_tpu_torch" / "pipeline" / "glyphs.npz"
FONT_DIR = Path("/usr/share/fonts/truetype/dejavu")
FONTS = {"bold": ("DejaVuSans-Bold.ttf", 36), "regular": ("DejaVuSans.ttf", 56)}  # style: (file, width divisor)
WIDTHS = {"1K": 1280, "2K": 2048, "4K": 3840}
RANGES = ((0x20, 0x24F), (0x370, 0x3FF), (0x2000, 0x22FF))
NOTDEF_PROBE = "中"  # a CJK character: DejaVu has no glyph for it


def covered(cmap: dict[int, str]) -> list[int]:
    return sorted(cp for cp in cmap if any(lo <= cp <= hi for lo, hi in RANGES))


def kern_candidates(font_path: Path, cps: list[int]) -> set[tuple[int, int]]:
    """Pairs of covered code points with a nonzero x-advance adjustment in
    a lookup of the font's GPOS ``kern`` feature (pair format 1 or 2)."""
    from fontTools.ttLib import TTFont

    tt = TTFont(str(font_path))
    cmap = tt.getBestCmap()
    by_glyph: dict[str, list[int]] = {}
    for cp in cps:
        by_glyph.setdefault(cmap[cp], []).append(cp)
    gpos = tt["GPOS"].table
    lookups = sorted({i for rec in gpos.FeatureList.FeatureRecord if rec.FeatureTag == "kern"
                      for i in rec.Feature.LookupListIndex})
    pairs: set[tuple[str, str]] = set()
    for index in lookups:
        lookup = gpos.LookupList.Lookup[index]
        for sub in lookup.SubTable:
            if lookup.LookupType == 9:
                sub = sub.ExtSubTable
            if getattr(sub, "Format", None) == 1:
                for first, pset in zip(sub.Coverage.glyphs, sub.PairSet):
                    for rec in pset.PairValueRecord:
                        if getattr(rec.Value1, "XAdvance", 0):
                            pairs.add((first, rec.SecondGlyph))
            elif getattr(sub, "Format", None) == 2:
                class1 = sub.ClassDef1.classDefs
                class2 = sub.ClassDef2.classDefs
                firsts = [g for g in sub.Coverage.glyphs if g in by_glyph]
                seconds = [g for g in by_glyph]
                for first in firsts:
                    row = sub.Class1Record[class1.get(first, 0)].Class2Record
                    for second in seconds:
                        if getattr(row[class2.get(second, 0)].Value1, "XAdvance", 0):
                            pairs.add((first, second))
    return {(a, b) for g1, g2 in pairs if g1 in by_glyph and g2 in by_glyph
            for a in by_glyph[g1] for b in by_glyph[g2]}


def render(font, text: str, pad: int):
    """The coverage PIL draws for ``text`` at integer origin (pad, pad)."""
    from PIL import Image, ImageDraw

    size = font.size
    canvas = Image.new("L", (4 * size + 2 * pad, 3 * size + 2 * pad), 0)
    ImageDraw.Draw(canvas).text((pad, pad), text, font=font, fill=255)
    return np.asarray(canvas)


def face_arrays(font_path: Path, size: int, pairs: set[tuple[int, int]], cps: list[int]) -> dict[str, np.ndarray]:
    from PIL import ImageFont

    font = ImageFont.truetype(str(font_path), size)
    ascender = font.getmetrics()[0]
    pad = 2 * size
    rows, masks, offset = [], [], 0
    advances: dict[int, int] = {}
    for cp in [-1] + cps:
        text = NOTDEF_PROBE if cp < 0 else chr(cp)
        pixels = render(font, text, pad)
        ys, xs = np.nonzero(pixels)
        if len(xs):
            x0, x1, y0, y1 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
            crop = pixels[y0:y1, x0:x1]
        else:
            x0 = y0 = pad
            crop = np.zeros((0, 0), np.uint8)
        advance = round(font.getlength(text) * 64)
        advances[cp] = advance
        box = font.getbbox(text)
        pixel_advance = (advance + 32) >> 6
        # PIL's box of one glyph: x0 = min(0, cbox x0), x1 = max(advance,
        # cbox x1), top = ascender - max(0, cbox top), bottom = ascender -
        # min(0, cbox bottom). x1 inside the advance is taken from the ink.
        box_x1 = box[2] if box[2] > pixel_advance else int(x0 - pad + crop.shape[1])
        rows.append([cp, crop.shape[1], crop.shape[0], int(x0 - pad), int(y0 - pad), advance, offset,
                     box[0], box_x1, ascender - box[1], ascender - box[3]])
        masks.append(crop.reshape(-1))
        offset += crop.size
    kern = []
    for a, b in sorted(pairs):
        delta = round(font.getlength(chr(a) + chr(b)) * 64) - advances[a] - advances[b]
        if delta:
            kern.append([a, b, delta])
    return {"table": np.asarray(rows, np.int32), "masks": np.concatenate(masks).astype(np.uint8),
            "kern": np.asarray(kern, np.int32).reshape(-1, 3), "metrics": np.asarray([ascender], np.int32)}


def build(sizes: list[str]) -> dict[str, np.ndarray]:
    from fontTools.ttLib import TTFont

    arrays: dict[str, np.ndarray] = {}
    for style, (filename, divisor) in FONTS.items():
        path = FONT_DIR / filename
        cps = covered(TTFont(str(path)).getBestCmap())
        pairs = kern_candidates(path, cps)
        for label in sizes:
            px = WIDTHS[label] // divisor
            for name, array in face_arrays(path, px, pairs, cps).items():
                arrays[f"{style}_{px}/{name}"] = array
            print(f"{style} {px}px ({label}): {len(cps)} glyphs, {len(pairs)} kerning candidates", file=sys.stderr)
    return arrays


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("out", nargs="?", default=str(DEFAULT_OUT))
    parser.add_argument("--sizes", nargs="+", default=["1K", "2K", "4K"], choices=sorted(WIDTHS))
    args = parser.parse_args(argv)
    arrays = build(args.sizes)
    with open(args.out, "wb") as handle:  # a handle: np.savez would append .npz to a name
        np.savez_compressed(handle, **arrays)
    print(f"{args.out}: {Path(args.out).stat().st_size} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
