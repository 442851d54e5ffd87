"""The port's PIL-free blueprint (visualizer, PNG codec, rasterizer, atlas,
auditor image path) against the JAX package's PIL-drawn one (CPU).

Tolerances:

- ``parse_schema_graph``, ``_layout_nodes``, the forensic score and its
  issue list, ``_validate_image``'s verdicts and ``_image_clip``'s pixels
  (PIL's default bicubic ``resize``, reproduced in fixed point) are equal.
- The rendered blueprint has JAX's size, and at most ``PIXEL_SHARE`` (0.5%)
  of its pixels differ from JAX's by more than 16 levels in any channel. On
  the schemas below the worst share is 0.13% (1K), 0.08% (2K) and 0.04%
  (4K): the rounded corners are sampled at pixel centres where PIL walks its
  ellipse rasterizer, and PIL's polygon filler joins corners its own way.
- The atlas equals a fresh render from PIL and DejaVu, and text drawn from
  it equals PIL's coverage on the strings below (skipped where PIL or the
  fonts are absent).
- The PNG reader decodes PIL-written L, RGB and RGBA PNGs and rows of each
  of the five filters exactly; anything else raises ``ValueError``.
"""

import io
import json
import logging
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from video_transformer_tpu.pipeline import visualizer as j_vis
from video_transformer_tpu.pipeline.auditor import QualityAuditor as JAuditor
from video_transformer_tpu.utils.counter import APICounter as JCounter
from video_transformer_tpu_torch.pipeline import visualizer as p_vis
from video_transformer_tpu_torch.pipeline.auditor import QualityAuditor
from video_transformer_tpu_torch.pipeline.png import decode_png, encode_png, to_luma
from video_transformer_tpu_torch.pipeline.raster import ATLAS_PATH, Canvas, load_face, resize_bicubic
from video_transformer_tpu_torch.utils.counter import APICounter

Image = pytest.importorskip("PIL.Image")
ImageDraw = pytest.importorskip("PIL.ImageDraw")
ImageFont = pytest.importorskip("PIL.ImageFont")

PIXEL_SHARE = 0.005
FONT_DIR = Path("/usr/share/fonts/truetype/dejavu")
needs_fonts = pytest.mark.skipif(not (FONT_DIR / "DejaVuSans.ttf").exists(), reason="DejaVu fonts absent")

SCHEMAS = [
    "知识蓝图\n输入 -> 编码器 -> 解码器\n- 损失函数",
    "Transformer overview\nTokens -> Embedding -> Attention -> MLP -> Logits\nAttention -> Softmax\n- Positional enc",
    "Σ and Ω: Greek αβγ\nα -> β -> γ\nβ -> δ\nγ -> ε -> ζ",
    "A\nB\nC\nD\nE\nF\nG",
    "no title -> arrows -> here\nx -> y",
    "机器学习基础\n监督学习 -> 分类 -> 逻辑回归\n监督学习 -> 回归 -> 线性回归\n无监督学习 -> 聚类 -> K均值\n"
    "- 评估指标 (Accuracy, F1)\n- 过拟合与正则化 a very long label that is truncated somewhere",
    "only one line",
    "长链\n" + " -> ".join(f"N{i}" for i in range(30)),  # boxes narrower than their corners
    "\n".join(f"节点{i}" for i in range(40)),
    "t\n" + " -> ".join(f"N{i}" for i in range(12)) + "\n" + "\n".join(f"x{i} -> y{i}" for i in range(9)),
]


def generators(size: str = "1K", ratio: str = "16:9"):
    config = {"image_generator": {"backend": "local", "image_size": size, "aspect_ratio": ratio}}
    return j_vis.ImageGenerator(config), p_vis.ImageGenerator(config)


def pil_pixels(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


# -- parsing and layout ----------------------------------------------------------

schema_text = st.lists(st.sampled_from(["标题", "A -> B", "- 节点", "x → y → z", "α => β", "  ", "长" * 50,
                                        "a —> b -> c", "* star", "plain"]), max_size=12).map("\n".join)


@settings(max_examples=80, deadline=None)
@given(schema=schema_text | st.text(max_size=60))
def test_parse_and_layout_equal(schema):
    parsed = p_vis.parse_schema_graph(schema)
    assert parsed == j_vis.parse_schema_graph(schema)
    _, nodes, edges = parsed
    nodes = nodes or ["(empty schema)"]
    for width, height, margin, top in ((1280, 720, 53, 202), (3840, 2160, 160, 448)):
        assert p_vis._layout_nodes(nodes, edges, width, height, margin, top) == \
            j_vis._layout_nodes(nodes, edges, width, height, margin, top)


# -- the rendered blueprint --------------------------------------------------------


@needs_fonts
@pytest.mark.parametrize("size", ["1K", "2K", "4K"])
@pytest.mark.parametrize("schema", range(len(SCHEMAS)))
def test_blueprint_matches_jax_within_share(size, schema, tmp_path):
    j_gen, p_gen = generators(size)
    want_png = j_gen.generate_blueprint(SCHEMAS[schema])
    got_png = p_gen.generate_blueprint(SCHEMAS[schema])
    want, got = pil_pixels(want_png), decode_png(got_png)
    assert got.shape == want.shape
    far = (np.abs(got.astype(int) - want.astype(int)).max(-1) > 16).mean()
    assert far <= PIXEL_SHARE, f"{far:.4%} of pixels differ by more than 16 levels"
    assert np.array_equal(pil_pixels(got_png), got)  # PIL reads the port's PNG as the port does
    (tmp_path / "j.png").write_bytes(want_png)
    (tmp_path / "p.png").write_bytes(got_png)
    config = {"auditor": {"threshold": 75}}
    assert QualityAuditor(config, APICounter(5))._forensic_score(tmp_path / "p.png") == \
        JAuditor(config, JCounter(5))._forensic_score(tmp_path / "j.png")


def test_canvas_aspect_ratios_equal():
    for ratio in ("16:9", "4:3", "1:1", "bad", "3:0"):
        for size in ("1K", "2K", "4K", "8K"):
            j_gen, p_gen = generators(size, ratio)
            assert p_gen._canvas_size() == j_gen._canvas_size()


def test_empty_schema_returns_none():
    for gen in generators():
        assert gen.generate_blueprint("") is None and gen.generate_blueprint("  \n ") is None


def test_face_missing_from_atlas_raises():
    with pytest.raises(NotImplementedError, match="make_glyph_atlas"):
        load_face("regular", 999)


def test_atlas_is_small():
    assert ATLAS_PATH.stat().st_size < 4 * 1024 * 1024


# -- the atlas and text against PIL ---------------------------------------------------

FACES = [("bold", "DejaVuSans-Bold.ttf", w // 36) for w in (1280, 2048, 3840)] + \
        [("regular", "DejaVuSans.ttf", w // 56) for w in (1280, 2048, 3840)]


@needs_fonts
@pytest.mark.parametrize("style, filename, size", FACES, ids=[f"{f[0]}_{f[2]}" for f in FACES])
def test_atlas_equals_a_fresh_pil_render(style, filename, size):
    """Every 5th glyph of the face (and ``.notdef``) as PIL draws it now:
    coverage, placement, advance and one-glyph box; the kerning pairs'
    adjustments as PIL lays them out."""
    import tools.make_glyph_atlas as tool

    font = ImageFont.truetype(str(FONT_DIR / filename), size)
    face = load_face(style, size)
    assert face.ascender == font.getmetrics()[0]
    pad = 2 * size
    rows = list(range(0, len(face.table), 5))
    for row in rows:
        cp, width, height, left, top, advance, offset = (int(v) for v in face.table[row, :7])
        text = tool.NOTDEF_PROBE if cp < 0 else chr(cp)
        pixels = tool.render(font, text, pad)
        want = pixels[pad + top:pad + top + height, pad + left:pad + left + width]
        assert np.array_equal(face.masks[offset:offset + width * height].reshape(height, width), want), text
        assert pixels.sum() == int(want.sum())  # nothing outside the stored box
        assert advance == round(font.getlength(text) * 64)
        assert face.getbbox(text) == font.getbbox(text), text
    for a, b in list(face.kern.items())[::7]:
        pair = chr(a[0]) + chr(a[1])
        assert round(font.getlength(pair) * 64) == b + int(face.table[face.index[a[0]], 5]) + \
            int(face.table[face.index[a[1]], 5])


TEXTS = ["AVATAR Tokyo", "To Yo Wa", "编码器 -> Decoder", "注意力机制", "f(x) = y", "Transformer…", "Ωo$%B4",
         "Σ and Ω: αβγ", "(empty schema)", "WAVE ∑≤∞ ≠ →", "Lj ij Kv", "K均值"]


@needs_fonts
@pytest.mark.parametrize("style, filename, size", FACES[:2] + FACES[3:5], ids=lambda v: str(v))
def test_text_equals_pil(style, filename, size):
    """Text drawn from the atlas at fractional origins equals PIL's pixels
    (layout, kerning, the start's rounding, glyph overlap, blending), and
    its ``textbbox`` equals PIL's."""
    font = ImageFont.truetype(str(FONT_DIR / filename), size)
    face = load_face(style, size)
    rng = np.random.default_rng(size)
    for text in TEXTS:
        assert face.getbbox(text) == font.getbbox(text), text
        for _ in range(4):
            x, y = float(rng.uniform(3, 40)), float(rng.uniform(3, 30))
            want = Image.new("RGB", (size * 16, size * 3), j_vis._BG)
            ImageDraw.Draw(want).text((x, y), text, font=font, fill=j_vis._INK)
            canvas = Canvas(size * 16, size * 3, p_vis._BG)
            canvas.text((x, y), text, face, p_vis._INK)
            assert np.array_equal(canvas.pixels, np.asarray(want)), (text, x, y)
            assert canvas.textbbox((x, y), text, face) == ImageDraw.Draw(want).textbbox((x, y), text, font=font)


# -- the PNG codec -------------------------------------------------------------------------


def _filtered_png(pixels: np.ndarray, colour: int, filters: list[int]) -> bytes:
    """A PNG whose row r uses filter ``filters[r % len(filters)]`` (the
    spec's filters, written plainly)."""
    height, width, channels = pixels.shape
    prev = np.zeros(width * channels, np.int64)
    raw = bytearray()
    for r in range(height):
        line = pixels[r].reshape(-1).astype(np.int64)
        kind = filters[r % len(filters)]
        left = np.concatenate([np.zeros(channels, np.int64), line[:-channels]])
        upleft = np.concatenate([np.zeros(channels, np.int64), prev[:-channels]])
        if kind == 0:
            out = line
        elif kind == 1:
            out = line - left
        elif kind == 2:
            out = line - prev
        elif kind == 3:
            out = line - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            out = line - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([kind]) + (out & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _image(seed: int, channels: int, height: int = 37, width: int = 53) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    smooth = np.stack([(x * 3 + y * c) % 256 for c in range(channels)], -1)
    noise = rng.integers(0, 256, (height, width, channels))
    return np.where(rng.random((height, width, 1)) < 0.3, noise, smooth).astype(np.uint8)


@pytest.mark.parametrize("colour, channels", [(0, 1), (2, 3), (6, 4)], ids=["L", "RGB", "RGBA"])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]], ids=str)
def test_png_reader_each_filter(colour, channels, filters):
    pixels = _image(colour, channels)
    data = _filtered_png(pixels, colour, filters)
    assert np.array_equal(decode_png(data), pixels)
    with Image.open(io.BytesIO(data)) as img:  # the test's writer is a valid PNG
        assert np.array_equal(np.asarray(img).reshape(pixels.shape), pixels)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_reader_round_trips_pil(mode, optimize):
    pixels = _image(7, 4, 64, 96)
    img = Image.fromarray(pixels, "RGBA").convert(mode)
    buffer = io.BytesIO()
    img.save(buffer, "PNG", optimize=optimize)
    got = decode_png(buffer.getvalue())
    assert np.array_equal(got.reshape(np.asarray(img).shape), np.asarray(img))
    assert np.array_equal(to_luma(got), np.asarray(img.convert("L")))


def test_png_writer_round_trips():
    pixels = _image(3, 3, 50, 70)
    data = encode_png(pixels)
    assert np.array_equal(decode_png(data), pixels)
    assert np.array_equal(pil_pixels(data), pixels)


@pytest.mark.parametrize("mode", ["P", "LA", "I;16", "1"])
def test_png_reader_refuses_other_types(mode):
    img = Image.fromarray(_image(1, 3), "RGB").convert(mode if mode != "I;16" else "I").convert(mode) \
        if mode != "LA" else Image.fromarray(_image(1, 3), "RGB").convert("LA")
    buffer = io.BytesIO()
    img.save(buffer, "PNG")
    with pytest.raises(ValueError):
        decode_png(buffer.getvalue())


def test_png_reader_refuses_interlaced_and_damaged():
    good = encode_png(_image(2, 3))
    interlaced = bytearray(good)
    interlaced[8 + 8 + 12] = 1
    interlaced[8 + 8 + 13:8 + 8 + 17] = struct.pack(">I", zlib.crc32(bytes(interlaced[12:8 + 8 + 13])))
    for bad in (bytes(interlaced), good[:-20], good[:40], b"GIF89a" + good[6:], good[:30] + b"\0" + good[31:], b""):
        with pytest.raises(ValueError):
            decode_png(bad)


def test_validate_image_verdicts_equal():
    j_gen, p_gen = generators()
    good = p_gen.generate_blueprint(SCHEMAS[0])
    small = io.BytesIO()
    Image.new("RGB", (99, 99), "white").save(small, "PNG")
    edge = io.BytesIO()
    Image.new("RGB", (100, 100), "white").save(edge, "PNG")
    jpeg = io.BytesIO()
    Image.new("RGB", (200, 200), "white").save(jpeg, "JPEG")
    cases = {"good": good, "jax_good": j_gen.generate_blueprint(SCHEMAS[0]), "truncated": good[: len(good) // 2],
             "99x99": small.getvalue(), "100x100": edge.getvalue(), "not_png": b"not an image at all",
             "jpeg": jpeg.getvalue(), "empty": b""}
    verdicts = {name: (p_gen._validate_image(data), j_gen._validate_image(data)) for name, data in cases.items()}
    # A deliberate difference (ROADMAP §3): the port reads PNG only, so a
    # JPEG (which only the optional cloud backend could return) is refused.
    assert verdicts.pop("jpeg") == (False, True)
    assert all(got == want for got, want in verdicts.values()), verdicts
    assert verdicts["good"] == (True, True) and verdicts["99x99"] == (False, False)


# -- the auditor's image path ---------------------------------------------------------------


class FrameEngine:
    """The engine surface ``_image_clip`` reads (encoder.num_frames)."""

    def __init__(self, frames: int = 4):
        self.config = type("Cfg", (), {"encoder": type("Enc", (), {"num_frames": frames})()})()
        self.byte_vocab = 512


@pytest.mark.parametrize("mode, size", [("RGB", (1280, 720)), ("RGB", (3840, 2160)), ("RGBA", (700, 300)),
                                        ("L", (300, 900)), ("RGB", (320, 240))])
def test_image_clip_equal(mode, size, tmp_path):
    rng = np.random.default_rng(size[0])
    pixels = rng.integers(0, 256, (size[1], size[0], 4), dtype=np.uint8)
    pixels[: size[1] // 3] = 250
    path = tmp_path / "img.png"
    Image.fromarray(pixels, "RGBA").convert(mode).save(path)
    config = {"auditor": {"threshold": 75, "use_engine": True}}
    j_aud, p_aud = JAuditor(config, JCounter(5)), QualityAuditor(config, APICounter(5))
    j_aud.attach_engine(FrameEngine())
    p_aud.attach_engine(FrameEngine())
    want, got = j_aud._image_clip(path), p_aud._image_clip(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_resize_bicubic_equals_pil_upscale():
    pixels = _image(5, 3, 40, 30)
    for size in ((77, 61), (30, 80), (13, 9)):
        want = np.asarray(Image.fromarray(pixels).resize(size))
        assert np.array_equal(resize_bicubic(pixels, *size), want)


@pytest.mark.parametrize("kind", ["blank", "low_contrast", "small", "dense", "sparse", "good"])
def test_forensic_score_equal(kind, tmp_path):
    rng = np.random.default_rng(0)
    sizes = {"small": (200, 150)}
    w, h = sizes.get(kind, (640, 480))
    pixels = np.full((h, w, 3), 250, np.uint8)
    if kind == "low_contrast":
        pixels[::2] = 225
    elif kind == "dense":
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == "sparse":
        pixels[10:12, 10:20] = 0
    elif kind in ("good", "small"):
        pixels[h // 4:h // 2, w // 4:3 * w // 4] = 30
    path = tmp_path / "f.png"
    Image.fromarray(pixels).save(path)
    config = {"auditor": {"threshold": 75}}
    assert QualityAuditor(config, APICounter(5))._forensic_score(path) == \
        JAuditor(config, JCounter(5))._forensic_score(path)


def test_audit_of_a_non_png_defaults_to_pass_as_in_jax(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"not a png")
    config = {"auditor": {"threshold": 75}}
    got = QualityAuditor(config, APICounter(5), logging.getLogger("t")).audit_image(path, "note")
    want = JAuditor(config, JCounter(5), logging.getLogger("t")).audit_image(path, "note")
    assert (got.score, got.passed) == (want.score, want.passed) == (75.0, True)
    assert got.feedback.startswith("审核过程异常，默认通过: ")


def test_model_audit_prompt_and_frames_equal(tmp_path):
    """use_engine: the still clip and the prompt the engine is given are
    JAX's; the verdict combines as JAX's."""
    seen = {}

    class Judge(FrameEngine):
        def __init__(self, side):
            super().__init__()
            self.side = side

        def wrap_grammar(self, dfa):
            return dfa

        def generate(self, frames, prompts, dfa=None):
            seen[self.side] = (frames.copy(), prompts)
            return [json.dumps({"score": 61, "feedback": "ok"})]

    j_gen, p_gen = generators()
    path = tmp_path / "b.png"
    path.write_bytes(p_gen.generate_blueprint(SCHEMAS[1]))
    config = {"auditor": {"threshold": 75, "use_engine": True}}
    results = []
    for side, cls, counter in (("j", JAuditor, JCounter), ("p", QualityAuditor, APICounter)):
        auditor = cls(config, counter(5))
        auditor.attach_engine(Judge(side))
        results.append(vars(auditor.audit_image(path, "# 笔记\n内容" * 50)))
    assert results[0] == results[1]
    assert np.array_equal(seen["j"][0], seen["p"][0]) and seen["j"][1] == seen["p"][1]
