"""The port's native ``.y4m`` reader against the JAX package's (CPU).

The port builds its own copy of the C++ shim (``csrc/host/framereader.cpp``,
the JAX package's ``native/framereader.cpp`` below its header) into
``build/vtx_host/``; its frames equal the JAX reader's shim frames exactly
(the same integer arithmetic), plain and 2x2-pooled, and
``containers.read_frames`` takes that route first and counts it. Without a
compiler the reader logs ``event=native_reader_unavailable`` once and
returns the numpy decode, which equals JAX's numpy decode.
"""

import logging
from pathlib import Path

import numpy as np
import pytest

from video_transformer_tpu.video import containers as j_containers
from video_transformer_tpu.video import native_reader as j_native
from video_transformer_tpu_torch.video import containers, native_reader

REPO = Path(__file__).resolve().parents[1]


def write_clip(path: Path, t: int = 12, h: int = 18, w: int = 22, seed: int = 3) -> Path:
    frames = np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    containers.write_y4m(path, frames, fps=6.0)
    return path


def test_the_shim_source_is_the_jax_package_s_below_its_header():
    ours = (REPO / "video_transformer_tpu_torch" / "csrc" / "host" / "framereader.cpp").read_text()
    theirs = (REPO / "native" / "framereader.cpp").read_text()
    body = lambda text: text[text.index("#include"):]  # noqa: E731
    assert body(ours) == body(theirs)


@pytest.mark.parametrize("pooled", [False, True])
def test_native_frames_equal_jax_s_shim_exactly(tmp_path, pooled):
    path = write_clip(tmp_path / "clip.y4m")
    data = path.read_bytes()
    indices = np.array([0, 5, 11, 2])
    got = native_reader.y4m_decode_frames(data, indices, pooled=pooled)
    want = j_native.y4m_decode_frames(data, indices, pooled=pooled)
    assert got is not None and want is not None
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert native_reader.y4m_meta(data) == j_native.y4m_meta(data)
    assert native_reader._lib_path().parent == REPO / "build" / "vtx_host"


def test_read_frames_takes_the_native_route_and_counts_it(tmp_path):
    path = write_clip(tmp_path / "clip.y4m")
    before = dict(containers.Y4M_ROUTES)
    got = containers.read_frames(path, 6, start=0.5, end=1.5)
    want = j_containers.read_frames(path, 6, start=0.5, end=1.5)  # JAX's shim route
    np.testing.assert_array_equal(got, want)
    assert containers.Y4M_ROUTES["native"] == before["native"] + 1
    assert containers.Y4M_ROUTES["numpy"] == before["numpy"]


def test_odd_dimensions_fall_back_to_numpy(tmp_path):
    """The shim refuses odd dimensions (its 4:2:0 indexing); the numpy
    route reads the ceil-half chroma planes."""
    path = tmp_path / "odd.y4m"
    frames = np.random.default_rng(0).integers(0, 256, (4, 7, 9, 3), dtype=np.uint8)
    header = b"YUV4MPEG2 W9 H7 F4:1 C420\n"
    payload = b"".join(b"FRAME\n" + bytes(9 * 7 + 2 * 5 * 4) for _ in frames)
    path.write_bytes(header + payload)
    before = dict(containers.Y4M_ROUTES)
    got = containers.read_frames(path, 2)
    assert got.shape == (2, 7, 9, 3)
    assert containers.Y4M_ROUTES["numpy"] == before["numpy"] + 1


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_missing_compiler_logs_once_and_reads_with_numpy(tmp_path, monkeypatch):
    path = write_clip(tmp_path / "clip.y4m")
    monkeypatch.setattr(native_reader, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_reader, "_lib", None)
    monkeypatch.setattr(native_reader, "_load_failed", False)
    monkeypatch.setattr(native_reader, "_CXX", str(tmp_path / "no-such-compiler"))
    before = dict(containers.Y4M_ROUTES)
    # A handler on the framework's logger itself: the CLI's logging set-up
    # stops its records at that logger.
    logger, capture = logging.getLogger("video_transformer"), _Capture()
    logger.addHandler(capture)
    try:
        first = containers.read_frames(path, 4)
        second = containers.read_frames(path, 4)
    finally:
        logger.removeHandler(capture)
    events = [m for m in capture.messages if "event=native_reader_unavailable" in m]
    assert len(events) == 1
    assert not native_reader.native_available()
    assert containers.Y4M_ROUTES["numpy"] == before["numpy"] + 2
    monkeypatch.setattr(j_native, "y4m_decode_frames", lambda data, indices, pooled=False: None)
    want = j_containers.read_frames(path, 4)  # JAX's numpy route
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_shim_and_numpy_decodes_part_by_at_most_two(tmp_path, monkeypatch):
    """Every (u, v) pair (the 256 x 256 chroma plane of a 512 x 512 frame)
    under 32 luma levels: the shim's fixed-point conversion and the numpy
    decode's float one differ by at most 2, which green reaches (the shim
    floors the sum of its two chroma terms), red and blue by 0."""
    uv = np.arange(256, dtype=np.uint8)
    u_plane = np.repeat(uv[:, None], 256, axis=1).tobytes()
    v_plane = np.repeat(uv[None, :], 256, axis=0).tobytes()
    levels = range(0, 256, 8)
    payload = b"".join(b"FRAME\n" + bytes([y]) * (512 * 512) + u_plane + v_plane for y in levels)
    path = tmp_path / "sweep.y4m"
    path.write_bytes(b"YUV4MPEG2 W512 H512 F1:1 C420\n" + payload)
    native = containers.read_frames(path, len(levels)).astype(int)
    monkeypatch.setattr(native_reader, "y4m_decode_frames", lambda data, idx, pooled=False: None)
    plain = containers.read_frames(path, len(levels)).astype(int)
    assert np.abs(native - plain).max(axis=(0, 1, 2)).tolist() == [0, 2, 0]
