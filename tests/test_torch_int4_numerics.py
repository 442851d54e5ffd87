"""K6's arithmetic, step by step, on the CPU.

The kernel (``csrc/int4_matmul.cu``) swaps the operands, y^T = W^T x^T: the
packed weight is wgmma's register A operand and x its B operand. A model in
numpy repeats what each thread does, as the PTX ISA defines the instructions:

- TMA writes a [64, 128] stage of packed bytes with the 128-byte swizzle;
- two ``ldmatrix.x4.trans`` a warp read it, with the row addresses the
  kernel gives (rows j and j + 4 of a k-step side by side);
- each byte becomes a bf16x2 by a byte permute, a LOP3 and an FMA;
- the registers are wgmma's m64nNk16 A fragments, whose rows are output
  channels in the kernel's permuted order;
- the f32 tile is folded over the K/2 splits in rank order and stored
  through the pair mapping that undoes the permutation.

The model is held against ``int4_matmul_reference`` and against the JAX
package's Pallas ``_kernel`` in interpret mode, on inputs made with numpy
from a seed: bit for bit on integer x in [-4, 4] (every partial sum an
integer below 2**24, exact in f32 in any order), and element by element
under the card's limit ``chip_smoke.BF16_TOL`` on normal x (the model sums
in another order than the reference; one bf16 rounding step is at most
2**-7 of a value). A model with the nibbles swapped must fail both.
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL, closeness
from video_transformer_tpu.ops.int4_matmul import _int4_matmul_pallas
from video_transformer_tpu_torch.ops.int4_matmul import (
    int4_matmul_reference,
    int4_plan,
    int4_split_units,
    unpack_int4,
)

torch.set_num_threads(2)

UNIT_ROWS = 64  # K/2 rows a stage (kUnitRows)
BLOCK_N = 128  # output channels a block (kBlockN)
SELECTORS = (0x4400, 0x5511, 0x6622, 0x7733)  # byte p of r to byte 0, of r >> 4 to byte 2
SWAPPED = (0x0044, 0x1155, 0x2266, 0x3377)  # the nibbles the other way round: a fault
M_VALUES = [1, 6, 7, 24, 130, 256]
K, N = 512, 256  # K/2 = 256: four stages; two tiles of 128 channels


def byte_perm(r: np.ndarray, s: np.ndarray, sel: int) -> np.ndarray:
    """PTX prmt (CUDA __byte_perm): result byte i is byte (sel >> 4i) & 7 of
    the eight bytes of (s, r), r's first."""
    pool = [(r >> (8 * i)) & 0xFF for i in range(4)] + [(s >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4)).astype(np.uint32)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def nibbles_bf16x2(r: np.ndarray, sel: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's ``nibbles_bf16x2``: (low half, high half) of the bf16x2
    register, as f32. fma.rn.bf16x2 x * 1 - 136 is exact here: x is 128-143."""
    v = (byte_perm(r, r >> 4, sel) & 0x000F000F) ^ 0x43084308
    lo, hi = bf16_bits_to_f32(v & 0xFFFF), bf16_bits_to_f32(v >> 16)
    return lo - np.float32(136), hi - np.float32(136)


def swizzled(tile: np.ndarray) -> np.ndarray:
    """A [rows, 128] byte tile as TMA's 128-byte swizzle lays it out in
    shared memory: 16-byte chunk c of row r at chunk c ^ (r % 8)."""
    rows = tile.shape[0]
    image = np.zeros(rows * 128, tile.dtype)
    for r in range(rows):
        for c in range(8):
            image[r * 128 + 16 * (c ^ (r % 8)):][:16] = tile[r, 16 * c:16 * c + 16]
    return image


def ldmatrix_x4_trans(image: np.ndarray, addresses: list[int]) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16: lane l gives the address of
    row l % 8 of matrix l / 8; lane T receives, for each matrix, the b16
    pair (row 2 (T % 4), column T / 4) and (row 2 (T % 4) + 1, column T / 4)
    in its low and high halves. Returns the registers' bytes [32, 4, 4]."""
    out = np.zeros((32, 4, 4), image.dtype)
    for lane in range(32):
        t, g = lane % 4, lane // 4
        for q in range(4):
            for half in range(2):
                row = addresses[8 * q + 2 * t + half]
                out[lane, q, 2 * half:2 * half + 2] = image[row + 2 * g:row + 2 * g + 2]
    return out


def lane_address(warp: int, lane: int) -> int:
    """The kernel's first ldmatrix address (``w_addr`` less the stage base)."""
    r = lane % 8
    row = 8 * (lane // 8) + r // 2 + 4 * (r % 2)
    return row * 128 + ((warp ^ (row % 8)) * 16)


def channel(wg: int, row: int) -> int:
    """The block channel of A row ``row`` (0-63) of warpgroup ``wg``: rows g
    and g + 8 of warp w's 16 are channels 2g and 2g + 1 of its 16."""
    warp = 4 * wg + row // 16
    return 16 * warp + 2 * (row % 8) + (row % 16) // 8


def a_tiles(stage: np.ndarray, selectors=SELECTORS) -> np.ndarray:
    """A [64, 128] packed stage through the swizzle, both ldmatrix, the
    dequant and the A fragment layout: A [2 warpgroups, 8 k-steps, 64, 16] f32."""
    image = swizzled(stage)
    a = np.zeros((2, 8, 64, 16), np.float32)
    for warp in range(8):
        wg, wq = divmod(warp, 4)
        first = [lane_address(warp, lane) for lane in range(32)]
        regs = np.concatenate([ldmatrix_x4_trans(image, first),
                               ldmatrix_x4_trans(image, [x + 32 * 128 for x in first])], axis=1)  # [32, 8, 4]
        words = sum(regs[..., p].astype(np.uint32) << (8 * p) for p in range(4))  # [32, 8]
        for p, sel in enumerate(selectors):  # register p of a k-step's four
            lo, hi = nibbles_bf16x2(words, sel)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                row = 16 * wq + g + 8 * (p % 2)
                col = 2 * t + 8 * (p // 2)
                a[wg, :, row, col] = lo[lane]
                a[wg, :, row, col + 1] = hi[lane]
    return a


def store_pairs(tile: np.ndarray, m: int) -> np.ndarray:
    """The fold's store: the f32 tile in the accumulator layout (D[wg] is
    64 x width, rows in the permuted channel order) written through the
    kernel's pairs p = (2 i + h) * 256 + t to y [m, 128]."""
    width = tile.shape[2]
    y = np.zeros((m, BLOCK_N), np.float32)
    for p in range(width // 4 * 256):
        t, ih = p % 256, p // 256
        row = 8 * (ih // 2) + 2 * (t % 4) + ih % 2
        if row >= m:
            continue
        warp, lane = divmod(t, 32)
        wg, wq = divmod(warp, 4)
        d_row = 16 * wq + lane // 4  # acc[4 i + h]; acc[4 i + h + 2] is row + 8
        c = 16 * (t // 32) + 2 * ((t % 32) // 4)
        y[row, c] = tile[wg, d_row, row]
        y[row, c + 1] = tile[wg, d_row + 8, row]
    return y


def model(x: np.ndarray, packed: np.ndarray, splits: int | None = None, selectors=SELECTORS) -> np.ndarray:
    """K6 on the CPU: bf16 y [M, N] as an f32 array."""
    m, k = x.shape
    k2, n = packed.shape
    width, plan_splits = int4_plan(m, k2, n)
    splits = splits or plan_splits
    xb = np.zeros((width, k), np.float32)  # TMA's zero rows past M
    xb[:m] = x.astype(np.float32)
    y = np.zeros((m, n), np.float32)
    for n0 in range(0, n, BLOCK_N):
        partials = []
        for rows in int4_split_units(k2, splits):
            acc = np.zeros((2, 64, width), np.float32)
            for j0 in range(rows.start, rows.stop, UNIT_ROWS):
                a = a_tiles(packed[j0:j0 + UNIT_ROWS, n0:n0 + BLOCK_N], selectors)
                for ks in range(8):  # one wgmma k-step: 16 k of x, K-major
                    b = xb[:, 2 * j0 + 16 * ks:2 * j0 + 16 * ks + 16].T
                    acc = acc + np.matmul(a[:, ks], b, dtype=np.float32)
            partials.append(acc)
        folded = functools.reduce(np.add, partials)  # rank order, in f32
        bf16 = folded.astype(ml_dtypes.bfloat16).astype(np.float32)
        y[:, n0:n0 + BLOCK_N] = store_pairs(bf16, m)
    return y


def make(m: int, seed: int, integer: bool):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (m, K)) if integer else rng.standard_normal((m, K))
    return x.astype(ml_dtypes.bfloat16), rng.integers(0, 256, (K // 2, N), dtype=np.uint8)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)


def reference(x: np.ndarray, packed: np.ndarray) -> np.ndarray:
    return int4_matmul_reference(to_torch(x), torch.from_numpy(packed)).float().numpy()


@functools.lru_cache(maxsize=None)
def pallas(m: int, integer: bool) -> np.ndarray:
    x, packed = make(m, m, integer)
    return np.asarray(_int4_matmul_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]), jnp.asarray(packed),
                                          interpret=True), np.float32)


def test_dequant_of_every_byte_equals_unpack_int4():
    """All 256 bytes, in each of the four byte positions of a register."""
    values = np.arange(256, dtype=np.uint32)
    lo_want, hi_want = (t.numpy().astype(np.float32) for t in unpack_int4(torch.arange(256, dtype=torch.uint8)))
    for p, sel in enumerate(SELECTORS):
        word = (values << (8 * p)) | (((values + 77) % 256) << (8 * ((p + 1) % 4)))  # a neighbour byte too
        lo, hi = nibbles_bf16x2(word, sel)
        np.testing.assert_array_equal(lo, lo_want)
        np.testing.assert_array_equal(hi, hi_want)
    lo, hi = nibbles_bf16x2(values, SWAPPED[0])
    assert not np.array_equal(lo, lo_want) and np.array_equal(lo, hi_want)


def test_fragments_are_the_permuted_weight():
    """Swizzle, ldmatrix addresses, dequant and fragment layout together:
    warpgroup wg's A for k-step ks is W^T over k 16 ks .. 16 ks + 15 of the
    stage, its rows the channels ``channel(wg, row)``, a permutation of the
    block's 128 channels."""
    stage = np.random.default_rng(0).integers(0, 256, (UNIT_ROWS, BLOCK_N), dtype=np.uint8)
    lo, hi = (t.numpy().astype(np.float32) for t in unpack_int4(torch.from_numpy(stage)))
    w = np.empty((2 * UNIT_ROWS, BLOCK_N), np.float32)  # W [k, channel] of the stage
    w[0::2], w[1::2] = lo, hi
    channels = np.array([[channel(wg, row) for row in range(64)] for wg in range(2)])
    assert sorted(channels.ravel()) == list(range(BLOCK_N))
    want = np.stack([w[:, channels[wg]].T.reshape(64, 8, 16).transpose(1, 0, 2) for wg in range(2)])
    np.testing.assert_array_equal(a_tiles(stage), want)
    assert not np.array_equal(a_tiles(stage, SWAPPED), want)


def test_store_undoes_the_permutation():
    """A tile whose entry (wg, row, m) is 1000 m + channel(wg, row) stores as
    y[m, c] = 1000 m + c, for each width K6 is built for."""
    for width, m in ((8, 6), (24, 24), (256, 130)):
        tile = np.array([[[1000 * col + channel(wg, row) for col in range(width)] for row in range(64)]
                         for wg in range(2)], np.float32)
        want = 1000 * np.arange(m)[:, None] + np.arange(BLOCK_N)[None, :]
        np.testing.assert_array_equal(store_pairs(tile, m), want)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_splits_cover_k_once_in_rank_order(splits):
    rows = int4_split_units(K // 2, splits)
    assert len(rows) == splits and rows[0].start == 0 and rows[-1].stop == K // 2
    assert all(a.stop == b.start and len(a) % UNIT_ROWS == 0 and len(a) > 0 for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("m", M_VALUES)
@pytest.mark.parametrize("integer", [True, False])
def test_model_matches_reference_and_pallas(m, integer):
    x, packed = make(m, m, integer)
    want = reference(x, packed)
    got = model(x, packed)
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas(m, integer))
    else:
        for other in (want, pallas(m, integer)):
            check = closeness(torch.from_numpy(got), torch.from_numpy(other), *BF16_TOL)
            assert check["ratio"] <= 1, check


@pytest.mark.parametrize("m", [6, 130])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_split_fold_keeps_integers_exact(m, splits):
    """Every split count, folded in rank order, is bit-equal on integer x."""
    x, packed = make(m, 100 + m, integer=True)
    np.testing.assert_array_equal(model(x, packed, splits), reference(x, packed))


@pytest.mark.parametrize("m", [6, 24])
def test_swapped_nibbles_fail(m):
    x, packed = make(m, m, integer=False)
    check = closeness(torch.from_numpy(model(x, packed, selectors=SWAPPED)),
                      torch.from_numpy(reference(x, packed)), *BF16_TOL)
    assert check["ratio"] > 1, check
