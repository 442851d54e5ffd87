"""K3's and K5's arithmetic, step by step, on the CPU.

The kernels (``csrc/decode_attention.cu``) run flash-decoding in one launch:
the blocks of a (kv head, batch row) form a cluster, each takes an equal
share of the valid extent's 64-position tiles (``decode_plan``), four
warps multiply with ``mma.sync.m16n8k16`` (bf16 in, f32
accumulate), and the blocks fold their partials in rank order. A model in
numpy repeats what each lane of a warp does, as the PTX ISA
defines the mma fragments:

- q's A fragments and k's B fragments take four consecutive d a thread in
  each k-step (a permutation of the contraction shared by both); odd key
  rows load their 16-byte chunks in a rotated order and undo it with
  selects; int8 converts to bf16 exactly by a LOP3 pair and an FMA;
- the scale 1/sqrt(d) x k_scale x log2(e) multiplies S's f32 accumulator;
  the online softmax runs in base 2 on the accumulator's layout, over two
  tiles a step where a warp takes 16 or 32 keys of each;
- P enters O += P V as bf16 P_hi + P_lo; v's B fragments put output column
  n of n-tile i at d = 16 n + i;
- each warp's (m, l, acc) partial goes to shared memory in its registers'
  layout, the parts of a 16-row group fold in part order, then the ranks
  fold in rank order and the fold's units store to (row, d);
- K5 copies a tile's new rows from k_new/v_new instead of the cache into
  the stage, and the block whose tiles hold them stores them to the cache.

The model is held against the port's plain f32 version and the JAX
package's Pallas ``_kernel_pipelined`` in interpret mode, on inputs made
with numpy from a seed, within ``chip_smoke.REL_TOL`` (1e-2) of the largest
output, the limit the card is held to: the kernel rounds its output to
bf16 once (at most 2**-8 of a value), P's hi + lo pair is within 2**-16 of
P, and the rest is f32 rounding in another order. Models with a layout
fault (the rotation of k's or v's chunks not undone) must fail it.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import REL_TOL, split_edge_index
from video_transformer_tpu.ops import decode_attention as j_dec
from video_transformer_tpu_torch.ops.decode_attention import _scaled_reference, decode_plan, decode_splits

torch.set_num_threads(2)

KD, BK = 128, 64  # head_dim, cache positions a tile (kD, kBK)
GROUP_ROWS = 16  # folded q rows a 16-row group (an mma's M)
WARPS = 4  # warps a block (kWarps)
THREADS = 32 * WARPS  # a block's threads (kThreads)
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # groupID and threadID_in_group of the mma fragments
F32 = np.float32


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> its 16 bits, as uint32."""
    return np.asarray(x, F32).astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.uint32)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(F32)


def lo_hi(reg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The two bf16 of a bf16x2 register, as f32."""
    return bf16_value(reg & 0xFFFF), bf16_value(reg >> 16)


def pack(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return bf16_bits(lo) | (bf16_bits(hi) << 16)


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """PTX prmt (CUDA __byte_perm): result byte i is byte (sel >> 4i) & 7 of
    the eight bytes of (y, x), x's first."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4)).astype(np.uint32)


def s8_bf16x2(x: np.ndarray) -> np.ndarray:
    """The kernel's ``s8_bf16x2``: bytes 0 and 2 of x, signed, as a bf16x2.
    m = 128 + (b & 127) and s = -(128 + (b & 128)) are bf16 bit patterns;
    fma.rn.bf16x2 m * 1 + s rounds once to bf16."""
    m = (x & 0x007F007F) | 0x43004300
    s = (x & 0x00800080) | 0xC300C300
    (m_lo, m_hi), (s_lo, s_hi) = lo_hi(m), lo_hi(s)
    return pack(m_lo + s_lo, m_hi + s_hi)


def k_dim(kk: int, t: np.ndarray, int8: bool) -> np.ndarray:
    """The first of the four consecutive d thread t contracts in k-step kk."""
    return 64 * (kk // 4) + 16 * t + 4 * (kk % 4) if int8 else 32 * (kk // 2) + 8 * t + 4 * (kk % 2)


def chunks(image: np.ndarray, rows: np.ndarray, chunk: np.ndarray) -> np.ndarray:
    """A 16-byte load a lane: the four words of chunk ``chunk`` of row
    ``rows`` of a tile image [64, row bytes] -> [32, 4] uint32."""
    words = image.view(np.uint32)
    return words[rows[:, None], 4 * chunk[:, None] + np.arange(4)[None, :]]


def k_fragments(image: np.ndarray, rows: np.ndarray, int8: bool, fault: str | None = None) -> np.ndarray:
    """The kernel's ``k_fragments``: S's B registers {b0, b1} of the eight
    k-steps for each lane's key row -> [32, 8, 2]."""
    odd = (G & 1).astype(bool)
    undo = fault != "k_rotation"
    b = np.zeros((32, 8, 2), np.uint32)
    if int8:
        c = [chunks(image, rows, 4 * (i ^ (G & 1)) + T) for i in range(2)]
        for j in range(2):
            blk = np.where(odd[:, None] & undo, c[j ^ 1], c[j])
            for x in range(4):
                b[:, 4 * j + x, 0] = s8_bf16x2(byte_perm(blk[:, x], 0, 0x0100))
                b[:, 4 * j + x, 1] = s8_bf16x2(byte_perm(blk[:, x], 0, 0x0302))
    else:
        c = [chunks(image, rows, 4 * ((i + (G & 1)) & 3) + T) for i in range(4)]
        for j in range(4):
            blk = np.where(odd[:, None] & undo, c[(j + 3) & 3], c[j])
            b[:, 2 * j, 0], b[:, 2 * j, 1], b[:, 2 * j + 1, 0], b[:, 2 * j + 1, 1] = blk.T
    return b


def v_fragments(image: np.ndarray, key: int, int8: bool, fault: str | None = None) -> np.ndarray:
    """The kernel's ``v_fragments``: P V's B registers for the 16 output
    n-tiles of the k-step over keys key .. key + 15 -> [32, 16, 2]."""
    rows = [key + 2 * T, key + 2 * T + 1, key + 2 * T + 8, key + 2 * T + 9]
    b = np.zeros((32, 16, 2), np.uint32)
    if int8:
        w = [chunks(image, r, G) for r in rows]
        for i in range(16):
            sel = (i % 4) | ((4 + i % 4) << 8)
            b[:, i, 0] = s8_bf16x2(byte_perm(w[0][:, i // 4], w[1][:, i // 4], sel))
            b[:, i, 1] = s8_bf16x2(byte_perm(w[2][:, i // 4], w[3][:, i // 4], sel))
    else:
        odd = (T & 1).astype(bool)[:, None] & (fault != "v_rotation")
        w = []
        for r in rows:
            c = [chunks(image, r, 2 * G + (hh ^ (T & 1))) for hh in range(2)]
            w.append(np.concatenate([np.where(odd, c[1], c[0]), np.where(odd, c[0], c[1])], axis=1))
        for i in range(16):
            sel = 0x7632 if i % 2 else 0x5410
            b[:, i, 0] = byte_perm(w[0][:, i // 2], w[1][:, i // 2], sel)
            b[:, i, 1] = byte_perm(w[2][:, i // 2], w[3][:, i // 2], sel)
    return b


def a_matrix(a: np.ndarray) -> np.ndarray:
    """m16n8k16 A [16, 16] from the lanes' {a0, a1, a2, a3} [32, 4]."""
    out = np.zeros((16, 16), F32)
    for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = lo_hi(a[:, reg])
        out[G + dr, 2 * T + dc], out[G + dr, 2 * T + dc + 1] = lo, hi
    return out


def b_matrix(b: np.ndarray) -> np.ndarray:
    """m16n8k16 B [16, 8] from the lanes' {b0, b1} [32, 2]."""
    out = np.zeros((16, 8), F32)
    for reg in range(2):
        lo, hi = lo_hi(b[:, reg])
        out[2 * T + 8 * reg, G], out[2 * T + 8 * reg + 1, G] = lo, hi
    return out


def mma(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """d = c + A B on fragments: c, d [32, 4] f32 (c0, c1 = row g, columns
    2t, 2t + 1; c2, c3 = row g + 8). bf16 products are exact in f32."""
    prod = (a_matrix(a).astype(np.float64) @ b_matrix(b).astype(np.float64)).astype(F32)
    return np.stack([c[:, 0] + prod[G, 2 * T], c[:, 1] + prod[G, 2 * T + 1],
                     c[:, 2] + prod[G + 8, 2 * T], c[:, 3] + prod[G + 8, 2 * T + 1]], axis=1).astype(F32)


def quad(x: np.ndarray, op) -> np.ndarray:
    """Two shuffles (xor 1, then xor 2) within each quad of lanes."""
    x = op(x, x[LANE ^ 1])
    return op(x, x[LANE ^ 2])


def parts_for(nrows: int) -> int:
    """Warps a 16-row group: the kernel's ``dispatch``."""
    return 4 if nrows <= GROUP_ROWS else 2 if nrows <= 2 * GROUP_ROWS else 1


class Warp:
    """One warp's registers over one pass: q's A fragments for its
    16 rows, and (m, l, acc) over its keys of each tile."""

    def __init__(self, q_rows: np.ndarray, row0: int, nrows: int, length: int, width: int, int8: bool):
        self.qa = np.zeros((32, 8, 4), np.uint32)
        rows = row0 + G
        for kk in range(8):
            d = k_dim(kk, T, int8)
            for reg, dr, dd in ((0, 0, 0), (1, 8, 0), (2, 0, 2), (3, 8, 2)):
                r = rows + dr
                ok = r < nrows
                vals = q_rows[np.minimum(r, nrows - 1)[:, None], (d + dd)[:, None] + np.arange(2)]
                self.qa[:, kk, reg] = np.where(ok, pack(vals[:, 0], vals[:, 1]), 0)
        self.limit = [length + rows % width, length + (rows + 8) % width]
        self.m = [np.full(32, -np.inf, F32), np.full(32, -np.inf, F32)]
        self.l = [np.zeros(32, F32), np.zeros(32, F32)]
        self.acc = np.zeros((16, 32, 4), F32)

    def step(self, images, tiles, key0: int, keys: int, qk_scale: F32, int8: bool, fault):
        """One step of the tile loop over one or two tiles (``images`` their
        (k, v) stages): S for each (an n-tile's eight k-steps as two chains
        of four, summed), one online softmax update over all their keys,
        then P V for each."""
        nts = keys // 8
        sc = np.zeros((len(tiles), nts, 32, 4), F32)
        for u, (k_img, _) in enumerate(images):
            for nt in range(nts):
                kb = k_fragments(k_img, key0 + 8 * nt + G, int8, fault)
                low, high = np.zeros((32, 4), F32), np.zeros((32, 4), F32)
                for kk in range(4):
                    low = mma(low, self.qa[:, kk], kb[:, kk])
                    high = mma(high, self.qa[:, kk + 4], kb[:, kk + 4])
                sc[u, nt] = low + high
        alpha = []
        for r in range(2):
            for u, tile in enumerate(tiles):
                for nt in range(nts):
                    for e in range(2):
                        pos = tile * BK + key0 + 8 * nt + 2 * T + e
                        x = sc[u, nt][:, 2 * r + e]
                        sc[u, nt][:, 2 * r + e] = np.where(pos < self.limit[r], x * qk_scale, -np.inf)
            mx = quad(sc[:, :, :, 2 * r:2 * r + 2].max(axis=(0, 1, 3)), np.maximum)
            m_new = np.maximum(self.m[r], mx)
            m_use = np.where(m_new == -np.inf, F32(0), m_new)
            alpha.append(np.exp2(self.m[r] - m_use).astype(F32))
            total = np.zeros(32, F32)
            for u in range(len(tiles)):
                for nt in range(nts):
                    for e in range(2):
                        sc[u, nt][:, 2 * r + e] = np.exp2(sc[u, nt][:, 2 * r + e] - m_use)
                        total = total + sc[u, nt][:, 2 * r + e]
            self.l[r] = self.l[r] * alpha[r] + total
            self.m[r] = m_new
        self.acc[:, :, 0:2] *= alpha[0][None, :, None]
        self.acc[:, :, 2:4] *= alpha[1][None, :, None]
        for u, (_, v_img) in enumerate(images):
            for ks in range(keys // 16):
                p = np.concatenate([sc[u, 2 * ks], sc[u, 2 * ks + 1]], axis=1)  # A rows g, g+8 x keys 2t.., 2t+8..
                hi = np.stack([pack(p[:, 0], p[:, 1]), pack(p[:, 2], p[:, 3]),
                               pack(p[:, 4], p[:, 5]), pack(p[:, 6], p[:, 7])], axis=1)
                (h0, h1), (h2, h3), (h4, h5), (h6, h7) = (lo_hi(hi[:, i]) for i in range(4))
                rest = p - np.stack([h0, h1, h2, h3, h4, h5, h6, h7], axis=1)
                lo = np.stack([pack(rest[:, 0], rest[:, 1]), pack(rest[:, 2], rest[:, 3]),
                               pack(rest[:, 4], rest[:, 5]), pack(rest[:, 6], rest[:, 7])], axis=1)
                vb = v_fragments(v_img, key0 + 16 * ks, int8, fault)
                for i in range(16):
                    self.acc[i] = mma(self.acc[i], hi, vb[:, i])
                    self.acc[i] = mma(self.acc[i], lo, vb[:, i])

    def partial(self) -> tuple[np.ndarray, np.ndarray]:
        """What the warp writes to the fold area: acc in its registers'
        layout [16 n-tiles][32 lanes][4], and (m, l) per row of its group
        [16, 2] (l summed over the lanes of a quad)."""
        ml = np.zeros((16, 2), F32)
        for r in range(2):
            l = quad(self.l[r], np.add)
            ml[G[T == 0] + 8 * r, 0], ml[G[T == 0] + 8 * r, 1] = self.m[r][T == 0], l[T == 0]
        return self.acc.copy(), ml


def fold(partials: list[tuple[np.ndarray, np.ndarray]]) -> tuple[np.ndarray, np.ndarray]:
    """(acc, (m, l)) of several partials, in order: max, weights, sums. A
    lane's acc components 0, 1 are row g, 2, 3 row g + 8."""
    mx = np.max([ml[:, 0] for _, ml in partials], axis=0)
    acc, den = np.zeros_like(partials[0][0]), np.zeros(16, F32)
    rows = np.stack([G, G, G + 8, G + 8], axis=1)  # [lane, component] -> row in the group
    for part, ml in partials:
        w = np.where(mx == -np.inf, F32(0), np.exp2(ml[:, 0] - np.where(mx == -np.inf, F32(0), mx))).astype(F32)
        acc = acc + w[rows][None] * part
        den = den + w * ml[:, 1]
    return acc, np.stack([mx, den], axis=1)


def unit_outputs(acc: np.ndarray, ml: np.ndarray, out_scale: float):
    """The cluster fold's store: unit (n-tile pair ip, lane, row half hf)
    puts (acc[2 ip][2 hf], acc[2 ip + 1][2 hf]) at row g + 8 hf, d = 32 t +
    2 ip, + 1 and the components 2 hf + 1 at d + 16, + 17. Yields (row,
    d, value) with value already normalized and rounded to bf16."""
    for ip in range(8):
        for ln in range(32):
            for hf in range(2):
                rr, d = ln // 4 + 8 * hf, 32 * (ln % 4) + 2 * ip
                den = ml[rr, 1]
                inv = F32(F32(out_scale) / den) if den > 0 else F32(0)
                for dd, i, comp in ((0, 2 * ip, 2 * hf), (1, 2 * ip + 1, 2 * hf), (16, 2 * ip, 2 * hf + 1),
                                    (17, 2 * ip + 1, 2 * hf + 1)):
                    yield rr, d + dd, bf16_value(bf16_bits(acc[i, ln, comp] * inv))


def model_head(q_rows, k_head, v_head, length, width, splits, qk_scale, out_scale, int8, index=None,
               k_new=None, v_new=None, fault=None):
    """One (kv head, batch row): folded rows q_rows [R, 128] (bf16 values),
    the head's cache [S, 128] (int8 or bf16), every rank of the cluster, in
    the kernel's order. K5 (``index`` given): thread 0 copies the new rows
    into each stage they fall in from k_new/v_new, and the block's threads
    store those in its tiles to the cache. Returns out [R, 128] (bf16
    values) and the (position, chunk) -> ranks that store them (K5)."""
    nrows = q_rows.shape[0]
    parts = parts_for(nrows)
    keys, groups = BK // parts, WARPS // parts
    pass_rows = groups * GROUP_ROWS
    s_cache = k_head.shape[0]
    kbytes, vbytes = (np.ascontiguousarray(c).view(np.uint8).reshape(s_cache, -1) for c in (k_head, v_head))
    out = np.zeros((nrows, KD), F32)
    writes = {}
    for pass_ in range(-(-nrows // pass_rows)):
        ranks = []
        for rank, tiles in enumerate(decode_plan(length, width, s_cache, splits)):
            warps = [Warp(q_rows, pass_ * pass_rows + (w // parts) * GROUP_ROWS, nrows, length, width, int8)
                     for w in range(WARPS)]
            images = {}
            for tile in tiles:
                lo = tile * BK
                k_img = kbytes[lo:lo + BK].copy()
                v_img = vbytes[lo:lo + BK].copy()
                if index is not None:  # thread 0's copies: rows [a, e) of the tile from k_new/v_new
                    a = min(max(index - lo, 0), BK)
                    e = max(min(index + width - lo, BK), a)
                    k_img[a:e] = k_new.view(np.uint8).reshape(width, -1)[lo + a - index:lo + e - index]
                    v_img[a:e] = v_new.view(np.uint8).reshape(width, -1)[lo + a - index:lo + e - index]
                images[tile] = (k_img, v_img)
            pair = 2 if parts > 1 else 1  # tiles a step (kPair), then a last single one
            steps = [tiles[i:i + pair] for i in range(0, len(tiles) - len(tiles) % pair, pair)]
            steps += [tiles[i:i + 1] for i in range(len(tiles) - len(tiles) % pair, len(tiles))]
            for step in steps:
                for w, warp in enumerate(warps):
                    warp.step([images[tile] for tile in step], list(step), (w % parts) * keys, keys, qk_scale, int8,
                              fault)
            if index is not None and pass_ == 0:  # K2's write: thread c takes chunks c, c + 128, ...
                for thread in range(THREADS):
                    for c in range(thread, width * 16, THREADS):
                        pos = index + c // 16
                        if tiles.start * BK <= pos < tiles.stop * BK and pos < s_cache:
                            writes.setdefault((pos, c % 16), []).append(rank)
            partials = [warp.partial() for warp in warps]
            ranks.append([fold(partials[gl * parts:(gl + 1) * parts]) for gl in range(groups)])
        for gl in range(groups):
            acc, ml = fold([ranks[c][gl] for c in range(splits)])  # rank order
            for rr, d, value in unit_outputs(acc, ml, out_scale):
                row = pass_ * pass_rows + gl * GROUP_ROWS + rr
                if row < nrows:
                    out[row, d] = value
    return out, writes


def model(q, k_cache, v_cache, lengths, rows=None, k_scale=None, v_scale=None, splits=None, fault=None):
    """K3 on the CPU: q [B, Hq, W, 128] bf16 values (f32 array), caches
    [R, Hkv, S, 128] int8 or ml_dtypes.bfloat16 -> out f32 [B, Hq, W, 128]."""
    b, hq, width, _ = q.shape
    hkv, s_cache = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    splits = splits or decode_splits(b, hkv, s_cache)
    int8 = k_cache.dtype == np.int8
    out = np.zeros(q.shape, F32)
    for bi in range(b):
        phys = bi if rows is None else rows[bi]
        for h in range(hkv):
            ks = F32(1) if k_scale is None else k_scale[h]
            qk_scale = F32(F32(F32(1 / np.sqrt(KD)) * ks) * F32(1.4426950408889634))
            q_rows = q[bi, h * group:(h + 1) * group].reshape(group * width, KD)
            o, _ = model_head(q_rows, k_cache[phys, h], v_cache[phys, h], int(lengths[bi]), width, splits, qk_scale,
                              1.0 if v_scale is None else v_scale[h], int8, fault=fault)
            out[bi, h * group:(h + 1) * group] = o.reshape(group, width, KD)
    return out


def inputs(seed, b, hq, hkv, w, s, int8, phys=None):
    rng = np.random.default_rng(seed)
    phys = phys or b
    q = rng.standard_normal((b, hq, w, KD)).astype(ml_dtypes.bfloat16).astype(F32)
    if int8:
        k, v = (rng.integers(-127, 128, (phys, hkv, s, KD)).astype(np.int8) for _ in range(2))
        k_scale, v_scale = ((rng.random(hkv) * 0.04 + 0.02).astype(F32) for _ in range(2))
    else:
        k, v = (rng.standard_normal((phys, hkv, s, KD)).astype(ml_dtypes.bfloat16) for _ in range(2))
        k_scale = v_scale = None
    return q, k, v, k_scale, v_scale


def plain(q, k, v, lengths, rows, k_scale, v_scale) -> np.ndarray:
    """The port's plain f32 version (what the card's checks compare with)."""
    def t(x):
        return None if x is None else torch.from_numpy(np.asarray(x, F32) if x.dtype != np.int8 else x)

    out = _scaled_reference(torch.from_numpy(q), t(k), t(v), torch.tensor(lengths, dtype=torch.int32),
                            None if rows is None else torch.tensor(rows, dtype=torch.int32), t(k_scale), t(v_scale))
    return out.float().numpy()


def pallas(q, k, v, lengths, rows, k_scale, v_scale) -> np.ndarray:
    """The JAX package's Pallas kernel in interpret mode, with the int8
    scales factored out as the port does (q times k_scale, out times
    v_scale)."""
    hkv = k.shape[1]
    group = q.shape[1] // hkv
    ks = np.ones(hkv, F32) if k_scale is None else k_scale
    vs = np.ones(hkv, F32) if v_scale is None else v_scale
    out = j_dec._decode_attention_pallas(
        jnp.asarray(q * np.repeat(ks, group)[None, :, None, None]), jnp.asarray(np.asarray(k, F32)),
        jnp.asarray(np.asarray(v, F32)), jnp.asarray(np.asarray(lengths, np.int32)),
        None if rows is None else jnp.asarray(np.asarray(rows, np.int32)), interpret=True, pipelined=True)
    return np.asarray(out, F32) * np.repeat(vs, group)[None, :, None, None]


def within(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    return float(np.abs(got - want).max()), REL_TOL * float(np.abs(want).max())


def test_every_int8_value_converts_exactly():
    """All 256 bytes (the cache holds -127..127) in both converted
    positions of a register, beside other bytes, through the selectors the
    kernel uses for k (bytes 0, 1 and 2, 3) and v (byte p of two rows)."""
    values = np.arange(256, dtype=np.uint32)
    want = values.astype(np.uint8).view(np.int8).astype(F32)
    other = (values * 37 + 11) % 256
    word = values | (other << 8) | (other << 16) | (values << 24)
    for sel, lo_src, hi_src in ((0x0100, values, other), (0x0302, other, values)):
        lo, hi = lo_hi(s8_bf16x2(byte_perm(word, 0, sel)))
        np.testing.assert_array_equal(lo, lo_src.astype(np.uint8).view(np.int8).astype(F32))
        np.testing.assert_array_equal(hi, hi_src.astype(np.uint8).view(np.int8).astype(F32))
    for p in range(4):
        x, y = values << (8 * p), other << (8 * p)
        lo, hi = lo_hi(s8_bf16x2(byte_perm(x, y, p | ((4 + p) << 8))))
        np.testing.assert_array_equal(lo, want)
        np.testing.assert_array_equal(hi, other.astype(np.uint8).view(np.int8).astype(F32))
    assert np.array_equal(bf16_value(bf16_bits(want)), want)  # every int8 value is a bf16


@pytest.mark.parametrize("int8", [True, False])
def test_fragments_are_q_and_k_in_one_contraction_order(int8):
    """q's A and k's B fragments of each k-step pair the same d: the eight
    k-steps of q (rows 0-15) against keys 0-7 give q K^T exactly (integer
    values), and the k-dims cover d = 0..127 once per thread."""
    for t in range(4):
        assert len({int(k_dim(kk, t, int8)) + j for kk in range(8) for j in range(4)}) == 32
    covered = sorted(np.concatenate([[k_dim(kk, t, int8) + j for j in range(4)] for kk in range(8) for t in range(4)]))
    assert covered == list(range(KD))
    rng = np.random.default_rng(1)
    q = rng.integers(-3, 4, (16, KD)).astype(F32)
    k = rng.integers(-100, 101, (BK, KD)).astype(np.int8 if int8 else ml_dtypes.bfloat16)
    image = np.ascontiguousarray(k).view(np.uint8).reshape(BK, -1)
    warp = Warp(q, 0, 16, 10**6, 1, int8)
    kb = k_fragments(image, G, int8)
    s = np.zeros((32, 4), F32)
    for kk in range(8):
        s = mma(s, warp.qa[:, kk], kb[:, kk])  # integer values: exact in any order
    want = q @ k[:8].astype(F32).T
    got = np.zeros((16, 8), F32)
    got[G, 2 * T], got[G, 2 * T + 1], got[G + 8, 2 * T], got[G + 8, 2 * T + 1] = s.T
    np.testing.assert_array_equal(got, want)
    bad = k_fragments(image, G, int8, fault="k_rotation")
    assert not np.array_equal(bad, kb)


@pytest.mark.parametrize("int8", [True, False])
def test_v_fragments_put_column_n_of_tile_i_at_d_16n_plus_i(int8):
    rng = np.random.default_rng(2)
    v = rng.integers(-100, 101, (BK, KD)).astype(np.int8 if int8 else ml_dtypes.bfloat16)
    image = np.ascontiguousarray(v).view(np.uint8).reshape(BK, -1)
    for key in (0, 16, 48):
        vb = v_fragments(image, key, int8)
        for i in range(16):
            want = v[key:key + 16, 16 * np.arange(8) + i].astype(F32)
            np.testing.assert_array_equal(b_matrix(vb[:, i]), want)
    if not int8:
        assert not np.array_equal(v_fragments(image, 0, int8, fault="v_rotation"), v_fragments(image, 0, int8))


def test_fold_units_store_every_output_once():
    """The cluster fold's units put each (row, d) of a group once, and the
    value of acc fragment (n-tile i, lane, component) at row g (+ 8), d =
    32 t + i (+ 16): the column of output n-tile i's B fragment n is 16 n + i."""
    acc = np.zeros((16, 32, 4), F32)
    for i in range(16):
        for ln in range(32):
            for comp in range(4):  # components 0, 1: row g, columns n = 2t, 2t + 1; 2, 3: row g + 8
                row, n = ln // 4 + 8 * (comp // 2), 2 * (ln % 4) + comp % 2
                acc[i, ln, comp] = 1000 * row + 16 * n + i
    ml = np.stack([np.zeros(16, F32), np.ones(16, F32)], axis=1)
    cells = [(rr, d, float(v)) for rr, d, v in unit_outputs(acc, ml, 1.0)]
    assert sorted((rr, d) for rr, d, _ in cells) == [(r, c) for r in range(GROUP_ROWS) for c in range(KD)]
    assert all(v == bf16_value(bf16_bits(F32(1000 * rr + d))) for rr, d, v in cells)


PLAN_CASES = [  # (length, width, s_cache, splits)
    (1, 1, 64, 8),  # one position, a one-tile cache
    (1, 3, 1536, 8),  # len = 1: one tile, seven blocks without one
    (64, 1, 1536, 8),  # the extent ends on a tile edge
    (62, 3, 1536, 8),  # len + W - 1 = 64: on the edge
    (63, 3, 1536, 8),  # one position past it
    (100, 3, 1536, 8),  # fewer tiles than blocks
    (1200, 3, 1536, 8), (1351, 3, 1536, 8),  # the base smoke's lengths
    (1534, 3, 1536, 8),  # len + W - 1 = s_cache
    (1600, 3, 1536, 8),  # past the cache: clipped to it
    (2200, 3, 2560, 8), (700, 7, 1664, 4), (5, 7, 128, 2), (1000, 3, 1664, 1),
]


@pytest.mark.parametrize("length,width,s_cache,splits", PLAN_CASES)
def test_plan_covers_every_valid_tile_once(length, width, s_cache, splits):
    plan = decode_plan(length, width, s_cache, splits)
    extent = min(length + width - 1, s_cache)
    assert len(plan) == splits
    assert [tile for tiles in plan for tile in tiles] == list(range(-(-extent // BK)))  # once, in rank order
    assert all(tile * BK < extent for tiles in plan for tile in tiles)  # none past len + W - 1
    assert max(map(len, plan)) - min(map(len, plan)) <= 1  # equal shares


@pytest.mark.parametrize("batch,hkv,s_cache,want", [
    (2, 2, 1536, 8), (2, 4, 2560, 8), (8, 2, 1664, 8), (2, 1, 64, 1), (2, 2, 128, 2), (16, 4, 1536, 4),
    (64, 8, 4096, 1),
])
def test_splits_depend_on_shapes_only(batch, hkv, s_cache, want):
    splits = decode_splits(batch, hkv, s_cache)
    assert splits == want and splits & (splits - 1) == 0
    assert splits <= min(8, s_cache // BK) and (splits == 1 or batch * hkv * splits <= 264)


MODEL_CASES = [  # (hq, hkv, width, s_cache, lengths, int8)
    (8, 2, 3, 384, (1, 300), True),  # 12 rows (base), len 1 and a long row
    (8, 2, 3, 384, (64, 382), False),  # a tile edge; len + W - 1 = s_cache
    (7, 1, 3, 256, (100, 200), True),  # 21 rows (7b): two warps a group
    (8, 1, 5, 256, (130, 61), False),  # 40 rows: one warp a group, one group of padding
    (7, 1, 7, 256, (77, 190), True),  # 49 rows (speculative verify at 7b)
    (16, 1, 5, 256, (150, 9), False),  # 80 rows: two passes over the tiles
]


@pytest.mark.parametrize("hq,hkv,width,s_cache,lengths,int8", MODEL_CASES)
def test_model_matches_plain_and_pallas(hq, hkv, width, s_cache, lengths, int8):
    q, k, v, k_scale, v_scale = inputs(hq * width + s_cache, len(lengths), hq, hkv, width, s_cache, int8, phys=3)
    rows = (2, 0)
    got = model(q, k, v, lengths, rows, k_scale, v_scale)
    assert np.isfinite(got).all()
    for want in (plain(q, k, v, lengths, rows, k_scale, v_scale), pallas(q, k, v, lengths, rows, k_scale, v_scale)):
        err, tol = within(got, want)
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_fold_is_the_same_attention_for_every_split_count(splits):
    q, k, v, k_scale, v_scale = inputs(7, 2, 8, 2, 3, 512, True)
    lengths = (450, 200)
    err, tol = within(model(q, k, v, lengths, None, k_scale, v_scale, splits=splits),
                      plain(q, k, v, lengths, None, k_scale, v_scale))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("fault,int8", [("k_rotation", True), ("k_rotation", False), ("v_rotation", False)])
def test_layout_faults_fail(fault, int8):
    q, k, v, k_scale, v_scale = inputs(9, 2, 8, 2, 3, 256, int8)
    lengths = (200, 120)
    err, tol = within(model(q, k, v, lengths, None, k_scale, v_scale, fault=fault),
                      plain(q, k, v, lengths, None, k_scale, v_scale))
    assert err > tol, (fault, err, tol)


@pytest.mark.parametrize("index,width,s_cache", [
    (0, 3, 1536), (62, 3, 1536), (127, 3, 1536), (191, 7, 1536), (1533, 3, 1536), (700, 7, 1664), (60, 9, 128),
    ("split", 3, 1536), ("split", 7, 1664), ("split", 3, 384),
])
def test_fused_write_has_one_writer_a_position(index, width, s_cache):
    """K5's write rule: the block whose tile holds a new position stores
    it, chunk by chunk, once (thread c takes chunk c); across tile edges
    and, at ``split_edge_index``, across the edge between two blocks of
    decode_plan."""
    splits = decode_splits(2, 2, s_cache)
    if index == "split":
        index = split_edge_index(width, s_cache, splits)
    k_new = np.zeros((width, KD), ml_dtypes.bfloat16)
    cache = np.zeros((s_cache, KD), ml_dtypes.bfloat16)
    _, writes = model_head(np.zeros((4 * width, KD), F32), cache, cache, index + 1, width, splits, F32(1), 1.0,
                           False, index=index, k_new=k_new, v_new=k_new)
    assert set(writes) == {(pos, c) for pos in range(index, index + width) for c in range(16)}
    assert all(len(ranks) == 1 for ranks in writes.values())
    plan = decode_plan(index + 1, width, s_cache, splits)
    owners = {pos: writes[(pos, 0)][0] for pos in range(index, index + width)}
    assert all(pos // BK in plan[rank] for pos, rank in owners.items())
    if (index + width - 1) // BK != index // BK:
        assert len({pos // BK for pos in owners}) == 2


def test_split_edge_index_straddles_two_blocks():
    for width, s_cache in ((3, 1536), (3, 1664), (7, 2560), (5, 384)):
        splits = decode_splits(2, 2, s_cache)
        for start in (0, 100):
            index = split_edge_index(width, s_cache, splits, start)
            plan = decode_plan(index + 1, width, s_cache, splits)
            owner = {tile: rank for rank, tiles in enumerate(plan) for tile in tiles}
            assert index >= start and owner[index // BK] != owner[(index + width - 1) // BK]


def test_fused_stage_equals_the_written_cache():
    """K5's model on the old cache, its stages taking the new rows from
    k_new/v_new, equals K3's model on the cache K2 wrote, bit for bit, with
    the new rows across a split edge."""
    q, k, v, _, _ = inputs(11, 1, 8, 2, 3, 512, False)
    rng = np.random.default_rng(12)
    k_new, v_new = (rng.standard_normal((2, 3, KD)).astype(ml_dtypes.bfloat16) for _ in range(2))
    splits = decode_splits(1, 2, 512)
    index = split_edge_index(3, 512, splits, 200)
    qk = F32(F32(F32(1 / np.sqrt(KD))) * F32(1.4426950408889634))
    for h in range(2):
        q_rows = q[0, 4 * h:4 * h + 4].reshape(12, KD)
        fused, _ = model_head(q_rows, k[0, h], v[0, h], index + 1, 3, splits, qk, 1.0, False, index=index,
                              k_new=k_new[h], v_new=v_new[h])
        k2, v2 = k[0, h].copy(), v[0, h].copy()
        k2[index:index + 3], v2[index:index + 3] = k_new[h], v_new[h]
        split, _ = model_head(q_rows, k2, v2, index + 1, 3, splits, qk, 1.0, False)
        np.testing.assert_array_equal(fused, split)


def path_step(quantized: bool, b: int = 2, s: int = 1024, seed: int = 0) -> tuple:
    """A decode step's inputs as ``chip_smoke.path_decode_inputs`` keeps
    them: q [B, 2, 3, 128], one kv head, caches of ``s`` positions."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 2, 3, KD, generator=gen).bfloat16()
    if quantized:
        caches = [torch.randint(-127, 128, (b, 1, s, KD), generator=gen, dtype=torch.int8) for _ in range(2)]
        scales = [torch.full((1,), 0.03), torch.full((1,), 0.05)]
    else:
        caches = [torch.randn(b, 1, s, KD, generator=gen).bfloat16() for _ in range(2)]
        scales = [None, None]
    new = [torch.randn(b, 1, 3, KD, generator=gen).bfloat16() for _ in range(2)]
    index = torch.tensor([300 + i for i in range(b)], dtype=torch.int32)
    return (q, *caches, *new, index, None, *scales)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_k5", "int8_k2_k3"])
def test_path_decode_check_passes_the_plain_step_and_fails_a_shifted_one(quantized, monkeypatch):
    """The smoke's check of a main path's decode step at its own shape
    (``chip_smoke.path_decode_reading``) passes the plain versions standing
    in for the kernels and fails a step whose causal extent is one position
    short (on the path's inputs, the full extent and the causal edge)."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    reading = chip_smoke.path_decode_reading(torch.Generator().manual_seed(1), path_step(quantized))
    assert reading["kernel"] == ("K2 + K3" if quantized else "K5") and reading["cache_writes_bit_equal"]
    for key in ("path_inputs", "full_extent", "edge"):
        assert reading[f"{key}_max_abs_err"] <= reading[f"{key}_tol"], key
    assert reading["full_extent_index"][0] == 1024 - 3

    update, attend = chip_smoke.decode_attention_update, chip_smoke.decode_attention
    monkeypatch.setattr(chip_smoke, "decode_attention_update",
                        lambda q, k, v, kn, vn, index, *rest: update(q, k, v, kn, vn, index, *rest) * 0
                        + attend(q, k, v, index, *rest))
    monkeypatch.setattr(chip_smoke, "decode_attention",
                        lambda q, k, v, lengths, *rest: attend(q, k, v, lengths - 1, *rest))
    with pytest.raises(AssertionError, match="path decode step"):
        chip_smoke.path_decode_reading(torch.Generator().manual_seed(1), path_step(quantized))
