// K3: paged, length-aware decode attention over an int8 or bf16 KV cache,
// and K5: the same attention with the step's cache row write fused in.
//
// Replaces video_transformer_tpu/ops/decode_attention.py:164
// `_kernel_pipelined` (K3; and :76 `_kernel`, the same math), launched by
// _decode_attention_pallas. For q [B, Hq, W, D] against caches
// [R, Hkv, S, D] at physical row rows[b] (identity when rows is null), query
// column j sees cache positions < lengths[b] + j. The G*W query rows of a kv
// head's group fold onto that head ("folded rows"), so each cache tile is
// read once for all of them. For an int8 cache the per-head scales factor
// out: the scores take k_scale[h] and the output v_scale[h], in f32.
//
// K5 replaces :396 `_fused_kernel` of the same file (launched by
// _decode_attention_update_pallas): K2's write of the W new k/v rows at
// positions [index, index + W) of physical row rows[b], then K3 with lengths
// index + 1, in one launch (bf16 caches only, as in the JAX package).
//
// What bounds it on an H100: bytes. A decode step does 4*G*W*D operations
// per cache position against 2*D bytes (int8 k and v): 24 operations per
// byte at G*W = 12, far under the card's ~295. The least time is the valid
// prefix's bytes over 3.35 TB/s, a few microseconds at most at serving
// lengths, so latency and the number of blocks streaming decide the real
// time.
//
// Design (flash-decoding in one launch):
// - One block per (split, kv head, batch row). The splits of one (kv head,
//   batch row) are one thread-block cluster of C <= 8 blocks, C from the
//   shapes alone (ops/decode_attention.py::decode_splits). Each block reads
//   lengths[b] and takes an equal share of the valid extent's
//   ceil((len + W - 1) / 64) tiles of 64 positions (decode_plan there), so no
//   block streams empty capacity; a block without a tile joins the fold as
//   (m = -inf, l = 0). The grid depends only on shapes.
// - K/V tiles arrive by 1-D bulk copy (cp.async.bulk, complete_tx on an
//   mbarrier): a tile of one kv head is contiguous, 8 KB (int8) or 16 KB
//   (bf16) each for k and v. Thread 0 keeps a ring of full/empty mbarrier
//   stages in flight, 6 stages of 16 KB (int8) or 3 of 32 KB (bf16): it
//   fills the ring at the start and refills a stage once every warp has
//   released it. A block takes 96.1 KB of shared memory and 128 threads of
//   up to 255 registers, so two blocks share an SM (a dedicated producer
//   warp would have capped the registers at 168 and spilled). No tensor map
//   is encoded on the host.
// - Four warps run the products on the tensor cores with
//   mma.sync.m16n8k16 bf16 -> f32. A block holds every folded row of its kv
//   head: rows pad to groups of 16 (an mma's M), and the warps split into
//   C_p = 4 / groups parts per group, each part owning 64 / C_p keys of every
//   tile and its own (m, l, acc) for its group's 16 rows. One group (up to
//   16 rows: base and the batcher) gives each warp 16 keys of a tile; two
//   (17-32 rows: 7b) 32 keys; three or four (33-64 rows) all 64. Past 64
//   rows the block makes one pass over its tiles for each 64 rows (the
//   repeated passes read from L2).
// - S = q K^T takes q in bf16 as it arrives (exact) and k converted to bf16
//   in registers; every int8 value is a bf16, and the conversion is exact
//   (128 + (b & 127) from the mantissa, minus 128 or 256 by the sign bit).
//   The scale 1/sqrt(d) x k_scale[h] x log2(e) multiplies the f32
//   accumulator, never q. A thread's four contraction elements of a k-step
//   are four consecutive d (the contraction order of d is a permutation
//   shared by q and k), so a 16-byte load gives one or two k-steps; odd
//   keys load their chunks in a rotated order, which makes the k reads free
//   of bank conflicts.
// - O += P V takes P as a bf16 hi + lo pair (P_hi = bf16(P), P_lo =
//   bf16(P - P_hi)), as K1 and K7 do, and v converted exactly; v_scale[h]
//   applies in f32 at the end. Output column n of n-tile i is d = 16 n + i,
//   so a thread reads 16 consecutive d of each of its four v rows; the v
//   reads have 2-way (bf16) and 4-way (int8) bank conflicts.
// - The fold: each warp stores its acc in its registers' layout; the parts
//   of a group fold in part order, each warp over its share of the 16
//   output n-tiles; then the cluster's blocks fold through distributed
//   shared memory: each block takes a slice of the outputs and sums every
//   rank's partial in rank order, normalizes, applies v_scale and stores
//   bf16. No combine kernel, no partials in device memory, no atomics: two
//   launches give the same bits.
// - K5 is K3 on a bf16 cache plus the write; only the copies and one store
//   differ. For a tile that holds new positions thread 0 splits the copy:
//   the rows before and after them from the cache, the new rows from
//   k_new/v_new, so the stage lands with the step's rows in place and no
//   warp waits on a patch. The block's threads store the new rows that fall
//   in its tiles to the cache: each position has one writer, and no block
//   of the launch reads a position the launch writes. With lengths =
//   index + 1 the output and the cache equal K2 then K3 bit for bit (the
//   same plan, fold order and products as K3 on a bf16 cache). The TPU
//   kernel's 8-aligned read-modify-write DMA region is a Mosaic tiling
//   constraint and is not carried over.

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace {
namespace decode {

namespace cg = cooperative_groups;

constexpr int kD = 128;
constexpr int kBK = 64;                            // cache positions a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;              // four warps; thread 0 also issues the copies
constexpr int kGroupRows = 16;                     // folded q rows an mma tile holds
constexpr int kMaxSplits = 8;                      // a cluster's blocks: the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -INFINITY;

template <typename T>
struct Ring {
  static constexpr int kRowBytes = kD * (int)sizeof(T);
  static constexpr int kTileBytes = kBK * kRowBytes;            // k or v
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = sizeof(T) == 1 ? 6 : 3;
  static constexpr int kBytes = kStages * kStageBytes;          // 96 KB
  // + the full and empty barriers: 96.1 KB, two blocks an SM.
  static constexpr int kSmemBytes = kBytes + 2 * kStages * 8;
};

// The fold's shared memory reuses the ring once a pass's tiles are consumed:
// each warp's acc in its registers' layout, [warp][n-tile][lane] float4
// (stores and reads without bank conflicts), its (m, l) per row, and the
// block's (m, l) per row of the pass.
constexpr int kFoldAccFloats = kWarps * 16 * 32 * 4;
constexpr int kFoldMlFloats = kWarps * kGroupRows * 2;
constexpr int kFoldBytes = (kFoldAccFloats + 2 * kFoldMlFloats) * 4;
static_assert(kFoldBytes <= Ring<int8_t>::kBytes && kFoldBytes <= Ring<__nv_bfloat16>::kBytes, "fold fits the ring");

struct Params {
  const __nv_bfloat16* q;
  void* k_cache;
  void* v_cache;
  const void* k_new;     // K5: [B, Hkv, W, D]
  const void* v_new;
  const int* lengths;    // K3: valid positions for column 0; K5: the fill before the step
  const int* rows;       // null: identity
  const float* k_scale;  // int8 caches only
  const float* v_scale;
  __nv_bfloat16* out;
  int hq, hkv, s_cache, width;
  float scale;
};

// The tiles [first, first + count) of split `split` of `splits`: an equal
// share of the ceil((length + width - 1) / 64) tiles that hold a valid
// position (ops/decode_attention.py::decode_plan).
__device__ __forceinline__ void plan(int length, int width, int s_cache, int split, int splits, int& first,
                                     int& count) {
  const int extent = max(0, min(length + width - 1, s_cache));
  const int tiles = (extent + kBK - 1) / kBK;
  first = split * tiles / splits;
  count = (split + 1) * tiles / splits - first;
}

// The first of the four consecutive d that thread t (lane % 4) contracts in
// k-step kk, at A columns 2t, 2t + 1, 2t + 8, 2t + 9: one 16-byte chunk of
// a k row holds four k-steps' worth (int8) or two (bf16).
template <typename T>
__device__ __forceinline__ int k_dim(int kk, int t) {
  if constexpr (sizeof(T) == 1)
    return 64 * (kk / 4) + 16 * t + 4 * (kk % 4);
  else
    return 32 * (kk / 2) + 8 * t + 4 * (kk % 2);
}

// Bytes 0 and 2 of x (signed) as a bf16x2, exactly: 128 + (b & 127) is a
// bf16 with that mantissa, and subtracting 128 (b >= 0) or 256 (b < 0) in
// one fma leaves b.
__device__ __forceinline__ uint32_t s8_bf16x2(uint32_t x) {
  uint32_t m, s, out;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(m) : "r"(x), "r"(0x007F007Fu), "r"(0x43004300u));  // (a & b) | c
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(s) : "r"(x), "r"(0x00800080u), "r"(0xC300C300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(m), "r"(0x3F803F80u), "r"(s));
  return out;
}

// d (+)= A B, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of S's k-steps for key row `row` (16-byte chunks): b[kk]
// = {b0, b1}. Lanes of odd g = lane / 4 load their chunks rotated, so the
// eight lanes of a load phase hit eight distinct bank groups.
template <typename T>
__device__ __forceinline__ void k_fragments(const uint4* row, int t, int odd, uint32_t (&b)[8][2]) {
  if constexpr (sizeof(T) == 1) {
    uint4 c[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) c[i] = row[4 * (i ^ odd) + t];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 blk = odd ? c[j ^ 1] : c[j];  // d 64 j + 16 t .. + 15: k-steps 4 j .. 4 j + 3
      const uint32_t w[4] = {blk.x, blk.y, blk.z, blk.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        b[4 * j + x][0] = s8_bf16x2(__byte_perm(w[x], 0, 0x0100));  // d + 0, d + 1
        b[4 * j + x][1] = s8_bf16x2(__byte_perm(w[x], 0, 0x0302));  // d + 2, d + 3
      }
    }
  } else {
    uint4 c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = row[4 * ((i + odd) & 3) + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 blk = odd ? c[(j + 3) & 3] : c[j];  // d 32 j + 8 t .. + 7: k-steps 2 j, 2 j + 1
      b[2 * j][0] = blk.x;
      b[2 * j][1] = blk.y;
      b[2 * j + 1][0] = blk.z;
      b[2 * j + 1][1] = blk.w;
    }
  }
}

// The B fragments of P V's k-step for the tile's keys `key` .. key + 15
// (rows of sv): for output n-tile i, b[i] = {(v[key + 2t][d], v[key + 2t +
// 1][d]), (v[key + 2t + 8][d], v[key + 2t + 9][d])} at d = 16 g + i.
template <typename T>
__device__ __forceinline__ void v_fragments(const T* sv, int key, int g, int t, uint32_t (&b)[16][2]) {
  constexpr int kRowChunks = kD * (int)sizeof(T) / 16;
  const int rows[4] = {key + 2 * t, key + 2 * t + 1, key + 2 * t + 8, key + 2 * t + 9};
  if constexpr (sizeof(T) == 1) {
    uint32_t w[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 c = reinterpret_cast<const uint4*>(sv)[rows[r] * kRowChunks + g];
      w[r][0] = c.x, w[r][1] = c.y, w[r][2] = c.z, w[r][3] = c.w;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t sel = (i % 4) | ((4 + i % 4) << 8);  // byte i % 4 of x to byte 0, of y to byte 2
      b[i][0] = s8_bf16x2(__byte_perm(w[0][i / 4], w[1][i / 4], sel));
      b[i][1] = s8_bf16x2(__byte_perm(w[2][i / 4], w[3][i / 4], sel));
    }
  } else {
    // A row's 16 d are two chunks; odd t loads them in the other order (2-way conflicts, not 4).
    const int odd = t & 1;
    uint32_t w[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint4 c[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) c[hh] = reinterpret_cast<const uint4*>(sv)[rows[r] * kRowChunks + 2 * g + (hh ^ odd)];
      const uint4 lo = odd ? c[1] : c[0], hi = odd ? c[0] : c[1];
      w[r][0] = lo.x, w[r][1] = lo.y, w[r][2] = lo.z, w[r][3] = lo.w;
      w[r][4] = hi.x, w[r][5] = hi.y, w[r][6] = hi.z, w[r][7] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t sel = i % 2 ? 0x7632 : 0x5410;  // the high or low bf16 of x, then of y
      b[i][0] = __byte_perm(w[0][i / 2], w[1][i / 2], sel);
      b[i][1] = __byte_perm(w[2][i / 2], w[3][i / 2], sel);
    }
  }
}

// One block: tiles [first, first + count) of (kv head blockIdx.y, batch row
// blockIdx.z), split blockIdx.x of gridDim.x, which is the block's rank in
// its cluster. kParts: warps a 16-row group (4, 2 or 1; see the note).
template <typename T, bool kFused, int kParts>
__global__ void __launch_bounds__(kThreads, 2) decode_kernel(const Params p) {
  static_assert(!kFused || sizeof(T) == 2, "K5 takes bf16 caches");
  using R = Ring<T>;
  constexpr int kKeys = kBK / kParts;                       // keys of a tile a warp takes
  constexpr int kNT = kKeys / 8;                            // S n-tiles
  constexpr int kKS = kKeys / 16;                           // P V k-steps
  constexpr int kGroups = kWarps / kParts;                  // 16-row groups a pass
  constexpr int kPassRows = kGroups * kGroupRows;
  constexpr int kRowChunks = kD * (int)sizeof(T) / 16;      // 16-byte chunks a cache row
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBytes);
  uint64_t* empty = full + R::kStages;
  float4* fold_acc = reinterpret_cast<float4*>(smem);       // [warp][n-tile][lane]
  float* fold_ml = reinterpret_cast<float*>(smem) + kFoldAccFloats;  // [warp][16][2]
  float* block_ml = fold_ml + kFoldMlFloats;                // [kPassRows][2]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int group = p.hq / p.hkv;
  const int nrows = group * p.width;
  const int passes = (nrows + kPassRows - 1) / kPassRows;
  // K5: thread c < W * 16 holds chunk c of the step's new k and v rows, for K2's write.
  const size_t new_rows = (size_t)(b * p.hkv + h) * p.width * kRowChunks;
  uint4 k_pre = {}, v_pre = {};
  if (kFused && (int)threadIdx.x < p.width * kRowChunks) {
    k_pre = static_cast<const uint4*>(p.k_new)[new_rows + threadIdx.x];
    v_pre = static_cast<const uint4*>(p.v_new)[new_rows + threadIdx.x];
  }
  const int index = p.lengths[b];                // K5: the new rows' first position
  const int length = kFused ? index + 1 : index;
  int first, count;
  plan(length, p.width, p.s_cache, split, splits, first, count);
  const int phys = p.rows ? p.rows[b] : b;
  const size_t head = (size_t)(phys * p.hkv + h) * p.s_cache * kD;  // this head's first cache element
  T* k_head = static_cast<T*>(p.k_cache) + head;
  T* v_head = static_cast<T*>(p.v_cache) + head;
  const __nv_bfloat16* q_rows = p.q + (size_t)(b * p.hq + h * group) * p.width * kD;
  __nv_bfloat16* out_rows = p.out + (size_t)(b * p.hq + h * group) * p.width * kD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Ring iteration n holds tile `first + tile`: thread 0 waits for its stage
  // to empty and copies k and v in. K5: the tile's rows [a, e) are the
  // step's new rows, copied from k_new/v_new instead of the cache.
  auto issue = [&](int n, int tile) {
    const int s = n % R::kStages;
    if (n >= R::kStages) hopper::mbar_wait(&empty[s], ((n / R::kStages) + 1) & 1);
    hopper::mbar_expect_tx(&full[s], R::kStageBytes);
    uint8_t* stage = smem + s * R::kStageBytes;
    const int lo = (first + tile) * kBK;
    const int a = kFused ? min(max(index - lo, 0), kBK) : kBK;
    const int e = kFused ? max(min(index + p.width - lo, kBK), a) : kBK;
    const T* sources[2] = {k_head, v_head};
    const T* news[2] = {static_cast<const T*>(p.k_new), static_cast<const T*>(p.v_new)};
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      uint8_t* dst = stage + kv * R::kTileBytes;
      if (a > 0) hopper::bulk_load(dst, sources[kv] + (size_t)lo * kD, a * R::kRowBytes, &full[s]);
      if (e > a)
        hopper::bulk_load(dst + a * R::kRowBytes, news[kv] + (new_rows / kRowChunks + lo + a - index) * kD,
                          (e - a) * R::kRowBytes, &full[s]);
      if (e < kBK)
        hopper::bulk_load(dst + e * R::kRowBytes, sources[kv] + (size_t)(lo + e) * kD, (kBK - e) * R::kRowBytes,
                          &full[s]);
    }
  };

  const float qk_scale = p.scale * (p.k_scale ? p.k_scale[h] : 1.f) * kLog2e;
  const float out_scale = p.v_scale ? p.v_scale[h] : 1.f;
  const int gl = warp / kParts;                // this warp's row group in a pass
  const int part = warp % kParts;              // and its part of each tile's keys
  const int key0 = part * kKeys;

  for (int pass = 0; pass < passes; ++pass) {
    const int it0 = pass * count;  // ring iterations of the passes before
    if (threadIdx.x == 0)
      for (int it = 0; it < min(count, R::kStages); ++it) issue(it0 + it, it);
    __syncwarp();

    const int row0 = pass * kPassRows + gl * kGroupRows + g;  // this thread's folded rows row0, row0 + 8
    uint32_t qa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int d = k_dim<T>(kk, t);
      uint2 lo = {0u, 0u}, hi = {0u, 0u};
      if (row0 < nrows) lo = *reinterpret_cast<const uint2*>(q_rows + (size_t)row0 * kD + d);
      if (row0 + 8 < nrows) hi = *reinterpret_cast<const uint2*>(q_rows + (size_t)(row0 + 8) * kD + d);
      qa[kk][0] = lo.x, qa[kk][1] = hi.x, qa[kk][2] = lo.y, qa[kk][3] = hi.y;
    }
    if (kFused && pass == 0) {
      // K2's write: the new rows that fall in this block's tiles, to the cache (their only writer; no
      // block of the launch reads them from the cache).
      for (int c = threadIdx.x; c < p.width * kRowChunks; c += kThreads) {
        const int pos = index + c / kRowChunks;
        if (pos < first * kBK || pos >= (first + count) * kBK || pos >= p.s_cache) continue;
        const bool mine = c == (int)threadIdx.x;
        const size_t at = (size_t)pos * kRowChunks + c % kRowChunks;
        reinterpret_cast<uint4*>(k_head)[at] = mine ? k_pre : static_cast<const uint4*>(p.k_new)[new_rows + c];
        reinterpret_cast<uint4*>(v_head)[at] = mine ? v_pre : static_cast<const uint4*>(p.v_new)[new_rows + c];
      }
    }
    const int limit[2] = {length + row0 % p.width, length + (row0 + 8) % p.width};
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    // kTiles tiles (ring iterations it0 + it ..): S for each, one online
    // softmax update over all their keys, then P V for each. Two tiles an
    // iteration double the independent products a warp has in flight.
    auto step = [&](int it, auto tiles_c) {
      constexpr int kTiles = decltype(tiles_c)::value;
      const T* sk[kTiles];
      float sc[kTiles][kNT][4];
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        const int n = it0 + it + u;
        hopper::mbar_wait(&full[n % R::kStages], (n / R::kStages) & 1);
        sk[u] = reinterpret_cast<const T*>(smem + (n % R::kStages) * R::kStageBytes);
        // S = q K^T over this warp's keys, two n-tiles at a time, each as two
        // chains of four k-steps.
#pragma unroll
        for (int nt = 0; nt < kNT; nt += 2) {
          uint32_t kb[2][8][2];
          float hi_half[2][4];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const uint4* row = reinterpret_cast<const uint4*>(sk[u]) + (key0 + 8 * (nt + v) + g) * kRowChunks;
            k_fragments<T>(row, t, g & 1, kb[v]);
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[u][nt + v][c] = hi_half[v][c] = 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma(sc[u][nt], qa[kk], kb[0][kk][0], kb[0][kk][1]);
            mma(sc[u][nt + 1], qa[kk], kb[1][kk][0], kb[1][kk][1]);
            mma(hi_half[0], qa[kk + 4], kb[0][kk + 4][0], kb[0][kk + 4][1]);
            mma(hi_half[1], qa[kk + 4], kb[1][kk + 4][0], kb[1][kk + 4][1]);
          }
#pragma unroll
          for (int v = 0; v < 2; ++v) {
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[u][nt + v][c] += hi_half[v][c];
          }
        }
      }

      // Online softmax in base 2; a thread holds rows g and g + 8, keys 8 nt + 2t, + 1.
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kTiles; ++u) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int pos = (first + it + u) * kBK + key0 + 8 * nt + 2 * t + e;
              float& x = sc[u][nt][2 * r + e];
              x = pos < limit[r] ? x * qk_scale : kNegInf;
              mx = fmaxf(mx, x);
            }
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == kNegInf ? 0.f : m_new;
        alpha[r] = hopper::ex2(m[r] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kTiles; ++u) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[u][nt][2 * r + e];
              x = hopper::ex2(x - m_use);
              sum += x;
            }
          }
        }
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc[i][0] *= alpha[0], acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1], acc[i][3] *= alpha[1];
      }

      // O += (P_hi + P_lo) V, 16 keys a k-step.
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        const T* sv = sk[u] + kBK * kD;
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int v = 0; v < 2; ++v) {  // A registers {0, 1} from n-tile 2 ks, {2, 3} from 2 ks + 1
            const float* x = sc[u][2 * ks + v];
            const __nv_bfloat162 h0 = __floats2bfloat162_rn(x[0], x[1]);
            const __nv_bfloat162 h1 = __floats2bfloat162_rn(x[2], x[3]);
            hi[2 * v] = hopper::bf16x2_bits(h0);
            hi[2 * v + 1] = hopper::bf16x2_bits(h1);
            lo[2 * v] = hopper::bf16x2_bits(__floats2bfloat162_rn(x[0] - __low2float(h0), x[1] - __high2float(h0)));
            lo[2 * v + 1] =
                hopper::bf16x2_bits(__floats2bfloat162_rn(x[2] - __low2float(h1), x[3] - __high2float(h1)));
          }
          uint32_t vb[16][2];
          v_fragments<T>(sv, key0 + 16 * ks, g, t, vb);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            mma(acc[i], hi, vb[i][0], vb[i][1]);
            mma(acc[i], lo, vb[i][0], vb[i][1]);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        const int n = it0 + it + u;
        if (lane == 0) hopper::mbar_arrive(&empty[n % R::kStages]);
        if (threadIdx.x == 0 && it + u + R::kStages < count) issue(n + R::kStages, it + u + R::kStages);
      }
      __syncwarp();
    };
    constexpr int kPair = kParts > 1 ? 2 : 1;  // a warp with all 64 keys of a tile has no registers for two
    int it = 0;
    for (; it + kPair <= count; it += kPair) step(it, std::integral_constant<int, kPair>());
    if (it < count) step(it, std::integral_constant<int, 1>());

    // The fold. Each warp's (m, l, acc) goes to the fold area (the ring, once every warp is done with
    // it); the parts of a group fold in part order, each warp over its share of the 16 n-tiles, into
    // part 0's slot.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) fold_acc[(warp * 16 + i) * 32 + lane] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (t == 0) {
      float* ml = fold_ml + warp * kGroupRows * 2;
      ml[2 * g] = m[0], ml[2 * g + 1] = l[0];
      ml[2 * (g + 8)] = m[1], ml[2 * (g + 8) + 1] = l[1];
    }
    __syncthreads();
    {
      float w[kParts][2], mx[2], den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = kNegInf;
#pragma unroll
        for (int q = 0; q < kParts; ++q) mx[r] = fmaxf(mx[r], fold_ml[((gl * kParts + q) * kGroupRows + g + 8 * r) * 2]);
        den[r] = 0.f;
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          const float* ml = fold_ml + ((gl * kParts + q) * kGroupRows + g + 8 * r) * 2;
          w[q][r] = mx[r] == kNegInf ? 0.f : hopper::ex2(ml[0] - mx[r]);
          den[r] += w[q][r] * ml[1];
        }
      }
      if constexpr (kParts > 1) {
        constexpr int kShare = 16 / kParts;  // n-tiles this warp folds
#pragma unroll
        for (int j = 0; j < kShare; ++j) {
          const int i = part * kShare + j;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int q = 0; q < kParts; ++q) {
            const float4 a = fold_acc[((gl * kParts + q) * 16 + i) * 32 + lane];
            sum.x += w[q][0] * a.x, sum.y += w[q][0] * a.y;
            sum.z += w[q][1] * a.z, sum.w += w[q][1] * a.w;
          }
          // Every part's n-tile i is read by this thread alone: the store into part 0's slot is safe.
          fold_acc[(gl * kParts * 16 + i) * 32 + lane] = sum;
        }
      }
      if (part == 0 && t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          block_ml[(gl * kGroupRows + g + 8 * r) * 2] = mx[r];
          block_ml[(gl * kGroupRows + g + 8 * r) * 2 + 1] = den[r];
        }
      }
    }
    if (splits > 1)
      cluster.sync();  // every block's partial is in place
    else
      __syncthreads();

    // The cluster's fold: this block takes a slice of the pass's outputs,
    // units of (group, n-tile pair, lane, row half), and sums the ranks'
    // partials in rank order. Unit (i-pair ip, lane, hf) holds row g + 8 hf,
    // d = 32 t + 2 ip, + 1 and 32 t + 16 + 2 ip, + 1.
    const int units = kGroups * 8 * 32 * 2;
    const int end = (split + 1) * units / splits;
    for (int x = split * units / splits + threadIdx.x; x < end; x += kThreads) {
      const int ug = x / 512;
      const int ip = (x / 64) % 8;
      const int ln = (x / 2) % 32;
      const int hf = x % 2;
      const int rr = ln / 4 + 8 * hf;
      const int row = pass * kPassRows + ug * kGroupRows + rr;
      if (row >= nrows) continue;
      const int slot = (ug * kParts * 16 + 2 * ip) * 32 + ln;  // float4 index of n-tile 2 ip in part 0's slot
      float mq[kMaxSplits], lq[kMaxSplits];
      float2 a0[kMaxSplits], a1[kMaxSplits];
      float mx = kNegInf;
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q) {  // every rank's values loaded first, so the loads overlap
        if (q < splits) {
          const float* part_q = cluster.map_shared_rank(reinterpret_cast<float*>(smem), q);
          const float2 ml = *reinterpret_cast<const float2*>(part_q + kFoldAccFloats + kFoldMlFloats +
                                                            (ug * kGroupRows + rr) * 2);
          mq[q] = ml.x;
          lq[q] = ml.y;
          a0[q] = reinterpret_cast<const float2*>(part_q)[2 * slot + hf];
          a1[q] = reinterpret_cast<const float2*>(part_q)[2 * (slot + 32) + hf];
          mx = fmaxf(mx, mq[q]);
        }
      }
      float s0x = 0.f, s0y = 0.f, s1x = 0.f, s1y = 0.f, den = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSplits; ++q) {
        if (q < splits) {
          const float w = mx == kNegInf ? 0.f : hopper::ex2(mq[q] - mx);
          s0x += w * a0[q].x, s0y += w * a0[q].y;
          s1x += w * a1[q].x, s1y += w * a1[q].y;
          den += w * lq[q];
        }
      }
      const float inv = den > 0.f ? out_scale / den : 0.f;
      __nv_bfloat16* o = out_rows + (size_t)row * kD + 32 * (ln % 4) + 2 * ip;
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(s0x * inv, s1x * inv);
      *reinterpret_cast<__nv_bfloat162*>(o + 16) = __floats2bfloat162_rn(s0y * inv, s1y * inv);
    }
    // Before the ring refills (the next pass) or a block leaves, every block's reads of this one are
    // done: their values are stored, so a relaxed arrive suffices, as in K6.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (splits > 1)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
    else
      __syncthreads();
  }
}

// Launch on `stream` as a grid of (splits, Hkv, B) blocks in clusters of
// `splits`. The shared-memory opt-in is set once per process and
// instantiation.
template <typename T, bool kFused, int kParts>
int launch(const Params& p, int batch, int splits, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      decode_kernel<T, kFused, kParts>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, p.hkv, batch);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Ring<T>::kSmemBytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, decode_kernel<T, kFused, kParts>, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The instantiation for the folded rows: 16 or fewer take four warps a
// group, 17-32 two, more one.
template <typename T, bool kFused>
int dispatch(const Params& p, int batch, int splits, cudaStream_t stream) {
  const int nrows = p.hq / p.hkv * p.width;
  if (nrows <= kGroupRows) return launch<T, kFused, 4>(p, batch, splits, stream);
  if (nrows <= 2 * kGroupRows) return launch<T, kFused, 2>(p, batch, splits, stream);
  return launch<T, kFused, 1>(p, batch, splits, stream);
}

bool valid_shape(int batch, int hq, int hkv, int s_cache, int width, int d, int splits) {
  return batch > 0 && batch <= 65535 && hkv > 0 && hkv <= 65535 && d == kD && hq % hkv == 0 && width > 0 &&
         s_cache > 0 && s_cache % kBK == 0 && splits > 0 && splits <= kMaxSplits;
}

}  // namespace decode
}  // namespace

// K3. q bf16 [B, Hq, W, 128], caches [R, Hkv, S, 128] int8 or bf16 (S a
// multiple of 64), out bf16 like q; all 16-byte aligned. `splits` blocks a
// (kv head, batch row), 1-8 (a cluster).
extern "C" int vtx_decode_attention(const void* q, const void* k_cache, const void* v_cache, const void* lengths,
                                    const void* rows, const void* k_scale, const void* v_scale, void* out,
                                    int batch, int hq, int hkv, int s_cache, int width, int d, int splits,
                                    int cache_is_int8, float scale, void* stream) {
  using namespace decode;
  if (!valid_shape(batch, hq, hkv, s_cache, width, d, splits)) return (int)cudaErrorInvalidValue;
  // K3 only reads the caches; the kernel's pointers are non-const for K5.
  const Params p = {static_cast<const __nv_bfloat16*>(q), const_cast<void*>(k_cache), const_cast<void*>(v_cache),
                    nullptr, nullptr, static_cast<const int*>(lengths), static_cast<const int*>(rows),
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<__nv_bfloat16*>(out), hq, hkv, s_cache, width, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  return cache_is_int8 ? dispatch<int8_t, false>(p, batch, splits, s)
                       : dispatch<__nv_bfloat16, false>(p, batch, splits, s);
}

// K5 on bf16 caches: ``index`` [B] is each row's fill before the step;
// k_new/v_new bf16 [B, Hkv, W, 128].
extern "C" int vtx_decode_attention_update(const void* q, void* k_cache, void* v_cache, const void* k_new,
                                           const void* v_new, const void* index, const void* rows, void* out,
                                           int batch, int hq, int hkv, int s_cache, int width, int d, int splits,
                                           float scale, void* stream) {
  using namespace decode;
  if (!valid_shape(batch, hq, hkv, s_cache, width, d, splits)) return (int)cudaErrorInvalidValue;
  const Params p = {static_cast<const __nv_bfloat16*>(q), k_cache, v_cache, k_new, v_new,
                    static_cast<const int*>(index), static_cast<const int*>(rows), nullptr, nullptr,
                    static_cast<__nv_bfloat16*>(out), hq, hkv, s_cache, width, scale};
  return dispatch<__nv_bfloat16, true>(p, batch, splits, (cudaStream_t)stream);
}
