// Flash-attention forward shared by K1 (csrc/flash_attention.cu) and K7a
// (csrc/flash_bwd.cu): bf16 in and out, f32 online softmax, and with
// kLse = true also LSE = m + log(l) per query row in f32, the residual the
// backward kernels recompute the probabilities from.
//
// softmax(Q K^T / sqrt(d) + mask) V for q [B, Hq, Sq, d] against k/v
// [B, Hkv, Sk, d], d = 128 or (K1 only) 80, GQA head h -> h / (Hq / Hkv), causal mask aligned to
// the last Sq keys (q_offset = Sk - Sq; K7a takes Sq == Sk, so its mask has
// no offset), key tiles wholly above the causal edge skipped.
//
// Head_dim 80 (the Qwen2-VL vision tower's) runs the d = 128 tiles
// unchanged: the tensor maps give the rows an inner extent of 80, so TMA
// fills columns 80-127 of every q, k and v tile with zeros. Zero columns
// add nothing to Q K^T and give zero columns of O, which the epilogue does
// not store; the scale the caller passes is 1/sqrt(80). No copy is made,
// at the price of 128/80 of the tensor-core work.
//
// What bounds it on an H100: at the main paths' shapes (S = 1024-3072,
// D = 128) attention does S/4 to S/2 operations per byte of q/k/v/o
// (causal or not, more with GQA), so the tensor cores (989 TF/s in bf16)
// set the bound at every one of them, not the 3.35 TB/s of HBM.
//
// Design, for Hopper's tensor cores and copy engine (the building blocks are in
// hopper.cuh):
// - One block per (q head, batch, 128-row q tile): two consumer warpgroups
//   of 64 q rows each and one producer warpgroup, 384 threads, ~161 KB of
//   dynamic shared memory, so one block per SM. The producer hands its
//   registers to the consumers (setmaxnreg: 24 for it, 240 for them; a
//   block starts at 168 a thread). Causal q tiles launch longest first (the
//   tile index is the grid's slowest dimension, reversed), so the short
//   ones fill the tail.
// - One thread of the producer loads the q tile once and k/v tiles of 128
//   keys into a ring of two stages by TMA (cp.async.bulk.tensor on 3-D maps
//   [B*H, S, 128] built on the host; rows past S arrive as zeros, never as
//   the next head's rows). A tile is two 64-column boxes, because a
//   128-byte swizzle row holds 64 bf16. mbarriers carry "full" (TMA bytes
//   landed) and "empty" (both warpgroups done) for k and for v of each
//   stage: k's buffer is released once S has landed, v's once P V has, so
//   the next tiles are in flight while this one is computed.
// - S = Q K^T is wgmma m64n128k16 with both operands read from shared
//   memory (K-major, 128-byte swizzle), 8 k-steps over d = 128.
// - The online softmax runs on the accumulator's layout: a thread holds two
//   rows (16 w + lane/4 and + 8) of 32 columns each (8 j + 2 (lane % 4)
//   and + 1), so a row max is two shuffles within a quad; the row sum stays
//   per thread until the end. Exponentials are exp2 with the scale folded
//   in. Masks apply only on tiles that cross the causal edge or Sk.
// - O += P V is wgmma with P in registers (the accumulator's layout is the
//   A fragment's, no shuffles) and V read from shared memory as the MN-major
//   operand (the transpose-B immediate). P is split into bf16 P_hi = bf16(P)
//   and P_lo = bf16(P - P_hi), two products into the same accumulator:
//   P's error falls from up to 2^-8 to up to 2^-16 of P, which keeps O
//   within the element-wise limit that the f32-P plain versions are held
//   to, where bf16 P alone misses it several times over wherever |O| is
//   small (tests/test_torch_flash_numerics.py). The split costs 1.5x the
//   tensor-core work of bf16 P.
// - Within a warpgroup, S_{j+1} = Q K_{j+1}^T and O += P_j V_j are issued
//   back to back; the softmax of S_{j+1} runs while P_j V_j is still in
//   flight, and O is rescaled by the new max once it has landed (FA3's
//   intra-warpgroup overlap). O, S and both halves of P are live at once:
//   192 of the consumers' 240 registers.

#pragma once

#include "hopper.cuh"

namespace {
namespace flash_fwd {
using namespace hopper;

constexpr int kBM = 128;                   // q rows a block (2 warpgroups x 64)
constexpr int kBN = 128;                   // keys a tile
constexpr int kStages = 2;                 // k/v ring depth
constexpr int kTileBytes = kBN * kD * 2;   // a q, k or v tile: 32 KB
constexpr int kHalfBytes = kTileBytes / 2; // one 64-column box
static_assert(kBM == kBN, "q, k and v tiles share one size and one box");

struct Smem {  // each tile sits on a 1024-byte boundary (the swizzle atom)
  uint8_t q[kTileBytes];
  uint8_t k[kStages][kTileBytes];
  uint8_t v[kStages][kTileBytes];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;  // slack to align the base

// -- the consumer's steps ----------------------------------------------------------

// S = Q K^T for the warpgroup's 64 rows against one key tile: 8 k-steps of
// 16 over d = 128, the first 4 in each 64-column half. Issued and committed
// as one group; the caller fences and waits.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(sc, kmajor_desc(q_addr, kk, kHalfBytes), kmajor_desc(k_addr, kk, kHalfBytes), kk > 0);
  wgmma_commit();
}

// The online softmax of one score tile on the accumulator's layout
// (element i: row 8 * ((i / 2) % 2) past this thread's first, key
// 8 * (i / 4) + col0 + i % 2 of the tile). Masks keys at or past sk and, if
// causal, past the row's position (q_pos0 for the first row); updates the
// running max m and this thread's row sums l; leaves p = exp2(logit - max)
// in sc and the factor that rescales O in alpha.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             bool masked, int k0, int sk, int causal, int q_pos0, int col0,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int k_pos = k0 + 8 * (i / 4) + col0 + (i % 2);
      if (k_pos >= sk || (causal && k_pos > q_pos0 + 8 * ((i / 2) % 2))) sc[i] = -INFINITY;
    }
  }
  float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) row_max[(i / 2) % 2] = fmaxf(row_max[(i / 2) % 2], sc[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
    row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
    const float m_new = fmaxf(m[r], row_max[r] * scale_log2);
    alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[r] - m_new);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], scale_log2, -m_use[(i / 2) % 2]));
    l[(i / 2) % 2] += sc[i];
  }
}

// -- the kernel ------------------------------------------------------------------

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int sq, int sk, int d, int causal,
                     float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // longest causal tiles first
  const int q_bh = batch * hq + head;
  const int kv_bh = batch * hkv + head / (hq / hkv);
  const int q_offset = sk - sq;
  int num_tiles = (sk + kBN - 1) / kBN;
  if (causal) num_tiles = min(num_tiles, (q_offset + min(q0 + kBM, sq) - 1) / kBN + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers);
      mbar_init(&sm.v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
      tma_load(sm.q, &q_map, &sm.q_full, 0, q0, q_bh);
      tma_load(sm.q + kHalfBytes, &q_map, &sm.q_full, kHalf, q0, q_bh);
      for (int t = 0; t < num_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t released = ((t / kStages) + 1) & 1;  // use t / kStages - 1 of the stage is done
        if (t >= kStages) mbar_wait(&sm.k_empty[s], released);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load(sm.k[s], &k_map, &sm.k_full[s], 0, t * kBN, kv_bh);
        tma_load(sm.k[s] + kHalfBytes, &k_map, &sm.k_full[s], kHalf, t * kBN, kv_bh);
        if (t >= kStages) mbar_wait(&sm.v_empty[s], released);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load(sm.v[s], &v_map, &sm.v_full[s], 0, t * kBN, kv_bh);
        tma_load(sm.v[s] + kHalfBytes, &v_map, &sm.v_full[s], kHalf, t * kBN, kv_bh);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 q rows. This thread's rows are row0 and
  // row0 + 8 (in q), its columns 8 j + col0 and + 1 of every tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sm.q) + wg * 64 * 128;  // 64 rows of 128 bytes into each half

  const int q_pos0 = q_offset + row0;  // the key position row0 sees last
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled logits, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the running row sums
  float sc[64], alpha[2];
  uint32_t p_hi[32], p_lo[32];
  // A tile crosses an edge when it reaches past Sk or past the causal edge of
  // the block's first row; only those are masked.
  auto crosses = [&](int k0) { return k0 + kBN > sk || (causal && k0 + kBN - 1 > q_offset + q0); };

  // Tile 0: S, softmax, split. Then for each tile t: S_t is issued, then
  // O += P_{t-1} V_{t-1}; the softmax of S_t runs while that product is in
  // flight, and O is rescaled once it has landed.
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.k_full[0], 0);
  wgmma_fence();
  issue_scores(sc, q_addr, smem_u32(sm.k[0]));
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(&sm.k_empty[0]);
  softmax_tile(sc, m, l, alpha, crosses(0), 0, sk, causal, q_pos0, col0, scale_log2);
  split_hi_lo(sc, p_hi, p_lo);
  for (int t = 1; t < num_tiles; ++t) {
    const int s = t % kStages;
    const int prev = (t - 1) % kStages;
    mbar_wait(&sm.k_full[s], (t / kStages) & 1);
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    issue_scores(sc, q_addr, smem_u32(sm.k[s]));
    mbar_wait(&sm.v_full[prev], ((t - 1) / kStages) & 1);
    issue_split_product<kBN / 16>(acc, p_hi, p_lo, smem_u32(sm.v[prev]), kHalfBytes);  // O += P V
    wgmma_wait<1>();  // S_t has landed; P_{t-1} V_{t-1} may still run
    fence_regs(sc);
    mbar_arrive(&sm.k_empty[s]);
    softmax_tile(sc, m, l, alpha, crosses(t * kBN), t * kBN, sk, causal, q_pos0, col0, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.v_empty[prev]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i / 2) % 2];
    split_hi_lo(sc, p_hi, p_lo);
  }
  const int last = (num_tiles - 1) % kStages;
  mbar_wait(&sm.v_full[last], ((num_tiles - 1) / kStages) & 1);
  fence_regs(acc);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  issue_split_product<kBN / 16>(acc, p_hi, p_lo, smem_u32(sm.v[last]), kHalfBytes);
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float safe_l = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / safe_l;
    __nv_bfloat16* out = o + ((size_t)q_bh * sq + row) * d + col0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      if (8 * j < d)  // columns past d are the zero padding
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if constexpr (kLse) {
      if (lane % 4 == 0) lse[(size_t)q_bh * sq + row] = m[r] * 0.69314718055994531f + logf(safe_l);
    }
  }
}

// -- host side -------------------------------------------------------------------

// Launch the forward on `stream`; `lse` is written only when kLse is true.
// `d` is the head_dim of q, k, v and out (a multiple of 8, at most 128).
// The shared-memory opt-in is set once per process and instantiation.
template <bool kLse>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int hq,
                     int hkv, int sq, int sk, int d, int causal, float scale, void* stream) {
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(flash_fwd_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (d <= 0 || d > kD || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (!encode_map(&q_map, q, batch * hq, sq, kBM, d) || !encode_map(&k_map, k, batch * hkv, sk, kBN, d) ||
      !encode_map(&v_map, v, batch * hkv, sk, kBN, d))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, batch, (sq + kBM - 1) / kBM);
  flash_fwd_kernel<kLse><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, lse, hq, hkv, sq, sk, d, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace flash_fwd
}  // namespace
