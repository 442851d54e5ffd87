// Flash-attention forward shared by K1 (csrc/flash_attention.cu) and K7a
// (csrc/flash_bwd.cu): bf16 in and out, f32 online softmax, and with
// kLse = true also LSE = m + log(l) per query row in f32, the residual the
// backward kernels recompute the probabilities from.
//
// softmax(Q K^T / sqrt(d) + mask) V for q [B, Hq, Sq, 128] against k/v
// [B, Hkv, Sk, 128], GQA head h -> h / (Hq / Hkv), causal mask aligned to
// the last Sq keys (q_offset = Sk - Sq; K7a takes Sq == Sk, so its mask has
// no offset), key tiles wholly above the causal edge skipped.
//
// What bounds it on an H100: at the main paths' shapes (S = 1024-3072,
// D = 128) attention does S/4 to S/2 operations per byte of q/k/v/o
// (causal or not, more with GQA), so the tensor cores (989 TF/s in bf16)
// set the bound at every one of them, not the 3.35 TB/s of HBM.
//
// Design, for Hopper's tensor cores and copy engine:
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

#include <cuda.h>  // CUtensorMap and its enums (header only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace flash_fwd {

constexpr int kD = 128;                    // head_dim
constexpr int kBM = 128;                   // q rows a block (2 warpgroups x 64)
constexpr int kBN = 128;                   // keys a tile
constexpr int kStages = 2;                 // k/v ring depth
constexpr int kHalf = 64;                  // bf16 columns a 128-byte swizzle row holds
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128; // and one producer warpgroup
constexpr int kProducerRegs = 24;          // setmaxnreg: the producer gives registers
constexpr int kConsumerRegs = 240;         // to the consumers (24 + 2 x 240 <= 3 x 168)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box [1, rows, 64] at (column c0, row c1, head c2) into shared `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma -----------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; MN-major: between 64-column halves) and a
// stride of 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
// Wait until at most N committed groups of this warpgroup are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers in place across the wgmma fences: the compiler may not move
// their reads or writes past this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define VTX_ACC8(i)                                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define VTX_ACC64 \
  VTX_ACC8(0), VTX_ACC8(8), VTX_ACC8(16), VTX_ACC8(24), VTX_ACC8(32), VTX_ACC8(40), VTX_ACC8(48), VTX_ACC8(56)
#define VTX_REGS64                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B for a 64 x 128 f32 tile, k = 16; A and B K-major in shared
// memory. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VTX_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VTX_ACC64
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B for a 64 x 128 f32 tile, k = 16; A (bf16x2) in registers, B
// MN-major in shared memory (transpose-B).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VTX_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : VTX_ACC64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef VTX_ACC8
#undef VTX_ACC64
#undef VTX_REGS64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

// -- the consumer's steps ----------------------------------------------------------

// S = Q K^T for the warpgroup's 64 rows against one key tile: 8 k-steps of
// 16 over d = 128, the first 4 in each 64-column half. Issued and committed
// as one group; the caller fences and waits.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_addr + off, 16), sw128_desc(k_addr + off, 16), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V over one tile of 128 keys, 16 keys (16 rows of 128
// bytes) a step. Issued and committed as one group.
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&p_hi)[32], const uint32_t (&p_lo)[32],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t b = sw128_desc(v_addr + kk * 16 * 128, kHalfBytes);
    wgmma_rs_tb(acc, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3], b);
    wgmma_rs_tb(acc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3], b);
  }
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

// P as the A fragments of the P V products: P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), pairs of neighbouring columns in each register.
__device__ __forceinline__ void split_p(const float (&p)[64], uint32_t (&p_hi)[32], uint32_t (&p_lo)[32]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[i], p[i + 1]);
    p_hi[i / 2] = bf16x2_bits(hi);
    p_lo[i / 2] = bf16x2_bits(__floats2bfloat162_rn(p[i] - __low2float(hi), p[i + 1] - __high2float(hi)));
  }
}

// -- the kernel ------------------------------------------------------------------

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int sq, int sk, int causal, float scale_log2) {
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
  split_p(sc, p_hi, p_lo);
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
    issue_pv(acc, p_hi, p_lo, smem_u32(sm.v[prev]));
    wgmma_wait<1>();  // S_t has landed; P_{t-1} V_{t-1} may still run
    fence_regs(sc);
    mbar_arrive(&sm.k_empty[s]);
    softmax_tile(sc, m, l, alpha, crosses(t * kBN), t * kBN, sk, causal, q_pos0, col0, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.v_empty[prev]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i / 2) % 2];
    split_p(sc, p_hi, p_lo);
  }
  const int last = (num_tiles - 1) % kStages;
  mbar_wait(&sm.v_full[last], ((num_tiles - 1) / kStages) & 1);
  fence_regs(acc);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  issue_pv(acc, p_hi, p_lo, smem_u32(sm.v[last]));
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
    __nv_bfloat16* out = o + ((size_t)q_bh * sq + row) * kD + col0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if constexpr (kLse) {
      if (lane % 4 == 0) lse[(size_t)q_bh * sq + row] = m[r] * 0.69314718055994531f + logf(safe_l);
    }
  }
}

// -- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once per process through the runtime's
// entry-point query (libcuda is already loaded; no -lcuda at link time).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 3-D map over [heads, s, 128] bf16 (heads = B * H), box [1, kBN, 64],
// 128-byte swizzle; rows past s read as zeros.
inline bool encode_map(CUtensorMap* map, const void* base, int heads, int s) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)s * kD * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)kHalf, (cuuint32_t)kBN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the forward on `stream`; `lse` is written only when kLse is true.
// The shared-memory opt-in is set once per process and instantiation.
template <bool kLse>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int hq,
                     int hkv, int sq, int sk, int causal, float scale, void* stream) {
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(flash_fwd_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, batch * hq, sq) || !encode_map(&k_map, k, batch * hkv, sk) ||
      !encode_map(&v_map, v, batch * hkv, sk))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, batch, (sq + kBM - 1) / kBM);
  flash_fwd_kernel<kLse><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, lse, hq, hkv, sq, sk, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace flash_fwd
}  // namespace
