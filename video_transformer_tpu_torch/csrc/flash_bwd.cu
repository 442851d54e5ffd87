// K7a-c: the flash-attention training kernels, bf16 in, f32 accumulation.
//
// Replaces video_transformer_tpu/ops/flash_bwd.py: _fwd_lse_kernel (K7a),
// _bwd_dq_kernel (K7b) and _bwd_dkv_kernel (K7c), the FlashAttention-2
// recipe. The forward saves only O and LSE; the backward recomputes the
// probabilities tile by tile:
//
//   P  = exp(Q K^T * scale - LSE)       dV = P^T dO
//   dP = dO V^T                         dS = P * (dP - D) * scale
//   dQ = dS K                           dK = dS^T Q
//
// with D = rowsum(dO * O) computed by the caller. Sq == Sk, a multiple of
// 128; the causal mask has no offset (key j is visible to query i iff
// j <= i), and tiles wholly above the diagonal are skipped on both sides:
// K7b stops its key loop at the diagonal, K7c starts its query loop there.
//
// What bounds them on an H100: at the training shapes (S = 1024 and 3072,
// D = 128) they are compute-bound, like K1: per (batch, head) and visible
// (query, key) pair K7a does 4*D operations, K7b 6*D and K7c 8*D, against
// O(S*D) bytes. So every product runs on the tensor cores, with the
// building blocks of hopper.cuh:
// - K7a is K1's kernel (flash_fwd.cuh) with the LSE store switched on.
// - K7b and K7c follow its shape: a producer warpgroup, one thread of which
//   issues every TMA copy into a ring of kStages stages (mbarriers "full"
//   and "empty" a stage), and two consumer warpgroups of 64 rows each that
//   run wgmma (setmaxnreg: 24 registers for the producer, 240 for them);
//   384 threads and ~161 KB of shared memory a block, one block an SM.
// - K7b, one block per (128-row q tile, q head, batch), last q tiles first
//   (the longest under causal masking): the Q and dO tiles are loaded once
//   and 64-key K/V tiles stream. A warpgroup computes S = Q K^T and
//   dP = dO V^T (wgmma m64n64, both operands K-major in shared memory), then
//   in registers P = exp2(S scale log2e - LSE log2e) and
//   dS = P (dP - D) scale with its rows' LSE and D, then dQ += dS K with dS
//   in registers and K read as the MN-major operand, as the forward reads
//   V. dQ is stored once, in bf16. S, dP, dQ and dS's two halves hold 160
//   registers, so S_{t+1} and dP_{t+1} are issued while dQ_t still runs.
// - K7c, one block per (128-key tile, q head, batch), first key tiles first:
//   the K and V tiles are loaded once; 64-query Q/dO tiles stream with their
//   LSE and D (256 bytes each, a 1-D bulk copy on the same mbarrier). A
//   warpgroup computes the transposed tiles S^T = K Q^T and dP^T = V dO^T
//   (K and V the A operand, Q and dO the K-major B operand), P^T and dS^T
//   in registers with LSE and D read per column from shared memory, then
//   dV += P^T dO and dK += dS^T Q with Q and dO read as the MN-major
//   operand: one swizzled tile serves both descriptors. dK and dV (128
//   registers) live throughout, so a warpgroup runs its products one after
//   another (192 registers at most); the other warpgroup fills the gaps.
//   It stores per-q-head f32 partials; the caller sums them over the GQA
//   group, as the JAX package does in XLA.
// - dS and P enter their products as bf16 hi + lo pairs (split_hi_lo):
//   bf16 alone misses the f32 checks by 7-381x, the pair keeps them
//   (tests/test_torch_flash_bwd_numerics.py), for 1.33x (K7b) and 1.5x (K7c)
//   the tensor work of plain bf16.
// - Masks apply only on the tile that meets the diagonal, and a warpgroup
//   whose 64 rows lie wholly past it only releases the stage. No atomics:
//   every output element has one writer and a fixed order of sums, so
//   dQ, dK and dV are the same bits from run to run.

#include "flash_fwd.cuh"

namespace {
namespace flash_bwd {
using namespace hopper;

constexpr int kRows = 128;                 // rows of the tile a block keeps: K7b's queries, K7c's keys
constexpr int kStep = 64;                  // rows of a streamed tile: K7b's keys, K7c's queries
constexpr int kStages = 3;                 // ring depth
constexpr int kBigBytes = kRows * kD * 2;  // 32 KB
constexpr int kSmallBytes = kStep * kD * 2;  // 16 KB
constexpr int kBigHalf = kBigBytes / 2;    // the distance between a tile's two 64-column boxes
constexpr int kSmallHalf = kSmallBytes / 2;
constexpr float kLog2e = 1.4426950408889634f;

struct DqSmem {  // each tile sits on a 1024-byte boundary (the swizzle atom)
  uint8_t q[kBigBytes];
  uint8_t dout[kBigBytes];
  uint8_t k[kStages][kSmallBytes];
  uint8_t v[kStages][kSmallBytes];
  uint64_t fixed_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct DkvSmem {
  uint8_t k[kBigBytes];
  uint8_t v[kBigBytes];
  uint8_t q[kStages][kSmallBytes];
  uint8_t dout[kStages][kSmallBytes];
  float lse[kStages][kStep];
  float dsum[kStages][kStep];
  uint64_t fixed_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kDqSmemBytes = (int)sizeof(DqSmem) + 1024;  // slack to align the base
constexpr int kDkvSmemBytes = (int)sizeof(DkvSmem) + 1024;

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem*>(raw + pad);
}

template <typename Smem>
__device__ __forceinline__ void init_barriers(Smem& sm) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Tiles a and b (two boxes each, `half` bytes apart) at `row` of `head`.
__device__ __forceinline__ void load_pair(uint8_t* a, uint8_t* b, const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          uint64_t* bar, int row, int head, int half) {
  tma_load(a, map_a, bar, 0, row, head);
  tma_load(a + half, map_a, bar, kHalf, row, head);
  tma_load(b, map_b, bar, 0, row, head);
  tma_load(b + half, map_b, bar, kHalf, row, head);
}

// Before stage t % kStages is filled again, its use t / kStages - 1 is done.
__device__ __forceinline__ void wait_released(uint64_t* empty, int t) {
  if (t >= kStages) mbar_wait(&empty[t % kStages], ((t / kStages) + 1) & 1);
}

// Two 64 x 64 score tiles against one streamed tile pair, each 8 k-steps
// over d = 128: x = A_x B_x^T and y = A_y B_y^T, both operands K-major.
// Issued and committed as one group.
__device__ __forceinline__ void issue_score_pair(float (&x)[32], float (&y)[32], uint32_t ax, uint32_t bx,
                                                 uint32_t ay, uint32_t by, uint32_t a_half, uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(x, kmajor_desc(ax, kk, a_half), kmajor_desc(bx, kk, b_half), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(y, kmajor_desc(ay, kk, a_half), kmajor_desc(by, kk, b_half), kk > 0);
  wgmma_commit();
}

// -- K7b: dQ -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int hq, int hkv, int s, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // longest causal tiles first
  const int q_bh = batch * hq + head;
  const int kv_bh = batch * hkv + head / (hq / hkv);
  const int num_tiles = causal ? (q0 + kRows) / kStep : s / kStep;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(sm);

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.fixed_full, 2 * kBigBytes);
      load_pair(sm.q, sm.dout, &q_map, &do_map, &sm.fixed_full, q0, q_bh, kBigHalf);
      for (int t = 0; t < num_tiles; ++t) {
        const int st = t % kStages;
        wait_released(sm.empty, t);
        mbar_expect_tx(&sm.full[st], 2 * kSmallBytes);
        load_pair(sm.k[st], sm.v[st], &k_map, &v_map, &sm.full[st], t * kStep, kv_bh, kSmallHalf);
      }
    }
    return;
  }

  // A consumer warpgroup: q rows first_row .. first_row + 63. This thread's
  // rows are row0 and row0 + 8, its columns 8 j + col0 and + 1 of a tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int first_row = q0 + 64 * wg;
  const int row0 = first_row + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sm.q) + wg * 64 * 128;  // 64 rows of 128 bytes into each box
  const uint32_t do_addr = smem_u32(sm.dout) + wg * 64 * 128;
  const float scale_log2 = scale * kLog2e;
  float lse_log2[2], row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_log2[r] = lse[(size_t)q_bh * s + row0 + 8 * r] * kLog2e;
    row_d[r] = dsum[(size_t)q_bh * s + row0 + 8 * r];
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t ds_hi[16] = {}, ds_lo[16] = {};
  int pending = -1;  // the stage whose dQ product may still run

  mbar_wait(&sm.fixed_full, 0);
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kStep;
    mbar_wait(&sm.full[st], (t / kStages) & 1);
    if (causal && k0 > first_row) {  // above the diagonal for all 64 rows
      mbar_arrive(&sm.empty[st]);
      continue;
    }
    fence_regs(acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    wgmma_fence();
    issue_score_pair(sc, dp, q_addr, smem_u32(sm.k[st]), do_addr, smem_u32(sm.v[st]), kBigHalf, kSmallHalf);
    wgmma_wait<0>();  // S_t, dP_t and dQ_{t-1} have landed
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    if (pending >= 0) mbar_arrive(&sm.empty[pending]);

    // Element i: row row0 + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + col0 + i % 2.
    const bool diagonal = causal && k0 == first_row;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float x = fmaf(sc[i], scale_log2, -lse_log2[r]);
      if (diagonal && 8 * (i / 4) + col0 + (i % 2) > row0 + 8 * r - first_row) x = -INFINITY;
      dp[i] = ex2(x) * (dp[i] - row_d[r]) * scale;
    }
    split_hi_lo(dp, ds_hi, ds_lo);
    fence_regs(acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    wgmma_fence();
    issue_split_product<kStep / 16>(acc, ds_hi, ds_lo, smem_u32(sm.k[st]), kSmallHalf);
    pending = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ds_hi);
  fence_regs(ds_lo);
  if (pending >= 0) mbar_arrive(&sm.empty[pending]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* out = dq + ((size_t)q_bh * s + row0 + 8 * r) * kD + col0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// -- K7c: dK and dV ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ dsum, float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int hq, int hkv, int s, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int k0 = blockIdx.z * kRows;  // first key tiles (the longest under causal masking) first
  const int q_bh = batch * hq + head;
  const int kv_bh = batch * hkv + head / (hq / hkv);
  const int first_tile = causal ? k0 / kStep : 0;  // query tiles before the diagonal see no key here
  const int num_tiles = s / kStep - first_tile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(sm);

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.fixed_full, 2 * kBigBytes);
      load_pair(sm.k, sm.v, &k_map, &v_map, &sm.fixed_full, k0, kv_bh, kBigHalf);
      for (int t = 0; t < num_tiles; ++t) {
        const int st = t % kStages;
        const int qt = (first_tile + t) * kStep;
        wait_released(sm.empty, t);
        mbar_expect_tx(&sm.full[st], 2 * kSmallBytes + 2 * kStep * 4);
        load_pair(sm.q[st], sm.dout[st], &q_map, &do_map, &sm.full[st], qt, q_bh, kSmallHalf);
        bulk_load(sm.lse[st], lse + (size_t)q_bh * s + qt, kStep * 4, &sm.full[st]);
        bulk_load(sm.dsum[st], dsum + (size_t)q_bh * s + qt, kStep * 4, &sm.full[st]);
      }
    }
    return;
  }

  // A consumer warpgroup: keys first_key .. first_key + 63, the rows of its
  // transposed tiles. This thread's keys are key0 and key0 + 8, its queries
  // 8 j + col0 and + 1 of a tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int first_key = k0 + 64 * wg;
  const int key0 = first_key + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t k_addr = smem_u32(sm.k) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(sm.v) + wg * 64 * 128;
  const float scale_log2 = scale * kLog2e;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  float sc[32], dp[32];
  uint32_t hi[16] = {}, lo[16] = {};

  mbar_wait(&sm.fixed_full, 0);
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kStages;
    const int qt = (first_tile + t) * kStep;
    mbar_wait(&sm.full[st], (t / kStages) & 1);
    if (causal && qt < first_key) {  // every query of the tile comes before this warpgroup's keys
      mbar_arrive(&sm.empty[st]);
      continue;
    }
    const uint32_t q_addr = smem_u32(sm.q[st]);
    const uint32_t do_addr = smem_u32(sm.dout[st]);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    issue_score_pair(sc, dp, k_addr, q_addr, v_addr, do_addr, kBigHalf, kSmallHalf);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dk);
    fence_regs(dv);

    // Element i = 4 j + 2 r + c: key key0 + 8 r, query qt + 8 j + col0 + c;
    // LSE and D belong to the query, a column here.
    const bool diagonal = causal && qt == first_key;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 col_lse = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + col0]);
      const float2 col_d = *reinterpret_cast<const float2*>(&sm.dsum[st][8 * j + col0]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * r + c;
          float x = fmaf(sc[i], scale_log2, -(c ? col_lse.y : col_lse.x) * kLog2e);
          if (diagonal && key0 + 8 * r - first_key > 8 * j + col0 + c) x = -INFINITY;
          sc[i] = ex2(x);
          dp[i] = sc[i] * (dp[i] - (c ? col_d.y : col_d.x)) * scale;
        }
    }

    split_hi_lo(sc, hi, lo);  // dV += P^T dO
    fence_regs(dv);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_split_product<kStep / 16>(dv, hi, lo, do_addr, kSmallHalf);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(hi);
    fence_regs(lo);

    split_hi_lo(dp, hi, lo);  // dK += dS^T Q
    fence_regs(dk);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_split_product<kStep / 16>(dk, hi, lo, q_addr, kSmallHalf);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(hi);
    fence_regs(lo);
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = ((size_t)q_bh * s + key0 + 8 * r) * kD + col0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<float2*>(dk_part + row + 8 * j) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(dv_part + row + 8 * j) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// -- host side -------------------------------------------------------------------

bool bad_shape(int hq, int hkv, int s, int d) {
  return d != kD || hkv <= 0 || hq % hkv != 0 || s <= 0 || s % kRows != 0;
}

// The four tensor maps of a backward launch: (a, b) with kRows-row boxes
// over `a_heads` heads, (c, e) with kStep-row boxes over `c_heads`.
bool encode_maps(CUtensorMap (&maps)[4], const void* a, const void* b, int a_heads, const void* c, const void* e,
                 int c_heads, int s) {
  return encode_map(&maps[0], a, a_heads, s, kRows) && encode_map(&maps[1], b, a_heads, s, kRows) &&
         encode_map(&maps[2], c, c_heads, s, kStep) && encode_map(&maps[3], e, c_heads, s, kStep);
}

}  // namespace flash_bwd
}  // namespace

extern "C" int vtx_flash_fwd_lse(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                 int hq, int hkv, int s, int d, int causal, float scale, void* stream) {
  if (flash_bwd::bad_shape(hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  return flash_fwd::launch_flash_fwd<true>(q, k, v, out, (float*)lse, batch, hq, hkv, s, s, d, causal, scale,
                                           stream);
}

extern "C" int vtx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* dsum, void* dq, int batch, int hq, int hkv, int s, int d, int causal,
                                float scale, void* stream) {
  using namespace flash_bwd;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (bad_shape(hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap maps[4];  // q, dO, k, v
  if (!encode_maps(maps, q, dout, batch * hq, k, v, batch * hkv, s)) return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, batch, s / kRows);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)dsum, (__nv_bfloat16*)dq, hq, hkv, s,
      causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int vtx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* dsum, void* dk_part, void* dv_part, int batch, int hq, int hkv, int s,
                                 int d, int causal, float scale, void* stream) {
  using namespace flash_bwd;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (bad_shape(hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap maps[4];  // k, v, q, dO
  if (!encode_maps(maps, k, v, batch * hkv, q, dout, batch * hq, s)) return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, batch, s / kRows);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)dsum, (float*)dk_part, (float*)dv_part,
      hq, hkv, s, causal, scale);
  return (int)cudaGetLastError();
}
