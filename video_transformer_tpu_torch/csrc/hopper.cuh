// Hopper building blocks of the flash kernels (flash_fwd.cuh for K1 and
// K7a, flash_bwd.cu for K7b and K7c) and of K6 (int4_matmul.cu): the
// warpgroup layout, TMA copies with mbarriers, 128-byte-swizzled
// shared-memory descriptors, the wgmma forms the flash kernels use, and the
// bf16 hi + lo split of an f32 register tile.
//
// Every tile is [rows, 128] bf16 (head_dim 128), stored as two boxes of 64
// columns: one row of a box is 128 bytes, the span of the 128-byte swizzle.
// A tile read K-major (the contraction runs along its columns, as Q and K in
// Q K^T) steps 32 bytes a k-step inside a row and 1,024 bytes between groups
// of 8 rows; read MN-major (the contraction runs along its rows, as V in
// P V), a k-step is 16 rows and the leading offset is the distance between
// the two boxes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int kD = 128;                    // head_dim of every flash kernel
constexpr int kHalf = 64;                  // bf16 columns a 128-byte swizzle row holds
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128; // and one producer warpgroup
constexpr int kProducerRegs = 24;          // setmaxnreg: the producer gives registers
constexpr int kConsumerRegs = 240;         // to the consumers (24 + 2 x 240 <= 3 x 168)

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

// One box of a 2-D map at (column c0, row c1) into shared `dst`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global `src` into shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
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

// The descriptor of k-step kk (16 columns) of a K-major tile whose 64-column
// boxes are `half_bytes` apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile_addr, int kk, uint32_t half_bytes) {
  return sw128_desc(tile_addr + (kk / 4) * half_bytes + (kk % 4) * 32, 16);
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
#define VTX_ACC32 VTX_ACC8(0), VTX_ACC8(8), VTX_ACC8(16), VTX_ACC8(24)
#define VTX_ACC64 VTX_ACC32, VTX_ACC8(32), VTX_ACC8(40), VTX_ACC8(48), VTX_ACC8(56)
#define VTX_REGS32                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
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

// The same for a 64 x 64 f32 tile (B holds 64 rows).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VTX_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VTX_ACC32
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
#undef VTX_ACC32
#undef VTX_ACC64
#undef VTX_REGS32
#undef VTX_REGS64

// acc += (A_hi + A_lo) B over `kSteps` k-steps of 16: A in registers in the
// accumulator's layout (4 bf16x2 a k-step), B an MN-major tile of 16 rows a
// k-step whose 64-column boxes are `half_bytes` apart. Issued and committed
// as one group.
template <int kSteps, int kRegs>
__device__ __forceinline__ void issue_split_product(float (&acc)[64], const uint32_t (&a_hi)[kRegs],
                                                    const uint32_t (&a_lo)[kRegs], uint32_t b_addr,
                                                    uint32_t half_bytes) {
  static_assert(kRegs == 4 * kSteps, "four A registers a k-step");
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t b = sw128_desc(b_addr + kk * 16 * 128, half_bytes);
    wgmma_rs_tb(acc, a_hi[4 * kk], a_hi[4 * kk + 1], a_hi[4 * kk + 2], a_hi[4 * kk + 3], b);
    wgmma_rs_tb(acc, a_lo[4 * kk], a_lo[4 * kk + 1], a_lo[4 * kk + 2], a_lo[4 * kk + 3], b);
  }
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

// An f32 tile in the accumulator's layout as the A fragments of the next
// products: hi = bf16(x) and lo = bf16(x - hi), pairs of neighbouring
// columns in each register. x's error falls from up to 2^-8 to up to 2^-16
// of x, for two products where one would do.
template <int N>
__device__ __forceinline__ void split_hi_lo(const float (&x)[N], uint32_t (&hi)[N / 2], uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
    hi[i / 2] = bf16x2_bits(h);
    lo[i / 2] = bf16x2_bits(__floats2bfloat162_rn(x[i] - __low2float(h), x[i + 1] - __high2float(h)));
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

// A 3-D map over [heads, s, 128] bf16 (heads = B * H), box [1, box_rows, 64],
// 128-byte swizzle; rows past s read as zeros.
inline bool encode_map(CUtensorMap* map, const void* base, int heads, int s, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)s * kD * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)kHalf, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a row-major [rows, cols] array of `elem_bytes`-byte elements,
// box [box_rows, box_cols] (box_cols * elem_bytes = 128, the swizzle span),
// 128-byte swizzle; rows past `rows` read as zeros.
inline bool encode_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem_bytes, int rows,
                          int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace
