// K6: packed-int4 weight matmul for the decode step, on Hopper's tensor cores.
//
// Replaces video_transformer_tpu/ops/int4_matmul.py:46 `_kernel` (launched by
// _int4_matmul_pallas): y[m, n] = sum_j x[m, 2j] * sext(lo P[j, n])
// + x[m, 2j+1] * sext(hi P[j, n]), x bf16 [M, K] (M <= 256), P uint8 [K/2, N]
// holding two's-complement nibbles (row 2j low, row 2j+1 high), accumulated
// in f32 and rounded to bf16 once, unscaled.
//
// What bounds it on an H100: the product does 4M operations per packed
// weight byte. Below M ~ 74 that is under the ~295 operations per byte where
// the card turns compute-bound, so at decode M (6 at batch 2 x width 3, 24 in
// the batcher) the K/2 x N weight bytes set the time (0.0102 ms at the 7b
// gate shape); at M = 256 the 2 M K N operations do (0.0351 ms there).
//
// Design:
// - The operands are swapped: y^T [N, M] = W^T [N, K] x^T [K, M]. A consumer
//   warpgroup owns 64 output channels, wgmma's M; all rows of x, padded to
//   kN (8, 16, 24, 32, 64, 128 or 256), are wgmma's N. A block (two consumer
//   warpgroups, 128 channels) covers every row of x, so each weight byte
//   leaves device memory once per call at every M.
// - The weight is wgmma's register A operand, dequantized in registers. In
//   the m64nNk16 A fragment a 32-bit register holds one (channel, k-pair),
//   and the k-pair (2j, 2j+1) of channel n is exactly the carrier byte
//   P[j, n]. Two ldmatrix.x4.trans a warp read the bytes of a stage's eight
//   k-steps: the row addresses put weight rows j and j + 4 next to each
//   other, so each register holds the four bytes a thread needs, (j, c),
//   (j, c+1), (j+4, c), (j+4, c+1). A byte becomes a bf16x2 in three
//   instructions: a byte permute puts its two nibbles at the bottom of the
//   two halves, a LOP3 keeps them and writes (nibble ^ 8) into the mantissa
//   of 128.0, and an FMA subtracts 136 (exact for -8..7). Within a warp's 16
//   rows the channels are permuted (A rows g and g + 8 are channels 2g and
//   2g + 1) so that the ldmatrix reads whole 16-byte rows of the
//   128-byte-swizzled tile, free of bank conflicts; the store undoes it.
// - x is wgmma's B operand, K-major as it lies in memory: TMA copies
//   [kN, 64] bf16 tiles with the 128-byte swizzle, rows past M as zeros, so
//   ragged M needs no pad copy.
// - One producer warp keeps a ring of stages (a [64, 128] weight tile and
//   two x tiles each) in flight with TMA, on full/empty mbarriers: 32-56 KB
//   of weight a block up to width 64, where three blocks (two at 64) share
//   an SM. A consumer reads a stage's bytes while its previous group
//   of eight wgmma runs, then retires it and dequantizes: ptxas serializes
//   every wgmma of a kernel that writes the A registers of a later group
//   while one is in flight (its C7513 warning), so the overlap comes from the
//   other warpgroups of the SM.
// - Enough blocks for 132 SMs: the 7b k/v projection (N = 512) has 4 tiles of
//   128 channels and q/out 28, so K/2 splits across up to 8 blocks of one
//   thread-block cluster (the plan is ops/int4_matmul.py::int4_plan). Each
//   block leaves its f32 tile in shared memory; after a cluster barrier each
//   block sums a slice of the tile over the cluster's blocks in rank order,
//   through distributed shared memory, and stores bf16. No atomics, no
//   second launch: two launches give the same bits.
// - Integer x in [-4, 4] keeps every product and partial sum an integer
//   below 2^24, exact in f32 in any order of summation.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {
namespace int4mm {

namespace cg = cooperative_groups;

constexpr int kBlockN = 128;                      // output channels a block: two warpgroups of 64
constexpr int kUnitRows = 64;                     // K/2 rows a stage: eight k-steps of 16
constexpr int kConsumers = 256;                   // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kMaxSplits = 8;                     // the portable cluster size
constexpr int kWTileBytes = kUnitRows * kBlockN;  // [64, 128] uint8

template <int kN>
struct Shape {
  static constexpr int kXBoxBytes = kN * 128;  // [kN, 64] bf16: one TMA box, 64 of a stage's 128 k
  static constexpr int kXTileBytes = 2 * kXBoxBytes;
  static constexpr int kStageBytes = kWTileBytes + kXTileBytes;
  // Blocks an SM: three up to width 32, two at 64, one above (the registers
  // and the ring's shared memory allow that many).
  static constexpr int kBlocksPerSm = kN <= 32 ? 3 : kN <= 64 ? 2 : 1;
  static constexpr int kRingLimit = (kN <= 32 ? 72 : kN <= 64 ? 96 : 216) * 1024;
  static constexpr int kStages = kRingLimit / kStageBytes < 8 ? kRingLimit / kStageBytes : 8;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = kRingBytes + 2 * kStages * 8 + 1024;  // + barriers, + slack to align
  static_assert(kConsumers * (kN / 2) * 4 <= kRingBytes, "the f32 tile fits in the ring");
};

// d += A B for a 64 x kN f32 tile, k = 16: A (bf16x2, four registers) from
// registers, B K-major in shared memory.
template <int kN>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void rs(float (&d)[4], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}"
        ", {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void rs(float (&d)[8], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}"
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<24> {
  __device__ static __forceinline__ void rs(float (&d)[12], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}"
        ", {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void rs(float (&d)[16], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void rs(float (&d)[128], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Four 8 x 8 b16 matrices, transposed, into r[0..3]; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Byte p of r as the bf16x2 (sext lo, sext hi) of its two nibbles. `sel`
// puts byte p of r in byte 0 and byte p of s = r >> 4 in byte 2; the mask
// keeps the two nibbles, the XOR writes 128 + (nibble ^ 8) in bf16, and the
// FMA subtracts 136.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t r, uint32_t s, uint32_t sel) {
  uint32_t v, out;
  // (t & 0x000F000F) ^ 0x43084308 as one LOP3 (0x6a: (a & b) ^ c), the masks in registers.
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(v) : "r"(__byte_perm(r, s, sel)), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;
}

// The A fragments of eight k-steps from two ldmatrix.x4.trans: register q
// holds bytes (j, c), (j, c+1), (j+4, c), (j+4, c+1) of k-step q, which are
// A's (row g, k-pair t), (row g + 8, t), (row g, t + 4), (row g + 8, t + 4).
__device__ __forceinline__ void dequant(const uint32_t (&r)[8], uint32_t (&a)[32]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t s = r[q] >> 4;
    a[4 * q + 0] = nibbles_bf16x2(r[q], s, 0x4400);
    a[4 * q + 1] = nibbles_bf16x2(r[q], s, 0x5511);
    a[4 * q + 2] = nibbles_bf16x2(r[q], s, 0x6622);
    a[4 * q + 3] = nibbles_bf16x2(r[q], s, 0x7733);
  }
}

// Unit `it` of a consumer warpgroup: wait for its stage and read its
// weight bytes while unit it - 1's products run, retire them and release
// their stage, then dequantize into `a` and issue this unit's eight wgmma
// k-steps as one group. `a` is written only while no group is in flight:
// ptxas serializes the wgmma of a kernel that writes the A registers of a
// later group while one runs.
template <int kN>
__device__ __forceinline__ void consume_unit(float (&acc)[kN / 2], uint32_t (&a)[32], int it, uint64_t* full,
                                             uint64_t* empty, uint32_t w_addr, uint32_t x_addr, int lane) {
  using S = Shape<kN>;
  const int s = it % S::kStages;
  hopper::mbar_wait(&full[s], (it / S::kStages) & 1);
  uint32_t bytes[8];
  ldmatrix_x4_trans(bytes, w_addr + s * kWTileBytes);
  ldmatrix_x4_trans(bytes + 4, w_addr + s * kWTileBytes + 32 * 128);
  hopper::wgmma_wait<0>();  // unit it - 1's products have landed: its stage and `a` are free
  if (it >= 1 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S::kStages]);
  dequant(bytes, a);
  // k-step q reads 16 k (32 bytes) of x box q / 4: the descriptor's address field counts 16 bytes.
  const uint64_t desc = hopper::sw128_desc(x_addr + s * S::kXTileBytes, 16);
  hopper::wgmma_fence();
#pragma unroll
  for (int q = 0; q < 8; ++q)
    Wgmma<kN>::rs(acc, a + 4 * q, desc + (q / 4) * (S::kXBoxBytes >> 4) + (q % 4) * 2);
  hopper::wgmma_commit();
}

// One block: 128 output channels (blockIdx.y) over K/2 rows
// [64 first, 64 (first + count)), split blockIdx.x of gridDim.x, which is
// the block's rank in its cluster.
template <int kN>
__global__ void __launch_bounds__(kThreads, Shape<kN>::kBlocksPerSm)
    int4_matmul_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                       __nv_bfloat16* __restrict__ out, int m, int n, int units) {
  using S = Shape<kN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* w_tiles = smem;
  uint8_t* x_tiles = smem + S::kStages * kWTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kRingBytes);
  uint64_t* empty = full + S::kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;
  const int split = blockIdx.x;
  const int n0 = blockIdx.y * kBlockN;
  const int first = split * units / splits;
  const int count = (split + 1) * units / splits - first;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  hopper::fence_regs(acc);

  if (warp == kConsumers / 32) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
      for (int it = 0; it < count; ++it) {
        const int s = it % S::kStages;
        if (it >= S::kStages) hopper::mbar_wait(&empty[s], ((it / S::kStages) + 1) & 1);
        hopper::mbar_expect_tx(&full[s], S::kStageBytes);
        const int j = (first + it) * kUnitRows;
        hopper::tma_load_2d(w_tiles + s * kWTileBytes, &w_map, &full[s], n0, j);
        hopper::tma_load_2d(x_tiles + s * S::kXTileBytes, &x_map, &full[s], 2 * j, 0);
        hopper::tma_load_2d(x_tiles + s * S::kXTileBytes + S::kXBoxBytes, &x_map, &full[s], 2 * j + 64, 0);
      }
    }
    __syncwarp();
  } else {
    // Consumer warp w (0-7) owns channels 16 w .. 16 w + 15 of the block: the
    // 16-byte chunk w of each 128-byte weight row. For the first ldmatrix,
    // lane l gives row r = l % 8 of k-step l / 8's matrix: weight row
    // 8 (l / 8) + r / 2 + 4 (r % 2), at its swizzled chunk; the second reads
    // rows 32 further on (k-steps 4-7), with the same swizzle.
    const int r = lane % 8;
    const int row = 8 * (lane / 8) + r / 2 + 4 * (r % 2);
    const uint32_t w_addr = hopper::smem_u32(w_tiles) + row * 128 + ((warp ^ (row % 8)) * 16);
    const uint32_t x_addr = hopper::smem_u32(x_tiles);
    uint32_t a[32];
    for (int it = 0; it < count; ++it) consume_unit<kN>(acc, a, it, full, empty, w_addr, x_addr, lane);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }

  // The fold: every block's f32 tile into its own ring ([kN / 2][256]:
  // acc[i] of consumer thread t at i * 256 + t), then each block sums its
  // slice of the output over the cluster's tiles in rank order.
  __syncthreads();  // every product has landed: the ring is free
  float* tile = reinterpret_cast<float*>(smem);
  if (threadIdx.x < kConsumers) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) tile[i * kConsumers + threadIdx.x] = acc[i];
  }
  if (splits > 1) {
    cluster.sync();  // every split's tile is in place
  } else {
    __syncthreads();
  }
  // Output pairs p = (2 i + h) * 256 + t: consumer thread t's acc[4 i + h]
  // and acc[4 i + h + 2], channels c and c + 1 of row 8 i + 2 (t % 4) + h.
  constexpr int kPairs = kN / 4 * kConsumers;
  const int end = (split + 1) * kPairs / splits;
  for (int p = split * kPairs / splits + threadIdx.x; p < end; p += kThreads) {
    const int t = p % kConsumers;
    const int ih = p / kConsumers;
    const int row = 8 * (ih / 2) + 2 * (t % 4) + ih % 2;
    if (row >= m) continue;
    const int e = (4 * (ih / 2) + ih % 2) * kConsumers + t;
    float v0[kMaxSplits], v1[kMaxSplits];  // every rank's pair loaded first, so the loads overlap
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        const float* part = cluster.map_shared_rank(tile, q);
        v0[q] = part[e];
        v1[q] = part[e + 2 * kConsumers];
      }
    }
    float c0 = v0[0], c1 = v1[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q) {
      if (q < splits) {
        c0 += v0[q];
        c1 += v1[q];
      }
    }
    const int c = n0 + 16 * (t / 32) + 2 * ((t % 32) / 4);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + c) = __floats2bfloat162_rn(c0, c1);
  }
  if (splits > 1) {
    // No block leaves while another still reads its tile. The reads are done
    // (their values are stored), so the arrive need not wait for this block's
    // stores to land, as cluster.sync()'s release would.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
  }
}

// Launch on `stream` as a grid of (splits, N / 128) blocks in clusters of
// `splits`. The shared-memory opt-in is set once per process and width.
template <int kN>
int launch(const void* x, const void* packed, void* out, int m, int k2, int n, int splits, cudaStream_t stream) {
  using S = Shape<kN>;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(int4_matmul_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  CUtensorMap x_map, w_map;
  if (!hopper::encode_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, 2 * k2, kN, 64) ||
      !hopper::encode_map_2d(&w_map, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k2, n, kUnitRows, kBlockN))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, n / kBlockN);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = S::kSmemBytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, int4_matmul_kernel<kN>, x_map, w_map,
                                             static_cast<__nv_bfloat16*>(out), m, n, k2 / kUnitRows);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace int4mm
}  // namespace

// x bf16 [m, 2 k2], packed uint8 [k2, n], out bf16 [m, n], all 16-byte
// aligned; n_pad in {8, 16, 24, 32, 64, 128, 256} and >= m; n % 128 == 0;
// k2 % 32 == 0; K/2 split across 1-8 blocks (at most k2 / 32).
extern "C" int vtx_int4_matmul(const void* x, const void* packed, void* out, int m, int k2, int n, int n_pad,
                               int splits, void* stream) {
  using namespace int4mm;
  if (m < 1 || m > n_pad || n < kBlockN || n % kBlockN || k2 < kUnitRows || k2 % kUnitRows || splits < 1 ||
      splits > kMaxSplits || splits > k2 / kUnitRows ||
      ((uintptr_t)x | (uintptr_t)packed | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (hopper::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_pad) {
    case 8: return launch<8>(x, packed, out, m, k2, n, splits, s);
    case 16: return launch<16>(x, packed, out, m, k2, n, splits, s);
    case 24: return launch<24>(x, packed, out, m, k2, n, splits, s);
    case 32: return launch<32>(x, packed, out, m, k2, n, splits, s);
    case 64: return launch<64>(x, packed, out, m, k2, n, splits, s);
    case 128: return launch<128>(x, packed, out, m, k2, n, splits, s);
    case 256: return launch<256>(x, packed, out, m, k2, n, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
