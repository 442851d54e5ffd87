// Tile geometry and the row loader of the flash backward kernels K7b and K7c
// (csrc/flash_bwd.cu): 64 x 64 tiles over head_dim 128, 256 threads a block,
// shared-memory rows padded against bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kStride = kD + 4;   // bf16 per shared q/k row (padding: banks)
constexpr int kPStride = kBK + 4; // f32 per shared probability row

// Copy `rows` rows of kD bf16 from global `src` (row-major, contiguous) to
// shared `dst` with row stride `stride`; rows at or past `valid` become 0.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int valid,
                                          int rows) {
  constexpr int kChunks = kD / 4;  // 8-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint2 val = make_uint2(0u, 0u);
    if (r < valid) val = reinterpret_cast<const uint2*>(src + (size_t)r * kD)[c];
    *reinterpret_cast<uint2*>(dst + r * stride + c * 4) = val;
  }
}

}  // namespace
