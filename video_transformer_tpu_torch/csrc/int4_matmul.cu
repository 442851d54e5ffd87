// K6: packed-int4 weight matmul for the decode step.
//
// Replaces video_transformer_tpu/ops/int4_matmul.py:46 `_kernel` (launched by
// _int4_matmul_pallas): out[m, n] = sum_j x[m, 2j] * sext(lo P[j, n])
// + x[m, 2j+1] * sext(hi P[j, n]), x bf16 [M, K] (M <= 256), P uint8 [K/2, N]
// holding two's-complement nibbles (row 2j low, row 2j+1 high), accumulated
// in f32 and rounded to bf16 once, unscaled.
//
// What bounds it on an H100: bytes. At decode M (6 at batch 2, width 3) the
// packed weight is nearly all of the traffic (K/2 * N bytes against 2MK of x
// and 2MN of output), and the arithmetic is 2M operations per weight nibble,
// far below the ~295 per byte where the card turns compute-bound. So the
// design reads each weight byte from device memory once, and nothing else
// in bulk:
// - A block owns 128 output columns for a range of K/2 rows and up to 8 rows
//   of x. Each of its 128 threads owns 4 adjacent columns and reads their
//   packed bytes as one 32-bit load per K/2 row (a warp reads 128 contiguous
//   bytes); its 4 warps take interleaved groups of 4 rows.
// - x is not copied or split into even and odd halves as the TPU kernel did:
//   x's (even, odd) pair for a K/2 row is one bf16x2 word, staged in chunks
//   of 256 rows into shared memory and read there as a broadcast. Rows of x
//   past M are staged as zeros and never stored, so ragged M needs no pad.
// - Nibbles become floats without a conversion instruction: the byte
//   (v ^ 8) in [0, 15] goes into the mantissa of 2^23 (one byte permute) and
//   2^23 + 8 is subtracted. Products and sums are f32 FMAs.
// - The 7b k/v projections have N = 512 (four blocks of columns), so the
//   K/2 range splits across blocks until about four blocks per SM are in
//   flight. Each split writes f32 partials; a second pass sums them in split
//   order and rounds to bf16. Warps combine through shared memory in warp
//   order. No atomics: results are deterministic. With one split the first
//   pass rounds and stores bf16 itself.
// - K/2 need only be a multiple of 16 here (the dispatch requires 128); the
//   last split may be shorter than the others.
//
// Tensor-core products (mma/wgmma) and cp.async or TMA pipelines for the
// weight stream are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;               // adjacent output columns per thread
constexpr int kBlockN = 32 * kCols;    // 128 output columns per block
constexpr int kGroup = 4;              // K/2 rows a warp takes per step
constexpr int kChunk = 256;            // K/2 rows of x staged per pass
constexpr int kMaxRows = 8;            // rows of x per block

// Nibble c of `word` (already XOR 8, so in [0, 15]) as the float (nibble - 8).
__device__ __forceinline__ float nibble_value(uint32_t word, int c) {
  const uint32_t bits = __byte_perm(word, 0x4B000000u, 0x7540 + c);  // 2^23 + byte c
  return __uint_as_float(bits) - 8388616.0f;                          // - (2^23 + 8)
}

// Four floats rounded to bf16 (nearest even), in order, as one 8-byte word.
__device__ __forceinline__ uint2 to_bf16x4(float4 v) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const uint32_t c = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const uint32_t d = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  return make_uint2(a | (b << 16), c | (d << 16));
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const uint32_t* __restrict__ x,      // [M, K/2] bf16 pairs
                   const uint8_t* __restrict__ packed,  // [K/2, N]
                   __nv_bfloat16* __restrict__ out,     // [M, N] (one split)
                   float* __restrict__ partial,         // [splits, M, N]
                   int m, int k2, int n, int split_rows) {
  __shared__ __align__(16) uint32_t xs[MT][kChunk];
  __shared__ float4 red[kWarps - 1][MT][32];
  const int m0 = blockIdx.x * MT;
  const int col = blockIdx.y * kBlockN + (threadIdx.x % 32) * kCols;
  const int warp = threadIdx.x / 32;
  const int begin = blockIdx.z * split_rows;
  const int end = min(begin + split_rows, k2);

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int base = begin; base < end; base += kChunk) {
    const int len = min(kChunk, end - base);  // a multiple of kWarps * kGroup
    __syncthreads();                          // the last chunk is consumed
    for (int i = threadIdx.x; i < MT * len; i += kThreads) {
      const int r = i / len, j = i - r * len;
      xs[r][j] = m0 + r < m ? x[(size_t)(m0 + r) * k2 + base + j] : 0u;
    }
    __syncthreads();
    for (int j = warp * kGroup; j < len; j += kWarps * kGroup) {
      uint32_t w[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        w[g] = __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)(base + j + g) * n + col));
      float lo[kGroup][kCols], hi[kGroup][kCols];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const uint32_t l = (w[g] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t h = ((w[g] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          lo[g][c] = nibble_value(l, c);
          hi[g][c] = nibble_value(h, c);
        }
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const uint4 pairs = *reinterpret_cast<const uint4*>(&xs[r][j]);
        const uint32_t p[kGroup] = {pairs.x, pairs.y, pairs.z, pairs.w};
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float xe = __uint_as_float(p[g] << 16);          // x[m, 2j]
          const float xo = __uint_as_float(p[g] & 0xFFFF0000u);  // x[m, 2j + 1]
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[r][c] = fmaf(xe, lo[g][c], acc[r][c]);
            acc[r][c] = fmaf(xo, hi[g][c], acc[r][c]);
          }
        }
      }
    }
  }

  const int lane = threadIdx.x % 32;
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
      red[warp - 1][r][lane] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    float4 s = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w) {
      const float4 o = red[w][r][lane];
      s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
    }
    if (m0 + r >= m) continue;
    const size_t at = (size_t)(m0 + r) * n + col;
    if (partial != nullptr) {
      *reinterpret_cast<float4*>(partial + (size_t)blockIdx.z * m * n + at) = s;
    } else {
      *reinterpret_cast<uint2*>(out + at) = to_bf16x4(s);
    }
  }
}

// out = bf16(sum over splits of partial), four elements a thread, in split order.
__global__ void __launch_bounds__(256)
combine_splits_kernel(const float4* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                      int quads, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  float4 s = partial[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 o = partial[(size_t)sp * quads + i];
    s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
  }
  reinterpret_cast<uint2*>(out)[i] = to_bf16x4(s);
}

template <int MT>
int launch(const uint32_t* x, const uint8_t* packed, __nv_bfloat16* out, float* partial,
           int m, int k2, int n, int split_rows, int splits, cudaStream_t stream) {
  static_assert(MT >= 1 && MT <= kMaxRows, "rows of x per block");
  const dim3 grid((m + MT - 1) / MT, n / kBlockN, splits);
  int4_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(
      x, packed, out, splits > 1 ? partial : nullptr, m, k2, n, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int quads = m * n / 4;
  combine_splits_kernel<<<(quads + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), out, quads, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [m, 2 * k2], packed uint8 [k2, n], out bf16 [m, n]; partial f32
// [splits, m, n] when splits > 1. rows_per_block in 1..8; n % 128 == 0;
// k2 and split_rows multiples of 16.
extern "C" int vtx_int4_matmul(const void* x, const void* packed, void* out, void* partial,
                               int m, int k2, int n, int rows_per_block, int split_rows,
                               int splits, void* stream) {
  if (m < 1 || n % kBlockN || k2 % (kWarps * kGroup) || split_rows % (kWarps * kGroup) ||
      splits < 1 || (long long)split_rows * splits < k2 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint32_t* xp = (const uint32_t*)x;
  const uint8_t* pp = (const uint8_t*)packed;
  __nv_bfloat16* op = (__nv_bfloat16*)out;
  float* part = (float*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows_per_block) {
    case 1: return launch<1>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 2: return launch<2>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 3: return launch<3>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 4: return launch<4>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 5: return launch<5>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 6: return launch<6>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 7: return launch<7>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    case 8: return launch<8>(xp, pp, op, part, m, k2, n, split_rows, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
