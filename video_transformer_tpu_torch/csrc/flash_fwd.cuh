// Flash-attention forward shared by K1 (csrc/flash_attention.cu) and K7a
// (csrc/flash_bwd.cu): bf16 in and out, f32 online softmax, and with
// kLse = true also LSE = m + log(l) per query row in f32, the residual the
// backward kernels recompute the probabilities from.
//
// softmax(Q K^T / sqrt(d) + mask) V for q [B, Hq, Sq, D] against k/v
// [B, Hkv, Sk, D], GQA head h -> h / (Hq / Hkv), causal mask aligned to the
// last Sq keys (q_offset = Sk - Sq; K7a takes Sq == Sk, so its mask has no
// offset), key tiles wholly above the causal edge skipped.
//
// Design: one block of 256 threads per (64-row q tile, q head, batch). The
// q tile stays in shared memory; 64-row k and v tiles stream through shared
// memory. Each thread owns a 4 x 4 patch of the 64 x 64 score tile and a
// 4 x 8 patch of the 64 x 128 output, so both products reuse every shared
// memory read four to eight times from registers. Row max and row sum reduce
// over the 16 threads that share a row with warp shuffles. Padded row
// strides keep the shared-memory reads free of bank conflicts.

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
constexpr float kNegInf = -1e30f;

struct FwdSmem {
  __nv_bfloat16 q[kBQ * kStride];
  __nv_bfloat16 k[kBK * kStride];
  __nv_bfloat16 v[kBK * kD];
  float p[kBQ * kPStride];
};

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

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int hq, int hkv, int sq, int sk, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // score columns tx + 16*j, output columns tx + 16*c

  const __nv_bfloat16* q_bh = q + (size_t)(batch * hq + head) * sq * kD;
  const __nv_bfloat16* k_bh = k + (size_t)(batch * hkv + kv_head) * sk * kD;
  const __nv_bfloat16* v_bh = v + (size_t)(batch * hkv + kv_head) * sk * kD;
  __nv_bfloat16* o_bh = o + (size_t)(batch * hq + head) * sq * kD;

  load_rows(sm.q, kStride, q_bh + (size_t)q0 * kD, min(kBQ, sq - q0), kBQ);

  const int q_offset = sk - sq;
  int num_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last_q = q_offset + min(q0 + kBQ, sq) - 1;
    num_tiles = min(num_tiles, last_q / kBK + 1);
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_rows(sm.k, kStride, k_bh + (size_t)k0 * kD, min(kBK, sk - k0), kBK);
    load_rows(sm.v, kD, v_bh + (size_t)k0 * kD, min(kBK, sk - k0), kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < kD; d += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &sm.q[(ty * 4 + i) * kStride + d]));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &sm.k[(tx + 16 * j) * kStride + d]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int q_pos = q_offset + q0 + r;
      bool valid[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        valid[j] = k_pos < sk && (!causal || k_pos <= q_pos);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off, 16));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = __expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? __expf(s[i][j] - m_new) : 0.f;
        sm.p[r * kPStride + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off, 16);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sm.p[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) vv[c] = __bfloat162float(sm.v[kk * kD + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / safe_l;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      o_bh[(size_t)r * kD + tx + 16 * c] = __float2bfloat16(acc[i][c] * inv);
    if constexpr (kLse) {
      if (tx == 0) lse[(size_t)(batch * hq + head) * sq + r] = m[i] + logf(safe_l);
    }
  }
}

// Launch the forward on `stream`; `lse` is read only when kLse is true.
template <bool kLse>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int hq, int hkv, int sq, int sk,
                     int causal, float scale, void* stream) {
  const int smem = (int)sizeof(FwdSmem);
  auto kernel = flash_fwd_kernel<kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, hq, batch);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, hq, hkv, sq, sk,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace
