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
// the 64-row tile; the causal mask has no offset (key j is visible to query
// i iff j <= i), and tiles wholly above the diagonal are skipped on both
// sides: K7b stops its key loop at the diagonal, K7c starts its query loop
// there.
//
// What bounds them on an H100: at the training shapes (S = 1024 and 3072,
// D = 128) they are compute-bound, like K1: per (batch, head) and visible
// (query, key) pair K7a does 4*D operations, K7b 6*D and K7c 8*D, against
// O(S*D) bytes.
// - K7a is K1's kernel (flash_fwd.cuh) with the LSE store switched on: wgmma
//   products on the tensor cores fed by TMA, P V as bf16 P_hi + P_lo.
// - K7b and K7c still run their products on the f32 FMA units (67 TF/s
//   peak), not the tensor cores; wgmma is their later step. They use 256
//   threads a block, 64 x 64 tiles staged in shared memory with padded rows
//   (flash_tiles.cuh), and each thread owns a 4 x 4 patch of the score tile
//   and a 4 x 8 patch of each 64 x 128 accumulator, kept in registers.
// - K7b: one block per (q tile, q head, batch). The q and dO tiles stay in
//   shared memory; k and v tiles stream. S and dP come from one pass over D,
//   dS goes through shared memory, dQ += dS K accumulates in f32 registers
//   and is stored once, in bf16.
// - K7c: one block per (k tile, q head, batch). The k and v tiles stay;
//   q and dO tiles stream. The block computes the transposed tiles S^T and
//   dP^T, so that P^T and dS^T land in shared memory row-major per key and
//   dV += P^T dO, dK += dS^T Q accumulate in f32 registers (two 64 x 128
//   accumulators, 64 KB per block in registers). It stores per-q-head f32
//   partials; the caller sums them over the GQA group, as the JAX package
//   does in XLA.
// Shared memory: 85.5 KB (K7b) and 102.9 KB (K7c), above the 48 KB default,
// so each entry opts in with cudaFuncSetAttribute.

#include "flash_fwd.cuh"
#include "flash_tiles.cuh"

namespace {

struct DqSmem {
  __nv_bfloat16 q[kBQ * kStride];
  __nv_bfloat16 dout[kBQ * kStride];
  __nv_bfloat16 k[kBK * kStride];
  __nv_bfloat16 v[kBK * kStride];
  float ds[kBQ * kPStride];
  float lse[kBQ];
  float dsum[kBQ];
};

struct DkvSmem {
  __nv_bfloat16 k[kBK * kStride];
  __nv_bfloat16 v[kBK * kStride];
  __nv_bfloat16 q[kBQ * kStride];
  __nv_bfloat16 dout[kBQ * kStride];
  float p[kBK * kPStride];   // P^T: row = key, column = query
  float ds[kBK * kPStride];  // dS^T
  float lse[kBQ];
  float dsum[kBQ];
};

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int hq, int hkv, int s,
                    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const size_t q_base = (size_t)(batch * hq + head) * s;
  const size_t kv_base = (size_t)(batch * hkv + kv_head) * s;
  load_rows(sm.q, kStride, q + (q_base + q0) * kD, kBQ, kBQ);
  load_rows(sm.dout, kStride, dout + (q_base + q0) * kD, kBQ, kBQ);
  if (tid < kBQ) {
    sm.lse[tid] = lse[q_base + q0 + tid];
    sm.dsum[tid] = dsum[q_base + q0 + tid];
  }

  int num_tiles = s / kBK;
  if (causal) num_tiles = min(num_tiles, (q0 + kBQ - 1) / kBK + 1);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k, v and ds are consumed
    load_rows(sm.k, kStride, k + (kv_base + k0) * kD, kBK, kBK);
    load_rows(sm.v, kStride, v + (kv_base + k0) * kD, kBK, kBK);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;

#pragma unroll 2
    for (int d = 0; d < kD; d += 2) {
      float2 qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = ld2(&sm.q[(ty * 4 + i) * kStride + d]);
        dov[i] = ld2(&sm.dout[(ty * 4 + i) * kStride + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ld2(&sm.k[(tx + 16 * j) * kStride + d]);
        vv[j] = ld2(&sm.v[(tx + 16 * j) * kStride + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, sc[i][j]));
          dp[i][j] = fmaf(dov[i].x, vv[j].x, fmaf(dov[i].y, vv[j].y, dp[i][j]));
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float row_lse = sm.lse[r];
      const float row_d = sm.dsum[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = !causal || k0 + tx + 16 * j <= q0 + r;
        const float p = valid ? __expf(sc[i][j] * scale - row_lse) : 0.f;
        sm.ds[r * kPStride + tx + 16 * j] = p * (dp[i][j] - row_d) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sm.ds[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = __bfloat162float(sm.k[kk * kStride + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16* row = dq + (q_base + q0 + ty * 4 + i) * kD;
#pragma unroll
    for (int c = 0; c < 8; ++c) row[tx + 16 * c] = __float2bfloat16(acc[i][c]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     float* __restrict__ dk_part, float* __restrict__ dv_part,
                     int hq, int hkv, int s, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);

  const int k0 = blockIdx.x * kBK;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // key rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // query columns tx + 16*j, output columns tx + 16*c

  const size_t q_base = (size_t)(batch * hq + head) * s;
  const size_t kv_base = (size_t)(batch * hkv + kv_head) * s;
  load_rows(sm.k, kStride, k + (kv_base + k0) * kD, kBK, kBK);
  load_rows(sm.v, kStride, v + (kv_base + k0) * kD, kBK, kBK);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Only query tiles at or below the diagonal see this key tile.
  const int first = causal ? k0 / kBQ : 0;
  for (int t = first; t < s / kBQ; ++t) {
    const int q0 = t * kBQ;
    __syncthreads();  // the previous tile's q, dO, p and ds are consumed
    load_rows(sm.q, kStride, q + (q_base + q0) * kD, kBQ, kBQ);
    load_rows(sm.dout, kStride, dout + (q_base + q0) * kD, kBQ, kBQ);
    if (tid < kBQ) {
      sm.lse[tid] = lse[q_base + q0 + tid];
      sm.dsum[tid] = dsum[q_base + q0 + tid];
    }
    __syncthreads();

    float sc[4][4], dp[4][4];  // transposed: [key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;

#pragma unroll 2
    for (int d = 0; d < kD; d += 2) {
      float2 kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ld2(&sm.k[(ty * 4 + i) * kStride + d]);
        vv[i] = ld2(&sm.v[(ty * 4 + i) * kStride + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = ld2(&sm.q[(tx + 16 * j) * kStride + d]);
        dov[j] = ld2(&sm.dout[(tx + 16 * j) * kStride + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(kv[i].x, qv[j].x, fmaf(kv[i].y, qv[j].y, sc[i][j]));
          dp[i][j] = fmaf(vv[i].x, dov[j].x, fmaf(vv[i].y, dov[j].y, dp[i][j]));
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool valid = !causal || k0 + r <= q0 + c;
        const float p = valid ? __expf(sc[i][j] * scale - sm.lse[c]) : 0.f;
        sm.p[r * kPStride + c] = p;
        sm.ds[r * kPStride + c] = p * (dp[i][j] - sm.dsum[c]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < kBQ; ++qq) {
      float pv[4], dsv[4], dov[8], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sm.p[(ty * 4 + i) * kPStride + qq];
        dsv[i] = sm.ds[(ty * 4 + i) * kPStride + qq];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        dov[c] = __bfloat162float(sm.dout[qq * kStride + tx + 16 * c]);
        qv[c] = __bfloat162float(sm.q[qq * kStride + tx + 16 * c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (q_base + k0 + ty * 4 + i) * kD;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      dk_part[row + tx + 16 * c] = dk[i][c];
      dv_part[row + tx + 16 * c] = dv[i][c];
    }
  }
}

bool bad_shape(int hq, int hkv, int s, int d) {
  return d != kD || hkv <= 0 || hq % hkv != 0 || s <= 0 || s % kBQ != 0;
}

}  // namespace

extern "C" int vtx_flash_fwd_lse(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int batch, int hq,
                                 int hkv, int s, int d, int causal,
                                 float scale, void* stream) {
  if (bad_shape(hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  return flash_fwd::launch_flash_fwd<true>(q, k, v, out, (float*)lse, batch, hq, hkv, s,
                                s, causal, scale, stream);
}

extern "C" int vtx_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dsum, void* dq, int batch, int hq,
                                int hkv, int s, int d, int causal, float scale,
                                void* stream) {
  if (bad_shape(hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DqSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s / kBQ, hq, batch);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)dsum, (__nv_bfloat16*)dq, hq, hkv, s, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int vtx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dsum, void* dk_part,
                                 void* dv_part, int batch, int hq, int hkv,
                                 int s, int d, int causal, float scale,
                                 void* stream) {
  if (bad_shape(hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DkvSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s / kBK, hq, batch);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)dsum, (float*)dk_part, (float*)dv_part, hq, hkv, s,
      causal, scale);
  return (int)cudaGetLastError();
}
