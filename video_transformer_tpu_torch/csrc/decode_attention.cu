// K3: paged, length-aware decode attention over an int8 or bf16 KV cache.
//
// Replaces video_transformer_tpu/ops/decode_attention.py::_kernel_pipelined
// (and _kernel, the same math), launched by _decode_attention_pallas. For
// q [B, Hq, W, D] against caches [R, Hkv, S, D] at physical row rows[b]
// (identity when rows is null), query column j sees cache positions
// < lengths[b] + j; only the ceil((lengths[b] + W - 1) / 64) cache tiles
// inside that extent are read. The G*W query rows of a kv head's group fold
// onto that head, so each cache tile is read once for all of them. For an
// int8 cache the per-head scales factor out: q is scaled by k_scale[h] and
// the output by v_scale[h], while the int8 values convert to f32 in
// registers.
//
// What bounds it on an H100: bytes. A decode step does 4*G*W*D operations per
// cache position against 2*D bytes (int8 k and v): 24 operations per byte at
// G*W = 12, far under the card's ~295. The least time is the valid prefix's
// bytes over 3.35 TB/s, a few microseconds at serving lengths, so latency
// and parallelism decide the real time. The TPU kernel walks the sequence
// inside one program per (row, head) with its DMAs double-buffered; on the
// GPU one block per (row, head) would put only B*Hkv of 132 SMs to work
// (4 at batch 2), each waiting on one tile's loads at a time.
//
// Design (flash-decoding): the sequence splits into chunks of whole 64-row
// tiles, one block per (chunk, kv head, batch row), so batch 2 at 1.4k
// positions runs ~90 blocks. Each block of 128 threads keeps the folded q
// rows (at most 16) in shared memory as f32, loads its k and v tiles with
// 16-byte loads into registers one tile ahead of the compute, and runs an
// f32 online softmax: scores with one key column per thread, softmax with
// one warp per row, P V with one output column per thread. It writes its
// unnormalized partial (acc, running max, running sum). Scores and P V read
// shared memory four elements at a time. A second kernel, one block per
// (q row, kv head, batch row), weighs the partials of its row (one split per
// thread), sums them with independent loads and applies v_scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kMaxRows = 16;  // G * W: 4 * 3 = 12 on the base preset
constexpr int kMaxSplits = kThreads;  // the combine gives each split a thread
constexpr int kKStride = kD + 4;  // elements per shared k row (padding: banks)
constexpr int kSStride = kBK + 4;  // f32 per probability row (16-byte rows)
constexpr float kNegInf = -1e30f;
static_assert(kThreads == kD, "P V maps one thread to each output column");

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements (4-byte aligned for int8, 8-byte for bf16) as f32.
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

template <typename T>
constexpr int smem_bytes() {
  return (kMaxRows * kD + kMaxRows * kSStride + 3 * kMaxRows) * (int)sizeof(float) +
         (kBK * kKStride + kBK * kD) * (int)sizeof(T);
}

// One tile of k and v (kBK rows of kD elements each) held in registers as
// 16-byte chunks, so the next tile's loads are in flight during compute.
template <typename T>
struct TileRegs {
  static constexpr int kRowChunks = kD * (int)sizeof(T) / 16;
  static constexpr int kPerThread = kBK * kRowChunks / kThreads;
  uint4 k[kPerThread];
  uint4 v[kPerThread];

  __device__ __forceinline__ void load(const T* kb, const T* vb, int row0, int s_cache) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kRowChunks;
      const int col = c % kRowChunks;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < s_cache) {
        k[i] = reinterpret_cast<const uint4*>(kb + (size_t)(row0 + r) * kD)[col];
        v[i] = reinterpret_cast<const uint4*>(vb + (size_t)(row0 + r) * kD)[col];
      }
    }
  }

  __device__ __forceinline__ void store(T* sk, T* sv) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kRowChunks;
      const int col = c % kRowChunks;
      // k rows are padded to a 4-byte multiple: store the chunk as words.
      uint32_t* kw = reinterpret_cast<uint32_t*>(sk + r * kKStride) + col * 4;
      kw[0] = k[i].x;
      kw[1] = k[i].y;
      kw[2] = k[i].z;
      kw[3] = k[i].w;
      reinterpret_cast<uint4*>(sv + r * kD)[col] = v[i];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const T* __restrict__ k_cache,
                      const T* __restrict__ v_cache,
                      const int* __restrict__ lengths,
                      const int* __restrict__ rows,
                      const float* __restrict__ k_scale,
                      float* __restrict__ part_acc, float* __restrict__ part_ml,
                      int hq, int hkv, int s_cache, int width,
                      int tiles_per_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kMaxRows][kD]
  float* ss = sq + kMaxRows * kD;                   // [kMaxRows][kSStride]
  float* s_m = ss + kMaxRows * kSStride;            // running max per row
  float* s_l = s_m + kMaxRows;                      // running sum per row
  float* s_alpha = s_l + kMaxRows;                  // this tile's rescale
  T* sk = reinterpret_cast<T*>(s_alpha + kMaxRows);  // [kBK][kKStride]
  T* sv = sk + kBK * kKStride;                       // [kBK][kD]

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = hq / hkv;
  const int nrows = group * width;
  const int length = lengths[b];
  const int max_len = min(length + width - 1, s_cache);
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, (max_len + kBK - 1) / kBK);
  const size_t part = ((size_t)(b * hkv + h) * splits + split) * nrows;

  if (tile_begin >= tile_end) {  // this chunk lies past the row's extent
    for (int r = 0; r < nrows; ++r) part_acc[(part + r) * kD + tid] = 0.f;
    for (int r = tid; r < nrows; r += kThreads) {
      part_ml[(part + r) * 2] = kNegInf;
      part_ml[(part + r) * 2 + 1] = 0.f;
    }
    return;
  }

  const int phys = rows ? rows[b] : b;
  const T* kb = k_cache + (size_t)(phys * hkv + h) * s_cache * kD;
  const T* vb = v_cache + (size_t)(phys * hkv + h) * s_cache * kD;
  TileRegs<T> regs;
  regs.load(kb, vb, tile_begin * kBK, s_cache);

  // The group's q rows are contiguous: heads h*G .. h*G+G-1, W columns each.
  const float qk_scale = scale * (k_scale ? k_scale[h] : 1.f);
  const size_t q_base = (size_t)(b * hq + h * group) * width * kD;
  for (int i = tid; i < nrows * kD / 8; i += kThreads) {  // 8 bf16 per 16-byte load
    const uint4 chunk = reinterpret_cast<const uint4*>(q + q_base)[i];
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&chunk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(pairs[j]);
      sq[i * 8 + 2 * j] = f.x * qk_scale;
      sq[i * 8 + 2 * j + 1] = f.y * qk_scale;
    }
  }
  for (int r = tid; r < nrows; r += kThreads) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }

  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  const int col = tid % kBK;   // score column owned in the QK phase
  const int row0 = tid / kBK;  // first of this thread's rows (step 2)
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int t = tile_begin; t < tile_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // q staged; the previous tile's k, v, p consumed
    regs.store(sk, sv);
    __syncthreads();
    if (t + 1 < tile_end) regs.load(kb, vb, k0 + kBK, s_cache);

    float dot[kMaxRows / 2];
#pragma unroll
    for (int i = 0; i < kMaxRows / 2; ++i) dot[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      const float4 kv = load4(sk + col * kKStride + d);
#pragma unroll
      for (int i = 0; i < kMaxRows / 2; ++i) {
        const int r = row0 + 2 * i;
        if (r < nrows) dot[i] = dot4(*reinterpret_cast<const float4*>(sq + r * kD + d), kv, dot[i]);
      }
    }
    const int pos = k0 + col;
#pragma unroll
    for (int i = 0; i < kMaxRows / 2; ++i) {
      const int r = row0 + 2 * i;
      if (r < nrows) {
        const bool valid = pos < length + r % width && pos < s_cache;
        ss[r * kSStride + col] = valid ? dot[i] : kNegInf;
      }
    }
    __syncthreads();

    for (int r = warp; r < nrows; r += kThreads / 32) {
      const float a = ss[r * kSStride + lane];
      const float c = ss[r * kSStride + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float pa = a == kNegInf ? 0.f : __expf(a - m_new);
      const float pc = c == kNegInf ? 0.f : __expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ss[r * kSStride + lane] = pa;
      ss[r * kSStride + lane + 32] = pc;
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < nrows) acc[r] *= s_alpha[r];
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      const float4 vv = make_float4(to_f32(sv[kk * kD + tid]), to_f32(sv[(kk + 1) * kD + tid]),
                                    to_f32(sv[(kk + 2) * kD + tid]), to_f32(sv[(kk + 3) * kD + tid]));
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < nrows) acc[r] = dot4(*reinterpret_cast<const float4*>(ss + r * kSStride + kk), vv, acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
    if (r < nrows) part_acc[(part + r) * kD + tid] = acc[r];
  for (int r = tid; r < nrows; r += kThreads) {
    part_ml[(part + r) * 2] = s_m[r];
    part_ml[(part + r) * 2 + 1] = s_l[r];
  }
}

// Merge the partials of one q row: out = sum_s e^(m_s - m) acc_s / sum_s
// e^(m_s - m) l_s, one block per (row, kv head, batch row), one split's
// (max, sum) per thread and one output column per thread.
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const float* __restrict__ v_scale,
                      __nv_bfloat16* __restrict__ out, int hq, int hkv,
                      int width, int splits) {
  __shared__ float s_weight[kMaxSplits];
  __shared__ float s_red[2][kThreads / 32];
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = hq / hkv;
  const int nrows = group * width;
  const size_t part0 = (size_t)(b * hkv + h) * splits * nrows + r;

  float m_s = kNegInf, l_s = 0.f;
  if (tid < splits) {
    m_s = part_ml[(part0 + (size_t)tid * nrows) * 2];
    l_s = part_ml[(part0 + (size_t)tid * nrows) * 2 + 1];
  }
  float m = l_s > 0.f ? m_s : kNegInf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) s_red[0][warp] = m;
  __syncthreads();
  m = s_red[0][0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_red[0][w]);
  const float weight = l_s > 0.f ? __expf(m_s - m) : 0.f;
  if (tid < splits) s_weight[tid] = weight;
  float den = weight * l_s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) s_red[1][warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) den += s_red[1][w];

  float num = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s)
    num = fmaf(s_weight[s], part_acc[(part0 + (size_t)s * nrows) * kD + tid], num);
  const float out_scale = v_scale ? v_scale[h] : 1.f;
  const size_t out_base = (size_t)(b * hq + h * group) * width * kD;
  out[out_base + (size_t)r * kD + tid] = __float2bfloat16(num / fmaxf(den, 1e-30f) * out_scale);
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* lengths, const int* rows, const float* k_scale,
           const float* v_scale, void* out, float* part_acc, float* part_ml,
           int batch, int hq, int hkv, int s_cache, int width, int splits,
           int tiles_per_split, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_partial_kernel<T><<<dim3(splits, hkv, batch), kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const T*)k_cache, (const T*)v_cache, lengths,
      rows, k_scale, part_acc, part_ml, hq, hkv, s_cache, width,
      tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nrows = (hq / hkv) * width;
  decode_combine_kernel<<<dim3(nrows, hkv, batch), kThreads, 0, stream>>>(
      part_acc, part_ml, v_scale, (__nv_bfloat16*)out, hq, hkv, width, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vtx_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lengths,
                                    const void* rows, const void* k_scale,
                                    const void* v_scale, void* out,
                                    void* part_acc, void* part_ml, int batch,
                                    int hq, int hkv, int s_cache, int width,
                                    int d, int splits, int tiles_per_split,
                                    int cache_is_int8, float scale,
                                    void* stream) {
  if (d != kD || hq % hkv != 0 || (hq / hkv) * width > kMaxRows || width <= 0 ||
      splits <= 0 || splits > kMaxSplits || tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (cache_is_int8)
    return launch<int8_t>(q, k_cache, v_cache, (const int*)lengths,
                          (const int*)rows, (const float*)k_scale,
                          (const float*)v_scale, out, (float*)part_acc,
                          (float*)part_ml, batch, hq, hkv, s_cache, width,
                          splits, tiles_per_split, scale, (cudaStream_t)stream);
  return launch<__nv_bfloat16>(q, k_cache, v_cache, (const int*)lengths,
                               (const int*)rows, (const float*)k_scale,
                               (const float*)v_scale, out, (float*)part_acc,
                               (float*)part_ml, batch, hq, hkv, s_cache, width,
                               splits, tiles_per_split, scale,
                               (cudaStream_t)stream);
}
