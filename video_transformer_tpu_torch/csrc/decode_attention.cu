// K3: paged, length-aware decode attention over an int8 or bf16 KV cache,
// and K5: the same attention with the step's cache row write fused in.
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
//
// Any number of folded rows: the G*W rows of a kv head split into chunks of
// at most kMaxRows, one block per (chunk, split); every chunk's block reads
// the same tiles (L2 serves the repeats) and writes its own rows' partials,
// so the per-row combine is unchanged. Like the TPU kernel, which pads G*W
// to a multiple of 8, it has no ceiling on the row count.
//
// K5 replaces video_transformer_tpu/ops/decode_attention.py::_fused_kernel
// (launched by _decode_attention_update_pallas): K2's write of the W new k/v
// rows at positions [index, index + W) of physical row rows[b], then K3's
// attention with lengths = index + 1, in one launch (bf16 caches only, as in
// the JAX package). The TPU kernel's 8-aligned read-modify-write DMA region
// is a Mosaic tiling constraint and is not carried over. Here the block whose
// split owns a new position's tile takes that row from k_new/v_new instead
// of the cache, and the chunk-0 block of that split stores it to the cache.
// Each position has one writer, and no block of the launch reads from the
// cache a position the launch writes, so no grid-wide ordering is needed.
// The values and the order of arithmetic are K3's after K2, so the output
// and the cache equal K2 + K3 bit for bit. What bounds it is what bounds K3;
// it saves K2's launch (one per layer per decode step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kMaxRows = 16;  // folded q rows per block (G * W = 12 on the base preset)
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

  // K5: positions [first, first + width) come from the step's new rows
  // (kn, vn: [width][kD]) instead of the cache, and ``writer`` stores them
  // into the cache (kc, vc) as it goes.
  __device__ __forceinline__ void load_fused(T* kc, T* vc, const T* kn, const T* vn,
                                             int row0, int s_cache, int first,
                                             int width, bool writer) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kRowChunks;
      const int col = c % kRowChunks;
      const int pos = row0 + r;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (pos >= s_cache) continue;
      uint4* kdst = reinterpret_cast<uint4*>(kc + (size_t)pos * kD) + col;
      uint4* vdst = reinterpret_cast<uint4*>(vc + (size_t)pos * kD) + col;
      if (pos >= first && pos < first + width) {
        k[i] = reinterpret_cast<const uint4*>(kn + (size_t)(pos - first) * kD)[col];
        v[i] = reinterpret_cast<const uint4*>(vn + (size_t)(pos - first) * kD)[col];
        if (writer) {
          *kdst = k[i];
          *vdst = v[i];
        }
      } else {
        k[i] = *kdst;
        v[i] = *vdst;
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

// One block per (split, kv head x row chunk, batch row). kFused selects K5:
// ``lengths`` then holds the cache index before the step (the write offset),
// and the attention sees index + 1 positions for query column 0.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      T* __restrict__ k_cache,
                      T* __restrict__ v_cache,
                      const T* __restrict__ k_new,
                      const T* __restrict__ v_new,
                      const int* __restrict__ lengths,
                      const int* __restrict__ rows,
                      const float* __restrict__ k_scale,
                      float* __restrict__ part_acc, float* __restrict__ part_ml,
                      int hq, int hkv, int s_cache, int width,
                      int tiles_per_split, int row_chunks, float scale) {
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
  const int h = blockIdx.y / row_chunks;
  const int chunk = blockIdx.y % row_chunks;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = hq / hkv;
  const int nrows = group * width;           // folded rows of this kv head
  const int r0 = chunk * kMaxRows;           // this block's first row
  const int nr = min(kMaxRows, nrows - r0);  // and its row count
  const int first = kFused ? lengths[b] : 0;  // K5: the new rows' position
  const int length = kFused ? first + 1 : lengths[b];
  const int max_len = min(length + width - 1, s_cache);
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, (max_len + kBK - 1) / kBK);
  const size_t part = ((size_t)(b * hkv + h) * splits + split) * nrows + r0;

  if (tile_begin >= tile_end) {  // this chunk lies past the row's extent
    for (int r = 0; r < nr; ++r) part_acc[(part + r) * kD + tid] = 0.f;
    for (int r = tid; r < nr; r += kThreads) {
      part_ml[(part + r) * 2] = kNegInf;
      part_ml[(part + r) * 2 + 1] = 0.f;
    }
    return;
  }

  const int phys = rows ? rows[b] : b;
  T* kb = k_cache + (size_t)(phys * hkv + h) * s_cache * kD;
  T* vb = v_cache + (size_t)(phys * hkv + h) * s_cache * kD;
  const T* kn = kFused ? k_new + (size_t)(b * hkv + h) * width * kD : nullptr;
  const T* vn = kFused ? v_new + (size_t)(b * hkv + h) * width * kD : nullptr;
  TileRegs<T> regs;
  if (kFused)
    regs.load_fused(kb, vb, kn, vn, tile_begin * kBK, s_cache, first, width, chunk == 0);
  else
    regs.load(kb, vb, tile_begin * kBK, s_cache);

  // The group's q rows are contiguous: heads h*G .. h*G+G-1, W columns each;
  // this block takes rows r0 .. r0 + nr - 1 of them.
  const float qk_scale = scale * (k_scale ? k_scale[h] : 1.f);
  const size_t q_base = ((size_t)(b * hq + h * group) * width + r0) * kD;
  for (int i = tid; i < nr * kD / 8; i += kThreads) {  // 8 bf16 per 16-byte load
    const uint4 chunk8 = reinterpret_cast<const uint4*>(q + q_base)[i];
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&chunk8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(pairs[j]);
      sq[i * 8 + 2 * j] = f.x * qk_scale;
      sq[i * 8 + 2 * j + 1] = f.y * qk_scale;
    }
  }
  for (int r = tid; r < nr; r += kThreads) {
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
    if (t + 1 < tile_end) {
      if (kFused)
        regs.load_fused(kb, vb, kn, vn, k0 + kBK, s_cache, first, width, chunk == 0);
      else
        regs.load(kb, vb, k0 + kBK, s_cache);
    }

    float dot[kMaxRows / 2];
#pragma unroll
    for (int i = 0; i < kMaxRows / 2; ++i) dot[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      const float4 kv = load4(sk + col * kKStride + d);
#pragma unroll
      for (int i = 0; i < kMaxRows / 2; ++i) {
        const int r = row0 + 2 * i;
        if (r < nr) dot[i] = dot4(*reinterpret_cast<const float4*>(sq + r * kD + d), kv, dot[i]);
      }
    }
    const int pos = k0 + col;
#pragma unroll
    for (int i = 0; i < kMaxRows / 2; ++i) {
      const int r = row0 + 2 * i;
      if (r < nr) {
        const bool valid = pos < length + (r0 + r) % width && pos < s_cache;
        ss[r * kSStride + col] = valid ? dot[i] : kNegInf;
      }
    }
    __syncthreads();

    for (int r = warp; r < nr; r += kThreads / 32) {
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
      if (r < nr) acc[r] *= s_alpha[r];
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      const float4 vv = make_float4(to_f32(sv[kk * kD + tid]), to_f32(sv[(kk + 1) * kD + tid]),
                                    to_f32(sv[(kk + 2) * kD + tid]), to_f32(sv[(kk + 3) * kD + tid]));
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < nr) acc[r] = dot4(*reinterpret_cast<const float4*>(ss + r * kSStride + kk), vv, acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
    if (r < nr) part_acc[(part + r) * kD + tid] = acc[r];
  for (int r = tid; r < nr; r += kThreads) {
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

template <typename T, bool kFused>
int launch(const void* q, void* k_cache, void* v_cache, const void* k_new,
           const void* v_new, const int* lengths, const int* rows,
           const float* k_scale, const float* v_scale, void* out,
           float* part_acc, float* part_ml, int batch, int hq, int hkv,
           int s_cache, int width, int splits, int tiles_per_split, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nrows = (hq / hkv) * width;
  const int row_chunks = (nrows + kMaxRows - 1) / kMaxRows;
  decode_partial_kernel<T, kFused><<<dim3(splits, hkv * row_chunks, batch), kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (T*)k_cache, (T*)v_cache, (const T*)k_new, (const T*)v_new,
      lengths, rows, k_scale, part_acc, part_ml, hq, hkv, s_cache, width,
      tiles_per_split, row_chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3(nrows, hkv, batch), kThreads, 0, stream>>>(
      part_acc, part_ml, v_scale, (__nv_bfloat16*)out, hq, hkv, width, splits);
  return (int)cudaGetLastError();
}

bool valid_shape(int batch, int hq, int hkv, int width, int d, int splits,
                 int tiles_per_split) {
  return batch > 0 && hkv > 0 && d == kD && hq % hkv == 0 && width > 0 &&
         hkv * ((hq / hkv * width + kMaxRows - 1) / kMaxRows) <= 65535 &&
         splits > 0 && splits <= kMaxSplits && tiles_per_split > 0;
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
  if (!valid_shape(batch, hq, hkv, width, d, splits, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  // K3 only reads the caches; the kernel's pointers are non-const for K5.
  void* kc = const_cast<void*>(k_cache);
  void* vc = const_cast<void*>(v_cache);
  if (cache_is_int8)
    return launch<int8_t, false>(q, kc, vc, nullptr, nullptr, (const int*)lengths,
                                 (const int*)rows, (const float*)k_scale,
                                 (const float*)v_scale, out, (float*)part_acc,
                                 (float*)part_ml, batch, hq, hkv, s_cache, width,
                                 splits, tiles_per_split, scale, (cudaStream_t)stream);
  return launch<__nv_bfloat16, false>(q, kc, vc, nullptr, nullptr, (const int*)lengths,
                                      (const int*)rows, (const float*)k_scale,
                                      (const float*)v_scale, out, (float*)part_acc,
                                      (float*)part_ml, batch, hq, hkv, s_cache, width,
                                      splits, tiles_per_split, scale,
                                      (cudaStream_t)stream);
}

// K5 on bf16 caches: ``index`` [B] is each row's fill before the step.
extern "C" int vtx_decode_attention_update(const void* q, void* k_cache,
                                           void* v_cache, const void* k_new,
                                           const void* v_new, const void* index,
                                           const void* rows, void* out,
                                           void* part_acc, void* part_ml,
                                           int batch, int hq, int hkv,
                                           int s_cache, int width, int d,
                                           int splits, int tiles_per_split,
                                           float scale, void* stream) {
  if (!valid_shape(batch, hq, hkv, width, d, splits, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16, true>(q, k_cache, v_cache, k_new, v_new,
                                     (const int*)index, (const int*)rows,
                                     nullptr, nullptr, out, (float*)part_acc,
                                     (float*)part_ml, batch, hq, hkv, s_cache,
                                     width, splits, tiles_per_split, scale,
                                     (cudaStream_t)stream);
}
