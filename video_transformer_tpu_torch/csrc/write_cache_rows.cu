// K2: a whole KV-cache row write, k and v in one launch, with the int8
// quantization of the new rows inside.
//
// Replaces video_transformer_tpu/ops/decode_attention.py::_batch_write_kernel
// (launched by _batch_row_write_pallas) and, for an int8 cache, the
// quantize_kv that the JAX package runs before it in XLA
// (video_transformer_tpu/models/lm.py::quantize_kv): for every batch row b,
// kv head h and j < W,
//   cache[rows[b], h, index[b] + j, :] = f(new[b, h, j, :])
// for the k and the v cache. With per-head scales (an int8 cache, bf16
// rows) f stores clamp(rint(f32(x) / scale[h]), -127, 127): a true IEEE
// division (this build has no fast-math; a multiplication by the
// reciprocal rounds some quotients to the other side of a half) and
// rintf's round half to even, as torch.round and jnp.round do, so the
// bytes equal quantize_kv's. Without scales the rows are already in the
// cache's dtype (int8 or bf16) and f is a copy. Every other element is left
// as it was; positions outside [0, S) are dropped (the engine reserves tail
// slack, so a real write never reaches them). The TPU kernel's 8-aligned
// read-modify-write region is a Mosaic tiling constraint; here each vector
// is stored where it belongs.
//
// What bounds it on an H100: bytes at a prefill's width, the launch at a
// decode step's. Each (batch row, kv head, k-or-v) slab of W x D elements
// is contiguous in the new rows and in the cache, so the least time is the
// slabs' bytes read once and written once over 3.35 TB/s: 3.5 MB and ~1 us
// a layer at the base prefill (W = 1,152), 13 MB and ~4 us at the 7b one
// (W = 2,176), 3 KB at a decode step (W = 3), far below the launch. One
// launch therefore does the whole write, quantization included, where the
// eager route ran about ten elementwise kernels before it. A thread moves
// one 16-byte vector of the new rows (8 bf16 or 16 int8 elements of one
// position) and stores 16 bytes (a copy) or 8 (8 int8 quantized); the grid
// is (vector chunk of the slab, kv head, batch row x k-or-v), so a
// prefill's slabs spread over hundreds to thousands of blocks on the 132
// SMs, while at W = 3 one block of 64 threads (bf16 rows) or 32 (int8
// rows) covers a slab. Each thread issues all its loads (its vector, index,
// rows and the scale) before it uses any, so a write costs one memory round
// trip and a store. There is nothing for the tensor cores, TMA or a
// cluster to do in a copy this size (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ uint32_t quantize(float x, float scale) {
  return (uint32_t)(int)fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f) & 0xffu;
}

// Two bf16 (element 0 in the low half) -> two int8 in the low 16 bits.
__device__ __forceinline__ uint32_t quantize_pair(uint32_t two, float scale) {
  return quantize(__uint_as_float(two << 16), scale) |
         quantize(__uint_as_float(two & 0xffff0000u), scale) << 8;
}

// Src: the element type of the new rows; a thread's vector is 16 bytes of
// them. kQuant: bf16 rows stored as int8 under the head's scale.
template <typename Src, bool kQuant>
__global__ void __launch_bounds__(kMaxThreads)
write_rows_kernel(void* __restrict__ k_cache, void* __restrict__ v_cache,
                  const Src* __restrict__ k_new, const Src* __restrict__ v_new,
                  const int* __restrict__ index, const int* __restrict__ rows,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, int hkv, int s_cache,
                  int width, int d) {
  constexpr int kVec = 16 / sizeof(Src);  // elements a thread moves
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= width * d / kVec) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool is_v = blockIdx.z & 1;
  const int elem = chunk * kVec;  // within the slab: position elem / d
  // Every load before the first use: one memory round trip, not a chain.
  const Src* src = (is_v ? v_new : k_new) + (size_t)(b * hkv + h) * width * d + elem;
  const uint4 in = __ldg(reinterpret_cast<const uint4*>(src));
  const int start = index[b];
  const int phys = rows ? rows[b] : b;
  float scale = 1.0f;
  if constexpr (kQuant) scale = (is_v ? v_scale : k_scale)[h];
  const int pos = start + elem / d;
  if (pos < 0 || pos >= s_cache) return;
  const size_t at = (((size_t)phys * hkv + h) * s_cache + pos) * d + elem % d;
  if constexpr (kQuant) {
    const uint2 out = make_uint2(quantize_pair(in.x, scale) | quantize_pair(in.y, scale) << 16,
                                 quantize_pair(in.z, scale) | quantize_pair(in.w, scale) << 16);
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(is_v ? v_cache : k_cache) + at) = out;
  } else {
    *reinterpret_cast<uint4*>(static_cast<Src*>(is_v ? v_cache : k_cache) + at) = in;
  }
}

template <typename Src, bool kQuant>
int launch(void* k_cache, void* v_cache, const void* k_new, const void* v_new,
           const int* index, const int* rows, const float* k_scale,
           const float* v_scale, int batch, int hkv, int s_cache, int width,
           int d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Src);
  const int chunks = width * d / kVec;  // a slab's vectors
  const int threads = chunks < kMaxThreads ? (chunks + 31) / 32 * 32 : kMaxThreads;
  const dim3 grid((chunks + threads - 1) / threads, hkv, 2 * batch);
  write_rows_kernel<Src, kQuant><<<grid, threads, 0, stream>>>(
      k_cache, v_cache, (const Src*)k_new, (const Src*)v_new, index, rows,
      k_scale, v_scale, hkv, s_cache, width, d);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// cache_bytes / new_bytes: the element sizes of the caches and of the new
// rows. k_scale and v_scale go together: with them the caches are int8 and
// the rows bf16 (cache_bytes 1, new_bytes 2); without them both sizes are
// equal, 1 or 2. rows may be null (row b is physical row b). The caches and
// the rows must be 16-byte aligned and D a multiple of 16, so that every
// vector lies inside one position and on its own 16 bytes.
extern "C" int vtx_write_cache_rows(void* k_cache, void* v_cache,
                                    const void* k_new, const void* v_new,
                                    const void* index, const void* rows,
                                    const void* k_scale, const void* v_scale,
                                    int batch, int hkv, int s_cache, int width,
                                    int d, int cache_bytes, int new_bytes,
                                    void* stream) {
  if (batch <= 0 || batch > 32767 || hkv <= 0 || hkv > 65535 || width <= 0 ||
      s_cache <= 0 || d <= 0 || d % 16 || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned(k_cache) || !aligned(v_cache) || !aligned(k_new) || !aligned(v_new))
    return (int)cudaErrorMisalignedAddress;
  const int* idx = (const int*)index;
  const int* row_table = (const int*)rows;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (k_scale && cache_bytes == 1 && new_bytes == 2)
    return launch<uint16_t, true>(k_cache, v_cache, k_new, v_new, idx, row_table, ks, vs,
                                  batch, hkv, s_cache, width, d, s);
  if (!k_scale && cache_bytes == 1 && new_bytes == 1)
    return launch<int8_t, false>(k_cache, v_cache, k_new, v_new, idx, row_table, ks, vs,
                                 batch, hkv, s_cache, width, d, s);
  if (!k_scale && cache_bytes == 2 && new_bytes == 2)
    return launch<uint16_t, false>(k_cache, v_cache, k_new, v_new, idx, row_table, ks, vs,
                                   batch, hkv, s_cache, width, d, s);
  return (int)cudaErrorInvalidValue;
}
