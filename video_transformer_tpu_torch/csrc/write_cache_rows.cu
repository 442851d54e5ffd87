// K2: in-place KV-cache row write for one decode step, k and v in one launch.
//
// Replaces video_transformer_tpu/ops/decode_attention.py::_batch_write_kernel
// (launched by _batch_row_write_pallas): cache[rows[b], h, index[b] + j, :] =
// new[b, h, j, :] for j < W, for the k and the v cache, leaving every other
// element untouched. The TPU kernel's 8-aligned read-modify-write region is a
// Mosaic tiling constraint; on the GPU each element is stored directly.
// Positions at or past the cache end are dropped (the engine reserves tail
// slack, so a real step never reaches them).
//
// What bounds it on an H100: bytes, and at decode sizes launch latency: a
// step moves 2 * B * Hkv * W * D elements (3 KB at base int8, batch 2), so
// the work is microseconds below the ~2-4 us a launch costs. The design
// therefore spends one launch for both caches: one block per (kv head, batch
// row, k-or-v), each thread copying whole elements of the W x D slab, which
// is contiguous in both the new rows and the cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
write_rows_kernel(T* __restrict__ k_cache, T* __restrict__ v_cache,
                  const T* __restrict__ k_new, const T* __restrict__ v_new,
                  const int* __restrict__ index, const int* __restrict__ rows,
                  int hkv, int s_cache, int width, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  T* cache = blockIdx.z ? v_cache : k_cache;
  const T* src = (blockIdx.z ? v_new : k_new) + (size_t)(b * hkv + h) * width * d;
  const int phys = rows ? rows[b] : b;
  const int start = index[b];
  T* dst = cache + ((size_t)(phys * hkv + h) * s_cache + start) * d;
  const int n = width * d;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pos = start + i / d;
    if (pos >= 0 && pos < s_cache) dst[i] = src[i];
  }
}

template <typename T>
int launch(void* k_cache, void* v_cache, const void* k_new, const void* v_new,
           const int* index, const int* rows, int batch, int hkv, int s_cache,
           int width, int d, cudaStream_t stream) {
  dim3 grid(hkv, batch, 2);
  write_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      (T*)k_cache, (T*)v_cache, (const T*)k_new, (const T*)v_new, index, rows,
      hkv, s_cache, width, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vtx_write_cache_rows(void* k_cache, void* v_cache,
                                    const void* k_new, const void* v_new,
                                    const void* index, const void* rows,
                                    int batch, int hkv, int s_cache, int width,
                                    int d, int elem_bytes, void* stream) {
  const int* idx = (const int*)index;
  const int* row_table = (const int*)rows;
  if (elem_bytes == 1)
    return launch<int8_t>(k_cache, v_cache, k_new, v_new, idx, row_table, batch,
                          hkv, s_cache, width, d, (cudaStream_t)stream);
  if (elem_bytes == 2)
    return launch<uint16_t>(k_cache, v_cache, k_new, v_new, idx, row_table,
                            batch, hkv, s_cache, width, d, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
