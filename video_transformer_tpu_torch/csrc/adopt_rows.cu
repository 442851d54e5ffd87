// K4: adopt staged prefills into free rows of the paged KV pool.
//
// Replaces video_transformer_tpu/ops/decode_attention.py::_adopt_kernel
// (launched by _adopt_rows_pallas): dst[rows[i], h, :park_len, :] =
// src[i, h, :park_len, :] for every lane i < count and every kv head h, for
// a layer's k pool and, in the same launch, its v pool. Lanes at or past
// ``count`` are padding and write nothing, even where their row collides
// with a valid lane's; a row outside the pool is dropped, as K2 drops a
// position outside the cache.
//
// What bounds it on an H100: bytes, and nothing else. It does no arithmetic:
// each (lane, head) region of park_len * D elements is contiguous in src and
// in dst, so the least time is 2 * count * Hkv * park_len * D * elem bytes
// (read once, written once, k and v) over 3.35 TB/s: 21 MB and ~6 us per
// layer at the batcher's base shapes (8 lanes, park_len 1,280, bf16). The
// TPU kernel issues one HBM-to-HBM DMA per lane from a sequential grid. On
// the GPU the copy needs many blocks in flight to reach the memory rate, so
// the grid is (region chunk, head x k-or-v, lane): 20 x 4 x 8 = 640 blocks of
// 256 threads at those shapes. Each thread moves four 16-byte vectors,
// issuing its four loads before its four stores. A block of a pad lane
// returns before it reads anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors per thread
constexpr int kBlockVecs = kThreads * kVecs;

__global__ void __launch_bounds__(kThreads)
adopt_rows_kernel(uint4* __restrict__ dst_k, uint4* __restrict__ dst_v,
                  const uint4* __restrict__ src_k,
                  const uint4* __restrict__ src_v,
                  const int* __restrict__ rows, int count, int pool_rows,
                  int hkv, int s_cache, int s_park, int park_len,
                  int pos_vecs) {
  const int lane = blockIdx.z;
  if (lane >= count) return;  // a pad lane
  const int row = rows[lane];
  if (row < 0 || row >= pool_rows) return;
  const int h = blockIdx.y % hkv;
  const bool is_v = blockIdx.y >= hkv;
  const uint4* src = (is_v ? src_v : src_k) + (size_t)(lane * hkv + h) * s_park * pos_vecs;
  uint4* dst = (is_v ? dst_v : dst_k) + (size_t)(row * hkv + h) * s_cache * pos_vecs;
  const int n = park_len * pos_vecs;
  const int base = blockIdx.x * kBlockVecs + threadIdx.x;
  uint4 buf[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = base + j * kThreads;
    if (i < n) buf[j] = src[i];
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = base + j * kThreads;
    if (i < n) dst[i] = buf[j];
  }
}

}  // namespace

// dst_v and src_v may both be null (one pool). row_bytes = D * element size
// must be a multiple of 16, and every pointer 16-byte aligned.
extern "C" int vtx_adopt_rows(void* dst_k, void* dst_v, const void* src_k,
                              const void* src_v, const void* rows, int lanes,
                              int count, int pool_rows, int hkv, int s_cache,
                              int s_park, int park_len, int row_bytes,
                              void* stream) {
  if ((dst_v == nullptr) != (src_v == nullptr) || row_bytes <= 0 ||
      row_bytes % 16 || hkv <= 0 || park_len < 0 || park_len > s_park ||
      park_len > s_cache || count < 0 || count > lanes || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (count == 0 || park_len == 0) return (int)cudaSuccess;
  const int pos_vecs = row_bytes / 16;
  const int chunks = (park_len * pos_vecs + kBlockVecs - 1) / kBlockVecs;
  const dim3 grid(chunks, hkv * (dst_v ? 2 : 1), lanes);
  adopt_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)dst_k, (uint4*)dst_v, (const uint4*)src_k, (const uint4*)src_v,
      (const int*)rows, count, pool_rows, hkv, s_cache, s_park, park_len,
      pos_vecs);
  return (int)cudaGetLastError();
}
