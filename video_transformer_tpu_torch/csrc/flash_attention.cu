// K1: flash attention forward, bf16 in and out, f32 online softmax.
//
// Replaces video_transformer_tpu/ops/attention.py::_flash_kernel (launched
// by _flash_attention_pallas through flash_attention). The kernel body is
// flash_fwd_kernel<false> in flash_fwd.cuh, which K7a shares.
//
// What bounds it on an H100: at the main path's shapes (S = 1024-1152,
// D = 128) attention is compute-bound: 4*S*S*D operations against 4*S*D*2
// bytes of q/k/v/o per (batch, head), about 250 operations per byte. This
// first version runs the two products on the f32 FMA units (67 TF/s peak),
// not the tensor cores, so it sits at a fraction of the 989 TF/s bf16 bound;
// wgmma tiles fed by TMA are the later step.

#include "flash_fwd.cuh"

extern "C" int vtx_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int batch, int hq, int hkv,
                                   int sq, int sk, int d, int causal,
                                   float scale, void* stream) {
  if (d != kD || hq % hkv != 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  return launch_flash_fwd<false>(q, k, v, out, nullptr, batch, hq, hkv, sq, sk,
                                 causal, scale, stream);
}
