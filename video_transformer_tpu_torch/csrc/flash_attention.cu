// K1: flash attention forward, bf16 in and out, f32 online softmax.
//
// Replaces video_transformer_tpu/ops/attention.py::_flash_kernel (launched
// by _flash_attention_pallas through flash_attention). The kernel body is
// flash_fwd_kernel<false> in flash_fwd.cuh, which K7a shares.
//
// What bounds it on an H100: per (batch, head) attention does 4*Sq*Sk*D
// operations (about half of them when causal) against 2*(Sq+Sk)*D*2 bytes
// of q/k/v/o, so at the main paths' lengths (1024-2176, D = 128) the
// tensor cores' 989 TF/s set the bound, not HBM. The kernel runs both
// products on them with wgmma, fed by TMA copies that overlap the compute
// (the design note in flash_fwd.cuh); P V takes two bf16 products
// (P_hi + P_lo) to keep f32 P's accuracy.

#include "flash_fwd.cuh"

extern "C" int vtx_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int batch, int hq, int hkv,
                                   int sq, int sk, int d, int causal,
                                   float scale, void* stream) {
  if (d != flash_fwd::kD || hq % hkv != 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  return flash_fwd::launch_flash_fwd<false>(q, k, v, out, nullptr, batch, hq, hkv, sq, sk,
                                 causal, scale, stream);
}
