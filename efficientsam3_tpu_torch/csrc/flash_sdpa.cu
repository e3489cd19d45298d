// Flash scaled-dot-product attention forward at head dim 256 on fp32
// operands, for Hopper (sm_90a): the fp32 instantiation of flash_qsmem.cuh's
// mma.sync kernel.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_fwd`
// (`_kernel` :57, its pallas_call at :144) where the default build runs the
// tracker's single-head memory attention in fp32: self-attention q/k/v (8,
// 1, 5184, 256), 4 launches a tracked frame, and the plain path's
// cross-attention (a training clip's). It computes softmax(Q K^T * scale +
// key_bias) V with an fp32 online softmax, P kept fp32 (split into bf16 hi
// and lo parts with the operands, attn_common.cuh), a (B, Lk) f32 additive
// key bias (-1e9 masks), key tiles whose keys are all masked skipped, and an
// optional per-row log-sum-exp; ragged Lq / Lk are masked inside the kernel
// (rows past Lq are not written, keys past Lk score -1e9), and a row whose
// keys are all masked finishes as 0 with lse = -1e9.
//
// Every other forward is a wgmma kernel: bf16 at d = 32, 64, 80 and 256 is
// flash_sdpa_h.cu's, fp32 at d = 32, 64 and 80 flash_sdpa_h_fp32.cu's. This
// entry refuses them (the mma.sync register kernel that served fp32 at
// d = 32, 64 and 80, and this file's bf16 d = 256 route, are gone).
//
// Bound on the H100 at the self-attention shape with 3 of 8 slots live: the
// function's ~82 GFLOP of products at the TF32 rate, 0.1668 ms, against
// 2.2385 ms measured (flash_qsmem.cuh: Q from shared memory, K and V by
// cp.async with no pipelining, three split mma.sync products a part pair,
// 199 KB of shared memory, one block an SM).

#include "flash_qsmem.cuh"

using namespace attn;

// q, k, v and o (B, H, N, 256) float32 (fp32 != 0, d = 256: anything else
// is refused with cudaErrorInvalidValue) with (batch, head, row) element
// strides; key_bias (B, Lk) f32 contiguous; lse (B, H, Lq) f32 or null.
extern "C" int flash_sdpa_fwd(const void* q, const void* k, const void* v,
                              const void* key_bias, void* o, void* lse, int B,
                              int H, int lq, int lk, int d, int fp32, float sm_scale,
                              long long sqb, long long sqh, long long sqn,
                              long long skb, long long skh, long long skn,
                              long long svb, long long svh, long long svn,
                              long long sob, long long soh, long long son,
                              void* stream) {
  if (!fp32 || d != 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch_qsmem<256, 256, float>(q, k, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb,
                                       sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son,
                                       static_cast<cudaStream_t>(stream));
}
