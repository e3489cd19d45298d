// Flash scaled-dot-product attention forward for Hopper (sm_90a).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_fwd`
// (`_kernel`) and `_flash_fwd_packed` (`_packed_kernel`): one kernel for
// softmax(Q K^T * scale + key_bias) V with an fp32 online softmax, P cast
// to bf16 before the PV product, a (B, Lk) f32 additive key bias (-1e9
// masks), key tiles whose keys are all masked skipped, and an optional
// per-row log-sum-exp. The TPU kernel's head packing, transposed operands
// and ones-row denominator only filled the MXU's 128 lanes; here each
// (batch, head) runs on its own with m16n8k16 tensor-core products.
//
// Bound on the H100: at the fusion-encoder shape (1, 8, 5184, 32) the
// ~27.5 GFLOP of tensor-core work takes ~0.03 ms at the bf16 peak, while
// the 8 * 5184^2 exponentials take ~0.05 ms on the special-function units
// and the 2.6 MB of operands ~1 us: d = 32 makes this kernel bound by
// operations on the exponential, not by the matrix products. The design
// keeps S and P in registers (never in shared or device memory) and reads
// Q once per block; the staging of K/V is not pipelined yet (later work:
// cp.async/TMA double buffering, exp2 with a folded log2(e) scale).
//
// Semantics follow `_kernel`: ragged Lq/Lk are masked inside the kernel
// (rows past Lq are not written, keys past Lk score -1e9), and a row whose
// keys are all masked skips every tile and finishes as acc / max(l, 1e-30)
// = 0 with lse = -1e9.

#include "attn_common.cuh"

using namespace attn;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_sdpa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ key_bias,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int lq, int lk, float sm_scale,
                      long long sqb, long long sqh, long long sqn,
                      long long skb, long long skh, long long skn,
                      long long svb, long long svh, long long svn,
                      long long sob, long long soh, long long son) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vt[D][VPAD];
  __shared__ float bias_s[BK];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BQ + warp * 16;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  key_bias += (long long)b * lk;

  uint32_t qa[D / 16][4];
  load_q<D>(qa, q, sqn, row0, lq);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (lk + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int key0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    int live = 0;
    if (threadIdx.x < BK) {
      const int key = key0 + threadIdx.x;
      const float bv = key < lk ? key_bias[key] : NEG_INF;
      bias_s[threadIdx.x] = bv;
      live = bv > 0.5f * NEG_INF;
    }
    if (!__syncthreads_or(live)) continue;  // every key of the tile masked
    stage_kv<D>(ks, vt, k, skn, v, svn, key0, lk);
    __syncthreads();

    float s[BK / 8][4];
    qk_tile<D>(s, qa, ks);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float b0 = bias_s[j * 8 + 2 * t], b1 = bias_s[j * 8 + 2 * t + 1];
      s[j][0] = s[j][0] * sm_scale + b0;
      s[j][1] = s[j][1] * sm_scale + b1;
      s[j][2] = s[j][2] * sm_scale + b0;
      s[j][3] = s[j][3] * sm_scale + b1;
    }
    softmax_pv<D>(s, m, l, acc, vt);
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const int r0 = row0 + g, r1 = row0 + g + 8;
  o += b * sob + h * soh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(o + r0 * son + c) =
          __floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(o + r1 * son + c) =
          __floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (lse != nullptr && t == 0) {
    lse += (long long)bh * lq;
    if (r0 < lq) lse[r0] = m[0] > 0.5f * NEG_INF ? m[0] + logf(l0) : NEG_INF;
    if (r1 < lq) lse[r1] = m[1] > 0.5f * NEG_INF ? m[1] + logf(l1) : NEG_INF;
  }
}

extern "C" int flash_sdpa_fwd(const void* q, const void* k, const void* v,
                              const void* key_bias, void* o, void* lse, int B,
                              int H, int lq, int lk, int d, float sm_scale,
                              long long sqb, long long sqh, long long sqn,
                              long long skb, long long skh, long long skn,
                              long long svb, long long svh, long long svn,
                              long long sob, long long soh, long long son,
                              void* stream) {
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    flash_sdpa_fwd_kernel<32><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(key_bias),
        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, lq, lk,
        sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
