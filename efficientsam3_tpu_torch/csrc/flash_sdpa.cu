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
// Operand types (attn_common.cuh): bf16, or fp32 split into bf16 hi and lo
// parts with three products each, P kept fp32 (split the same way) as in
// JAX, where P is cast to the value dtype. The output is written in the
// operands' dtype, the LSE in fp32. bf16 at d = 32 (the fusion encoder's
// self-attention), d = 64 (the teacher's global blocks) and d = 80 (the
// vit_h student's) runs flash_sdpa_h.cu, the wgmma kernel; this file
// serves fp32 at d = 32, 64 and 80, and both dtypes at d = 256.
//
// Bound on the H100 at the fusion-encoder shape (1, 8, 5184, 32): ~27.5
// GFLOP of tensor-core work (~0.03 ms at the bf16 peak; ~0.06 ms at the
// tf32 rate for fp32 operands, while the fp32 instantiation's three split
// products take ~0.08 ms at the bf16 peak), 215 M exponentials (~0.05 ms
// on the special-function units) and 2.6 MB of bf16 operands (5.3 MB
// fp32, ~2 us). This kernel keeps S and P in registers and reads Q once
// per block; K and V are staged synchronously a 64-key tile at a time
// (flash_sdpa_h.cu's note says what that costs in bf16).
//
// Head dim 64 in fp32 (the default build of the SAM3 teacher's ViTDet
// global blocks, Q K V (1, 16, 5184, 64), 4 launches an encode_image) runs
// the same register kernel as d = 32: Q fragments, S and the accumulator in
// registers, K and V staged a 64-key tile at a time (~37 KB of static shared
// memory for the two parts). Per launch ~110 GFLOP of products (~0.22 ms at
// the tf32 rate) against 430 M exponentials (~0.10 ms): bound by the
// products. Under autograd its backward is flash_sdpa_bwd.cu's.
//
// Head dim 80 in fp32 (the default build of the vit_h SAM1 student's global
// blocks, 1280 wide in 16 heads: Q K V (1, 16, 4900, 80) at 1120^2, 4
// launches an encode_image) runs the same register kernel: five 16-wide
// k-steps of the score product and ten 8-wide n-tiles of the PV product.
// Per launch ~123 GFLOP of products (~0.248 ms at the tf32 rate) against
// 384 M exponentials (~0.09 ms): bound by the products. The fp32 tiles
// take ks[2][64][88] + vt[2][80][72] bf16 = 45.6 KB of the 48 KB of static
// shared memory; the rows of 88 and 72 elements keep the fragment reads
// free of bank conflicts. fp32 stays on mma.sync: wgmma's tf32 form needs
// both operands K-major, and V is not.
//
// Head dim 256 (the tracker's single-head memory attention, Q K V
// (8, 1, 5184, 256) in self-attention and 36352 keys in the plain
// cross-attention) runs the Q-in-shared-memory kernel of flash_qsmem.cuh:
// at that width the register-resident Q fragments and accumulator of the
// d = 32 kernel would spill. Per active object slot the self-attention is
// ~27.5 GFLOP of tensor-core work (~28 us at the bf16 peak) and 26.9 M
// exponentials (~0.05 ms on the special-function units), and its 5.3 MB of
// operands move in ~2 us: bound by operations. An empty slot's keys are
// all masked, so its tiles are skipped and it costs only the bias reads.
//
// Semantics follow `_kernel`: ragged Lq/Lk are masked inside the kernel
// (rows past Lq are not written, keys past Lk score -1e9), and a row whose
// keys are all masked skips every tile and finishes as acc / max(l, 1e-30)
// = 0 with lse = -1e9.

#include <type_traits>

#include "flash_qsmem.cuh"

using namespace attn;

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_sdpa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ key_bias,
                      T* __restrict__ o, float* __restrict__ lse,
                      int H, int lq, int lk, float sm_scale,
                      long long sqb, long long sqh, long long sqn,
                      long long skb, long long skh, long long skn,
                      long long svb, long long svh, long long svn,
                      long long sob, long long soh, long long son) {
  constexpr int NP = Parts<T>::N;
  __shared__ __align__(16) bf16 ks[NP][BK][D + 8];
  __shared__ __align__(16) bf16 vt[NP][D][VPAD];
  __shared__ float bias_s[BK];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BQ + warp * 16;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  key_bias += (long long)b * lk;

  uint32_t qa[NP][D / 16][4];
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
    qk_tile<D, NP>(s, qa, &ks[0][0][0], BK * (D + 8), D + 8);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float b0 = bias_s[j * 8 + 2 * t], b1 = bias_s[j * 8 + 2 * t + 1];
      s[j][0] = s[j][0] * sm_scale + b0;
      s[j][1] = s[j][1] * sm_scale + b1;
      s[j][2] = s[j][2] * sm_scale + b0;
      s[j][3] = s[j][3] * sm_scale + b1;
    }
    softmax_pv<D, NP>(s, m, l, acc, vt);
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const int r0 = row0 + g, r1 = row0 + g + 8;
  o += b * sob + h * soh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < lq) st_pair(o + r0 * son + c, acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < lq) st_pair(o + r1 * son + c, acc[n][2] / l1, acc[n][3] / l1);
  }
  if (lse != nullptr && t == 0) {
    lse += (long long)bh * lq;
    if (r0 < lq) lse[r0] = m[0] > 0.5f * NEG_INF ? m[0] + logf(l0) : NEG_INF;
    if (r1 < lq) lse[r1] = m[1] > 0.5f * NEG_INF ? m[1] + logf(l1) : NEG_INF;
  }
}

template <int D, typename T>
int launch_reg(const void* q, const void* k, const void* v, const void* key_bias, void* o,
               void* lse, int B, int H, int lq, int lk, float sm_scale, long long sqb,
               long long sqh, long long sqn, long long skb, long long skh, long long skn,
               long long svb, long long svh, long long svn, long long sob, long long soh,
               long long son, cudaStream_t st) {
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  flash_sdpa_fwd_kernel<D, T><<<grid, NTHREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<T*>(o), static_cast<float*>(lse), H, lq,
      lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* key_bias, void* o,
               void* lse, int B, int H, int lq, int lk, int d, float sm_scale, long long sqb,
               long long sqh, long long sqn, long long skb, long long skh, long long skn,
               long long svb, long long svh, long long svn, long long sob, long long soh,
               long long son, cudaStream_t st) {
  if (d == 256)
    return launch_qsmem<256, 256, T>(q, k, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb, sqh,
                                     sqn, skb, skh, skn, svb, svh, svn, sob, soh, son, st);
  if constexpr (std::is_same<T, float>::value) {  // bf16 at d = 32, 64 and 80 is flash_sdpa_h.cu's
    if (d == 32)
      return launch_reg<32, T>(q, k, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb, sqh, sqn,
                               skb, skh, skn, svb, svh, svn, sob, soh, son, st);
    if (d == 64)
      return launch_reg<64, T>(q, k, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb, sqh, sqn,
                               skb, skh, skn, svb, svh, svn, sob, soh, son, st);
    if (d == 80)
      return launch_reg<80, T>(q, k, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb, sqh, sqn,
                               skb, skh, skn, svb, svh, svn, sob, soh, son, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// fp32 != 0: q, k, v and o are float32 (d = 32, 64, 80 and 256), else
// bfloat16 (d = 256 only: bf16 at d = 32, 64 and 80 is served by
// flash_sdpa_h.cu, and refused here).
extern "C" int flash_sdpa_fwd(const void* q, const void* k, const void* v,
                              const void* key_bias, void* o, void* lse, int B,
                              int H, int lq, int lk, int d, int fp32, float sm_scale,
                              long long sqb, long long sqh, long long sqn,
                              long long skb, long long skh, long long skn,
                              long long svb, long long svh, long long svn,
                              long long sob, long long soh, long long son,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = fp32 ? launch_fwd<float> : launch_fwd<bf16>;
  return launch(q, k, v, key_bias, o, lse, B, H, lq, lk, d, sm_scale, sqb, sqh, sqn, skb, skh,
                skn, svb, svh, svn, sob, soh, son, st);
}

template <int D, typename T>
int reg_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_sdpa_fwd_kernel<D, T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_sdpa_fwd_kernel<D, T>,
                                                      NTHREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// The register kernel at head dim d (32, 64 or 80; fp32 != 0: it is built
// in fp32 only, and bf16 is refused) as the runtime holds it: out =
// {registers, spilled bytes a thread, static shared bytes a block, blocks
// an SM}.
extern "C" int flash_sdpa_attrs(int d, int fp32, int* out) {
  if (fp32) {
    if (d == 32) return reg_attrs<32, float>(out);
    if (d == 64) return reg_attrs<64, float>(out);
    if (d == 80) return reg_attrs<80, float>(out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
