// Flash attention backward for Hopper (sm_90a) on mma.sync, what the
// wgmma kernels have not taken over: the dq kernel in bf16 at d = 32. The
// rest is on wgmma: bf16 dq at d = 64 and 80 is flash_sdpa_bwd_dq_h.cu's,
// fp32 dq at d = 32, 64 and 80 flash_sdpa_bwd_dq_h_fp32.cu's, bf16 dkv at
// d = 32, 64 and 80 flash_sdpa_bwd_h.cu's, fp32 dkv at d = 32, 64 and 80
// flash_sdpa_bwd_h_fp32.cu's; at d = 256 dq and dkv are
// flash_sdpa_bwd_wide_h.cu's in bf16 and flash_sdpa_bwd_wide_h_fp32.cu's in
// fp32. The entry points below refuse what those serve: the dkv entry
// refuses every call, and is kept so that a caller bound to it gets an
// error and not a missing symbol.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`'s
// `_bwd_dq_kernel` (its pallas_call at :1082), the custom VJP of
// `flash_sdpa`, where Stage-3 training in bf16 runs it (the fusion
// encoder's self-attention, (4, 8, 5184, 32), 6 launches a step). As on the
// TPU the backward is two deterministic kernels, so no sum crosses blocks
// and nothing needs atomics:
//
//   dq kernel:  one block of 4 warps owns 64 query rows (16 a warp) and walks
//               the key tiles: dQ = scale * sum_tiles (P o (dO V^T - Delta)) K;
//               it also computes Delta = rowsum(dO o O) (fp32) for its rows and
//               writes it out for the dkv kernel (flash_sdpa_bwd_h.cu).
//
// P is rebuilt from the forward's saved log-sum-exp, P = exp(S * scale +
// key_bias - lse), and is 0 on rows whose lse is masked (<= -5e8: every key
// of the batch row masked), so such rows give zero gradients. dS is rounded
// to bf16 before the dQ product; the product accumulates in fp32 and the
// scale is applied at the end, as in the Pallas kernel. Key tiles whose 64
// keys are all masked are skipped: the kernel reads its key-bias row once
// into a byte per tile (as the forwards do) and walks
// only the live tiles. Rows past Lq / keys past Lk read as zero and are not
// written. Strides over (B, H, N) are taken for every operand (dO arrives
// as a view of the (B, N, H * D) gradient).
//
// Bound on the H100 at the Stage-3 shape (4, 8, 5184, 32): 3 products of
// (5184 x 5184 x 32) per (batch, head) (S, dP, dQ), 55 GFLOP over the 32
// (batch, head) pairs (~0.056 ms a product at the bf16 peak), and P
// recomputed, 860 M exponentials (~0.21 ms on the special-function units at
// 16 per SM per clock), against ~13 MB of operands (~4 us): bound by its
// exponentials (0.21 ms).
//
// The design keeps S, dP, P and dS in registers (the mma accumulator layout
// of a 16 x 64 tile is the A-operand layout of the next product), stages
// the K and V tiles with cp.async into rows padded by 8 elements (D + 8: 80
// bytes, so the eight row addresses of an ldmatrix or fragment read fall on
// distinct banks) and reads dQ's B fragments with ldmatrix.trans, so no
// transposed copy is made. The k-loop over D takes D / 16 steps of 16 and
// the n-loop D / 8 tiles of 8, taken in pairs by ldmatrix.x4. The wgmma
// kernels named above pipeline the tile copies and run the products on
// wgmma.

#include "flash_qsmem.cuh"

using namespace attn;

namespace {

// S (16 rows x 8 NJ columns) = A X^T: A this warp's 16 rows as fragments of
// NP parts, X NJ * 8 staged rows of D (padded to D + 8) a part.
template <int D, int NP, int NJ>
__device__ __forceinline__ void qk_rows(float (&s)[NJ][4], const uint32_t (&qa)[NP][D / 16][4],
                                        const bf16* xs, int part_stride) {
  constexpr int PD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[NP][4], b0[NP], b1[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bf16* xr = xs + p * part_stride + (j * 8 + g) * PD + kc * 16 + 2 * t;
        b0[p] = ld32(xr);
        b1[p] = ld32(xr + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[p][i] = qa[p][kc][i];
      }
      mma_parts(s[j], a, b0, b1);
    }
  }
}

// acc (this warp's 16 rows x D) += a (16 x 8 NJ, fp32, rounded to NP parts)
// X, X a row-major 8 NJ x D tile of NP parts in shared memory: a's
// accumulator layout is the A-operand layout, and ldmatrix.trans turns X's
// rows into B fragments (lanes 0-15 address rows kk*16 + 0..15 of column
// block n, lanes 16-31 those of block n + 1).
template <int D, int NP, int NJ>
__device__ __forceinline__ void mma_tile_x(float (&acc)[D / 8][4], const float (&a)[NJ][4],
                                           const bf16* xs, int part_stride) {
  static_assert(D % 16 == 0, "ldmatrix.x4 takes the n-tiles in pairs");
  constexpr int PD = D + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t pa[NP][4];
    a_parts<NP>(pa, a, 2 * kk);
    const bf16* xrow = xs + (kk * 16 + (lane & 15)) * PD + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b0[NP], b1[NP], b2[NP], b3[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        ldmatrix_x4_trans(b0[p], b1[p], b2[p], b3[p], xrow + p * part_stride + n * 8);
      mma_parts(acc[n], pa, b0, b1);
      mma_parts(acc[n + 1], pa, b2, b3);
    }
  }
}

// Store this warp's 16 x D fp32 accumulator, times `mul`, in T.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, long long sn, int row0, int n,
                                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < n) st_pair(out + r0 * sn + c, acc[j][0] * mul, acc[j][1] * mul);
    if (r1 < n) st_pair(out + r1 * sn + c, acc[j][2] * mul, acc[j][3] * mul);
  }
}

// dynamic shared memory of the dq kernel: K and V tiles (np parts, rows of
// D + 8), the tile's key bias and a byte per key tile
template <int D>
int dq_smem_bytes(int lk, int np) {
  return np * 2 * BK * (D + 8) * 2 + BK * 4 + ((lk + BK - 1) / BK + 15) / 16 * 16;
}

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ key_bias,
              const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              T* __restrict__ dq, int H, int lq, int lk, float sm_scale,
              long long sqb, long long sqh, long long sqn, long long skb, long long skh,
              long long skn, long long svb, long long svh, long long svn, long long sob,
              long long soh, long long son, long long sdb, long long sdh, long long sdn,
              long long sgb, long long sgh, long long sgn) {
  constexpr int NP = Parts<T>::N;
  constexpr int PD = D + 8;    // padded row (bf16) of a staged 64 x D tile
  constexpr int PT = BK * PD;  // elements of one part of a staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [NP][BK][PD]
  bf16* vs = ks + NP * PT;                                 // [NP][BK][PD]
  float* bias_s = reinterpret_cast<float*>(vs + NP * PT);  // [BK]
  unsigned char* tile_live = reinterpret_cast<unsigned char*>(bias_s + BK);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BQ + warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  o += b * sob + h * soh;
  dout += b * sdb + h * sdh;
  dq += b * sgb + h * sgh;
  key_bias += (long long)b * lk;
  lse += (long long)bh * lq;
  delta += (long long)bh * lq;

  uint32_t qa[NP][D / 16][4], da[NP][D / 16][4];
  load_q<D>(qa, q, sqn, row0, lq);
  load_q<D>(da, dout, sdn, row0, lq);

  // Delta of rows r0, r1 in fp32: this thread holds D / 4 of each row's D
  // columns, those of its fragments
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 16; e += 8) {
      const int c = kc * 16 + 2 * t + e;
      if (r0 < lq) {
        const float2 d0 = ld_f2(dout + r0 * sdn + c), o0 = ld_f2(o + r0 * son + c);
        dl0 += d0.x * o0.x + d0.y * o0.y;
      }
      if (r1 < lq) {
        const float2 d1 = ld_f2(dout + r1 * sdn + c), o1 = ld_f2(o + r1 * son + c);
        dl1 += d1.x * o1.x + d1.y * o1.y;
      }
    }
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);
  if (t == 0) {
    if (r0 < lq) delta[r0] = dl0;
    if (r1 < lq) delta[r1] = dl1;
  }
  const float l0 = r0 < lq ? lse[r0] : NEG_INF, l1 = r1 < lq ? lse[r1] : NEG_INF;
  const bool v0 = l0 > 0.5f * NEG_INF, v1 = l1 > 0.5f * NEG_INF;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // which key tiles hold a live key (stores of 1 may race: same value)
  const int ntiles = (lk + BK - 1) / BK;
  for (int i = threadIdx.x; i < ntiles; i += NTHREADS) tile_live[i] = 0;
  __syncthreads();
  for (int key = threadIdx.x; key < lk; key += NTHREADS)
    if (key_bias[key] > 0.5f * NEG_INF) tile_live[key / BK] = 1;
  __syncthreads();

  for (int kt = 0; kt < ntiles; ++kt) {
    if (!tile_live[kt]) continue;  // every key of the tile masked (uniform)
    const int key0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < BK) {
      const int key = key0 + threadIdx.x;
      bias_s[threadIdx.x] = key < lk ? key_bias[key] : NEG_INF;
    }
    stage_rows<BK, D, PD>(ks, PT, k, skn, key0, lk);
    stage_rows<BK, D, PD>(vs, PT, v, svn, key0, lk);
    cp_async_wait_all();
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
    qk_rows<D, NP>(s, qa, ks, PT);  // S = Q K^T
    qk_rows<D, NP>(dp, da, vs, PT);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float b0 = bias_s[j * 8 + 2 * t], b1 = bias_s[j * 8 + 2 * t + 1];
      const float p00 = v0 ? __expf(s[j][0] * sm_scale + b0 - l0) : 0.f;
      const float p01 = v0 ? __expf(s[j][1] * sm_scale + b1 - l0) : 0.f;
      const float p10 = v1 ? __expf(s[j][2] * sm_scale + b0 - l1) : 0.f;
      const float p11 = v1 ? __expf(s[j][3] * sm_scale + b1 - l1) : 0.f;
      s[j][0] = p00 * (dp[j][0] - dl0);  // dS
      s[j][1] = p01 * (dp[j][1] - dl0);
      s[j][2] = p10 * (dp[j][2] - dl1);
      s[j][3] = p11 * (dp[j][3] - dl1);
    }
    mma_tile_x<D, NP>(acc, s, ks, PT);  // dQ += dS K
  }
  store_rows<D>(dq, sgn, row0, lq, acc, sm_scale);
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, int B, int H, int lq,
              int lk, float sm_scale, long long sqb, long long sqh, long long sqn, long long skb,
              long long skh, long long skn, long long svb, long long svh, long long svn,
              long long sob, long long soh, long long son, long long sdb, long long sdh,
              long long sdn, long long sgb, long long sgh, long long sgn, cudaStream_t st) {
  const int smem = dq_smem_bytes<D>(lk, Parts<T>::N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  bwd_dq_kernel<D, T><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), H, lq, lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob,
      soh, son, sdb, sdh, sdn, sgb, sgh, sgn);
  return static_cast<int>(cudaGetLastError());
}

// A kernel as the runtime holds it, with smem_dyn bytes of dynamic shared
// memory: out = {registers, spilled bytes a thread, shared bytes a block
// (static + dynamic), blocks an SM}.
template <typename K>
int kernel_attrs(K* kernel, int smem_dyn, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NTHREADS, smem_dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes) + smem_dyn;
  out[3] = blocks;
  return 0;
}

}  // namespace

// q, k, v, o, dout and dq bfloat16 at d = 32 (fp32 == 0); every other
// dtype and head dim is refused (the wgmma kernels named at the top serve
// them).
extern "C" int flash_sdpa_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* key_bias, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int B, int H, int lq,
                                 int lk, int d, int fp32, float sm_scale, long long sqb,
                                 long long sqh, long long sqn, long long skb, long long skh,
                                 long long skn, long long svb, long long svh, long long svn,
                                 long long sob, long long soh, long long son, long long sdb,
                                 long long sdh, long long sdn, long long sgb, long long sgh,
                                 long long sgn, void* stream) {
  if (d != 32 || fp32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<32, bf16>(q, k, v, key_bias, o, dout, lse, delta, dq, B, H, lq, lk, sm_scale,
                             sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son, sdb,
                             sdh, sdn, sgb, sgh, sgn, static_cast<cudaStream_t>(stream));
}

// Refuses every call (cudaErrorInvalidValue, nothing launched): dK and dV
// are the wgmma kernels' at every dtype and head dim (flash_sdpa_bwd_h.cu,
// flash_sdpa_bwd_h_fp32.cu, flash_sdpa_bwd_wide_h.cu,
// flash_sdpa_bwd_wide_h_fp32.cu).
extern "C" int flash_sdpa_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* key_bias, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int H, int lq,
                                  int lk, int d, int fp32, float sm_scale, long long sqb,
                                  long long sqh, long long sqn, long long skb, long long skh,
                                  long long skn, long long svb, long long svh, long long svn,
                                  long long sdb, long long sdh, long long sdn, long long skgb,
                                  long long skgh, long long skgn, long long svgb,
                                  long long svgh, long long svgn, void* stream) {
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dq kernel of this file (dkv == 0, d = 32, fp32 == 0) as the runtime
// holds it, with its dynamic shared memory for lk keys: out = {registers,
// spilled bytes a thread, shared bytes a block, blocks an SM}. Refuses
// what the entry points refuse.
extern "C" int flash_sdpa_bwd_attrs(int dkv, int d, int fp32, int lk, int* out) {
  if (dkv || d != 32 || fp32) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_attrs(bwd_dq_kernel<32, bf16>, dq_smem_bytes<32>(lk, 1), out);
}
