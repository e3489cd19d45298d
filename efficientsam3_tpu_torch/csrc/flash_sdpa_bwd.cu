// Flash attention backward for Hopper (sm_90a) on mma.sync, what the
// wgmma kernels have not taken over: the dq kernel in bf16 at d = 32 and
// in fp32 at d = 32, 64 and 80, and the dkv kernel in fp32 at d = 64 and
// 80. The rest is on wgmma: bf16 dq at d = 64 and 80 is
// flash_sdpa_bwd_dq_h.cu's, bf16 dkv at d = 32, 64 and 80
// flash_sdpa_bwd_h.cu's, fp32 dkv at d = 32 flash_sdpa_bwd_h_fp32.cu's; at
// d = 256 dq and dkv are flash_sdpa_bwd_wide_h.cu's in bf16 and
// flash_sdpa_bwd_wide_h_fp32.cu's in fp32. The entry points below refuse
// what those serve.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`:
// `_bwd_dq_kernel` (its pallas_call at :1082) and `_bwd_dkv_kernel` (:1098),
// the custom VJP of `flash_sdpa`, where these instantiations run: the bf16
// dq at d = 32 in Stage-3 training (the fusion encoder's self-attention,
// (4, 8, 5184, 32), 6 launches a step); the fp32 dq at d = 32 in the
// default build's Stage-3 step, and the fp32 dq and dkv at d = 64 and 80
// in fp32 Stage-1 steps of a ViTDet trunk (the SAM3 teacher's ViT-H,
// (B, 16, 5184, 64), and the vit_h SAM1 student, (1, 16, 4900, 80)). As on
// the TPU the work is split into two deterministic kernels, so no sum
// crosses blocks and nothing needs atomics:
//
//   dq kernel:  one block of 4 warps owns 64 query rows (16 a warp) and walks
//               the key tiles: dQ = scale * sum_tiles (P o (dO V^T - Delta)) K;
//               it also computes Delta = rowsum(dO o O) (fp32) for its rows and
//               writes it out for the second kernel;
//   dkv kernel: one block owns 64 keys (16 a warp) and walks the query tiles:
//               dV = sum P^T dO, dK = scale * sum (P o (dO V^T - Delta))^T Q.
//
// P is rebuilt from the forward's saved log-sum-exp, P = exp(S * scale +
// key_bias - lse), and is 0 on rows whose lse is masked (<= -5e8: every key
// of the batch row masked), so such rows give zero gradients. dS is rounded
// to bf16 before the dQ and dK products and P before the dV product; all
// products accumulate in fp32 and the scale is applied at the end, as in the
// Pallas kernels. Key tiles whose 64 keys are all masked are skipped: the dq
// kernel reads its key-bias row once into a byte per tile (as the forward's
// flash_qsmem.cuh does) and walks only the live tiles; a dkv block whose keys
// are all masked writes zeros and returns. Rows past Lq / keys past Lk read as
// zero and are not written. Strides over (B, H, N) are taken for every
// operand (dO arrives as a view of the (B, N, H * D) gradient).
//
// Bound on the H100 at the Stage-3 shape (4, 8, 5184, 32): the dq kernel
// does 3 products of (5184 x 5184 x 32) per (batch, head) (S, dP, dQ), 55
// GFLOP over the 32 (batch, head) pairs (~0.056 ms a product at the bf16
// peak), and recomputes P, 860 M exponentials (~0.21 ms on the
// special-function units at 16 per SM per clock), against ~13 MB of
// operands (~4 us): bf16 it is bound by its exponentials (0.21 ms). fp32
// operands take the tf32 rate as the function's bound: dq 0.3336 ms at the
// Stage-3 shape; at the teacher's d = 64 (batch 1) dq 0.33 and dkv 0.44
// ms, at vit_h's d = 80 dq 0.37 and dkv 0.50 ms.
//
// The design keeps S, dP, P and dS in registers (the mma accumulator layout
// of a 16 x 64 tile is the A-operand layout of the next product), stages the
// other side's 64-row tiles with cp.async into rows padded by 8 elements
// (D + 8: 80 bytes at d = 32, 144 at d = 64, 176 at d = 80, so the eight row
// addresses of an ldmatrix or fragment read fall on distinct banks) and
// reads their B fragments with ldmatrix.trans, so no transposed copy is
// made. The k-loop over D takes D / 16 steps of 16 and the n-loop D / 8
// tiles of 8, taken in pairs by ldmatrix.x4 (D / 8 is even at every D
// here). The wgmma kernels named above pipeline the tile copies and run
// the products on wgmma.
//
// Registers. A dkv warp holds its 16 keys' K and V fragments (D / 4 a
// part), the 16 x D dK and dV accumulators (D / 2 each) and a 16-row x
// query-tile S and dP (tile / 2 each). With 64-query tiles ptxas spilled
// the fp32 dkv kernels at d = 64 and 80 (8-64 bytes a thread at the 255 a
// thread may hold); at 32-query tiles the d = 80 one still spilled 8
// bytes. So fp32 dkv walks 16-query tiles at d = 80 and 32 at d = 64
// (DkvRows below). The dq kernel holds Q and dO fragments (D / 4 a part
// each), the dQ accumulator (D / 2) and S and dP; fp32 adds a fresh dQ
// fragment a tile (D / 2), which at d = 80 spilled 16 bytes, so that
// instantiation scores its staged 64-key tile 32 keys at a time (DqKeys).
//
// fp32 operands (the default build) run the same kernels on split bf16
// parts (attn_common.cuh): Q, K, V, dO staged or held as hi and lo, P and
// dS split in registers (in JAX they stay fp32: the casts to the operand
// dtype are no-ops), three products each; Delta is summed from the fp32
// values. Gradients come back in the operands' dtype.

#include "flash_qsmem.cuh"

using namespace attn;

namespace {

// query rows a dkv block stages and walks at a time, and keys of a staged
// 64-key tile a dq warp scores at a time (see Registers above)
template <int D>
struct DkvRows {  // fp32 (two parts) at d = 64 and 80: the dkv kernel's only instantiations
  static constexpr int value = D >= 80 ? 16 : 32;
};
template <int D, int NP>
struct DqKeys {
  static constexpr int value = (NP == 2 && D >= 80) ? 32 : 64;
};

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
  constexpr int KS = DqKeys<D, NP>::value;
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

    // fp32: dQ sums a fresh fragment a tile, added with round-to-nearest
    float part[NP == 2 ? D / 8 : 1][4];
    if constexpr (NP == 2) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += KS) {  // KS keys of the staged tile at a time
      const bf16* kt = ks + k0 * PD;
      float s[KS / 8][4], dp[KS / 8][4];
      qk_rows<D, NP>(s, qa, kt, PT);             // S = Q K^T
      qk_rows<D, NP>(dp, da, vs + k0 * PD, PT);  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
        const float b0 = bias_s[k0 + j * 8 + 2 * t], b1 = bias_s[k0 + j * 8 + 2 * t + 1];
        const float p00 = v0 ? __expf(s[j][0] * sm_scale + b0 - l0) : 0.f;
        const float p01 = v0 ? __expf(s[j][1] * sm_scale + b1 - l0) : 0.f;
        const float p10 = v1 ? __expf(s[j][2] * sm_scale + b0 - l1) : 0.f;
        const float p11 = v1 ? __expf(s[j][3] * sm_scale + b1 - l1) : 0.f;
        s[j][0] = p00 * (dp[j][0] - dl0);  // dS
        s[j][1] = p01 * (dp[j][1] - dl0);
        s[j][2] = p10 * (dp[j][2] - dl1);
        s[j][3] = p11 * (dp[j][3] - dl1);
      }
      if constexpr (NP == 1) {
        mma_tile_x<D, NP>(acc, s, kt, PT);  // dQ += dS K
      } else {
        mma_tile_x<D, NP>(part, s, kt, PT);
      }
    }
    if constexpr (NP == 2) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
  }
  store_rows<D>(dq, sgn, row0, lq, acc, sm_scale);
}

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ key_bias,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int H, int lq, int lk, float sm_scale,
               long long sqb, long long sqh, long long sqn, long long skb, long long skh,
               long long skn, long long svb, long long svh, long long svn, long long sdb,
               long long sdh, long long sdn, long long skgb, long long skgh, long long skgn,
               long long svgb, long long svgh, long long svgn) {
  constexpr int NP = Parts<T>::N;
  constexpr int QT = DkvRows<D>::value;  // query rows a tile
  constexpr int PD = D + 8;
  constexpr int PT = QT * PD;  // elements of one part of a staged tile
  __shared__ __align__(16) bf16 qs[NP * PT];
  __shared__ __align__(16) bf16 dos[NP * PT];
  __shared__ float lse_s[QT], delta_s[QT];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.x * BK;
  const int krow0 = key0 + warp * 16;
  const int kr0 = krow0 + g, kr1 = kr0 + 8;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  dout += b * sdb + h * sdh;
  dk += b * skgb + h * skgh;
  dv += b * svgb + h * svgh;
  key_bias += (long long)b * lk;
  lse += (long long)bh * lq;
  delta += (long long)bh * lq;

  int live = 0;
  if (threadIdx.x < BK) {
    const int key = key0 + threadIdx.x;
    live = key < lk && key_bias[key] > 0.5f * NEG_INF;
  }
  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
    dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
  }
  if (!__syncthreads_or(live)) {  // every key of the block masked: zero gradients
    store_rows<D>(dk, skgn, krow0, lk, dkacc, 0.f);
    store_rows<D>(dv, svgn, krow0, lk, dvacc, 0.f);
    return;
  }
  const float kb0 = kr0 < lk ? key_bias[kr0] : NEG_INF;
  const float kb1 = kr1 < lk ? key_bias[kr1] : NEG_INF;
  uint32_t ka[NP][D / 16][4], va[NP][D / 16][4];
  load_q<D>(ka, k, skn, krow0, lk);
  load_q<D>(va, v, svn, krow0, lk);

  const int nqt = (lq + QT - 1) / QT;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * QT;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<QT, D, PD>(qs, PT, q, sqn, q0, lq);
    stage_rows<QT, D, PD>(dos, PT, dout, sdn, q0, lq);
    if (threadIdx.x < QT) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < lq ? lse[row] : NEG_INF;
      delta_s[threadIdx.x] = row < lq ? delta[row] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float s[QT / 8][4], dp[QT / 8][4];
    qk_rows<D, NP>(s, ka, qs, PT);    // S^T = K Q^T (16 keys x QT queries)
    qk_rows<D, NP>(dp, va, dos, PT);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const int c0 = j * 8 + 2 * t, c1 = c0 + 1;
      const float L0 = lse_s[c0], L1 = lse_s[c1], D0 = delta_s[c0], D1 = delta_s[c1];
      const bool ok0 = L0 > 0.5f * NEG_INF, ok1 = L1 > 0.5f * NEG_INF;
      const float p00 = ok0 ? __expf(s[j][0] * sm_scale + kb0 - L0) : 0.f;
      const float p01 = ok1 ? __expf(s[j][1] * sm_scale + kb0 - L1) : 0.f;
      const float p10 = ok0 ? __expf(s[j][2] * sm_scale + kb1 - L0) : 0.f;
      const float p11 = ok1 ? __expf(s[j][3] * sm_scale + kb1 - L1) : 0.f;
      s[j][0] = p00;
      s[j][1] = p01;
      s[j][2] = p10;
      s[j][3] = p11;
      dp[j][0] = p00 * (dp[j][0] - D0);  // dS^T
      dp[j][1] = p01 * (dp[j][1] - D1);
      dp[j][2] = p10 * (dp[j][2] - D0);
      dp[j][3] = p11 * (dp[j][3] - D1);
    }
    mma_tile_x<D, NP>(dvacc, s, dos, PT);  // dV += P^T dO
    mma_tile_x<D, NP>(dkacc, dp, qs, PT);  // dK += dS^T Q
  }
  store_rows<D>(dk, skgn, krow0, lk, dkacc, sm_scale);
  store_rows<D>(dv, svgn, krow0, lk, dvacc, 1.f);
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

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_bias,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int lq, int lk, float sm_scale, long long sqb, long long sqh, long long sqn,
               long long skb, long long skh, long long skn, long long svb, long long svh,
               long long svn, long long sdb, long long sdh, long long sdn, long long skgb,
               long long skgh, long long skgn, long long svgb, long long svgh, long long svgn,
               cudaStream_t st) {
  const dim3 grid((lk + BK - 1) / BK, B * H);
  bwd_dkv_kernel<D, T><<<grid, NTHREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, lq, lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn,
      sdb, sdh, sdn, skgb, skgh, skgn, svgb, svgh, svgn);
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

template <int D, typename T>
int pair_attrs(int dkv, int lk, int* out) {
  if (dkv) return kernel_attrs(bwd_dkv_kernel<D, T>, 0, out);
  return kernel_attrs(bwd_dq_kernel<D, T>, dq_smem_bytes<D>(lk, Parts<T>::N), out);
}

}  // namespace

// fp32 != 0: q, k, v, o, dout and dq are float32 (d = 32, 64 or 80), else
// bfloat16 (d = 32 only: d = 64 and 80 are flash_sdpa_bwd_dq_h.cu's, d = 256
// flash_sdpa_bwd_wide_h.cu's and flash_sdpa_bwd_wide_h_fp32.cu's).
extern "C" int flash_sdpa_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* key_bias, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int B, int H, int lq,
                                 int lk, int d, int fp32, float sm_scale, long long sqb,
                                 long long sqh, long long sqn, long long skb, long long skh,
                                 long long skn, long long svb, long long svh, long long svn,
                                 long long sob, long long soh, long long son, long long sdb,
                                 long long sdh, long long sdn, long long sgb, long long sgh,
                                 long long sgn, void* stream) {
  decltype(&launch_dq<32, bf16>) launch;
  if (d == 32) {
    launch = fp32 ? launch_dq<32, float> : launch_dq<32, bf16>;
  } else if (d == 64 && fp32) {
    launch = launch_dq<64, float>;
  } else if (d == 80 && fp32) {
    launch = launch_dq<80, float>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, k, v, key_bias, o, dout, lse, delta, dq, B, H, lq, lk, sm_scale, sqb, sqh,
                sqn, skb, skh, skn, svb, svh, svn, sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn,
                static_cast<cudaStream_t>(stream));
}

// q, k, v, dout, dk and dv float32 (fp32 != 0) at d = 64 and 80; bfloat16
// is refused (flash_sdpa_bwd_h.cu's), and so are fp32 at d = 32
// (flash_sdpa_bwd_h_fp32.cu's) and d = 256 (flash_sdpa_bwd_wide_h.cu's and
// flash_sdpa_bwd_wide_h_fp32.cu's).
extern "C" int flash_sdpa_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* key_bias, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int H, int lq,
                                  int lk, int d, int fp32, float sm_scale, long long sqb,
                                  long long sqh, long long sqn, long long skb, long long skh,
                                  long long skn, long long svb, long long svh, long long svn,
                                  long long sdb, long long sdh, long long sdn, long long skgb,
                                  long long skgh, long long skgn, long long svgb,
                                  long long svgh, long long svgn, void* stream) {
  decltype(&launch_dkv<64, float>) launch;
  if (!fp32) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (d == 64) {
    launch = launch_dkv<64, float>;
  } else if (d == 80) {
    launch = launch_dkv<80, float>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, k, v, key_bias, dout, lse, delta, dk, dv, B, H, lq, lk, sm_scale, sqb, sqh,
                sqn, skb, skh, skn, svb, svh, svn, sdb, sdh, sdn, skgb, skgh, skgn, svgb, svgh,
                svgn, static_cast<cudaStream_t>(stream));
}

// The dq (dkv == 0) or dkv kernel of this file at head dim d, fp32 != 0
// for its fp32 instantiation, as the runtime holds it; the dq kernel's
// dynamic shared memory for lk keys. out = {registers, spilled bytes a
// thread, shared bytes a block, blocks an SM}. Refuses what the entry
// points refuse.
extern "C" int flash_sdpa_bwd_attrs(int dkv, int d, int fp32, int lk, int* out) {
  if (fp32) {
    if (d == 32 && !dkv)
      return kernel_attrs(bwd_dq_kernel<32, float>, dq_smem_bytes<32>(lk, 2), out);
    if (d == 64) return pair_attrs<64, float>(dkv, lk, out);
    if (d == 80) return pair_attrs<80, float>(dkv, lk, out);
  } else if (!dkv && d == 32) {  // the only bf16 kernel built here
    return kernel_attrs(bwd_dq_kernel<32, bf16>, dq_smem_bytes<32>(lk, 1), out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
