// Flash attention backward for Hopper (sm_90a) at head dim 256, fp32
// operands (the default build). bf16 at d = 256 is flash_sdpa_bwd_wide_h.cu's
// (wgmma, TMA, warp-specialised).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`
// (`_bwd_dq_kernel` :930, its pallas_call at :1082; `_bwd_dkv_kernel` :970,
// at :1098) for the tracker's single-head memory attention under autograd
// in fp32: self-attention q/k/v (8, 1, 5184, 256) and the plain path's
// cross-attention over up to 36352 keys. The semantics are those of
// the head-dim-32 kernels in flash_sdpa_bwd.cu: two deterministic kernels
// (no atomics), P rebuilt from the saved log-sum-exp and 0 on rows whose
// lse is masked (<= -5e8), fp32 accumulation, the scale applied at the
// end, fully masked key tiles skipped, strided (B, H, N) operands, rows
// past Lq / keys past Lk read as zero and not written.
//
// Why a layout of its own: at d = 256 a warp that owns 16 rows of dQ holds
// 16 x 256 fp32 = 128 registers a thread before its score tiles, and the
// dkv kernel would hold twice that for dK and dV. Here a block has 8 warps
// (256 threads) over a 64-row tile, so each accumulator is split over two
// warps by columns, and the products run in two phases:
//   1. scores: warp w computes S and dP for 16 rows x BS / 2 columns
//      (rows (w % 4) * 16), reading both operands' fragments from shared
//      memory, turns them into P and dS and writes them to shared memory;
//   2. gradients: warp w accumulates 16 rows x 128 columns (rows (w % 4) *
//      16, columns (w / 4) * 128) of dQ += dS K (dq kernel), or of dV +=
//      P^T dO and dK += dS^T Q (dkv kernel), with the P or dS tile as the A
//      operand and the other side's staged BS x 256 tile read through
//      ldmatrix.trans as B.
// Q and dO (dq kernel) or K and V (dkv kernel) stay in shared memory for
// the block's whole walk; the other pair is copied per tile with cp.async.
//
// fp32 operands (attn_common.cuh) are held as bf16 hi and lo tiles, so each
// product is three mma.sync and P and dS are stored as two bf16 tiles each.
// At 64-row streamed tiles that would take 290 KB, past the 227 KB a block
// can have, so the kernels stream tiles of BS = 32 keys (dq) or 32 query
// rows (dkv) against the resident 64-row pair: 210 and 219 KB. The dq
// kernel adds each tile's dS K to dQ with an fp32 add (the tensor cores'
// accumulation truncates, and a long key sum would carry its bias).
//
// Bound on the H100 at the fp32 clip's cross-attention (31128 live keys):
// the products at the TF32 rate, dq 0.5007 ms and dkv 0.6676 ms (PERF.md):
// the split into three bf16 products is the kernels' cost, not the
// function's.
#pragma once

#include "flash_qsmem.cuh"

namespace attn {
namespace wide {

constexpr int D = 256;
constexpr int P = D + 8;        // padded row (bf16) of a staged tile of D columns
constexpr int NT = 256;         // 8 warps a block
constexpr int TILE = BQ * P;    // elements of one part of a resident 64 x 256 tile

// Tile geometry of fp32 operands: NP = 2 bf16 parts; BS streamed rows (keys
// in the dq kernel, queries in the dkv kernel), each warp's score slice is
// 16 rows x BS / 2 columns; TP the padded row of a 64 x BS P or dS tile.
template <typename T>
struct Cfg {
  static constexpr int NP = Parts<T>::N;
  static_assert(NP == 2, "fp32 only: bf16 at d = 256 is flash_sdpa_bwd_wide_h.cu's");
  static constexpr int BS = 32;
  static constexpr int NJ = BS / 16;  // 8-column blocks of a warp's score slice
  static constexpr int TP = BS + 8;
  static constexpr int STILE = BS * P;  // elements of one part of a streamed tile
  static constexpr int PTILE = BQ * TP;  // elements of one part of a P or dS tile
};

// acc (16 x 8 NJ) = A[ar0 .. ar0 + 16) . B[bc0 .. bc0 + 8 NJ)^T over the 256
// columns, A and B staged row-major (rows x D) in NP parts (part strides
// a_ps, b_ps): A's rows are the m16n8k16 A operand, B's rows the "col" B
// operand, both read as 32-bit pairs.
template <int NP, int NJ>
__device__ __forceinline__ void score16(float (&acc)[NJ][4], const bf16* a_s, int a_ps, int ar0,
                                        const bf16* b_s, int b_ps, int bc0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* a0 = a_s + (ar0 + g) * P + 2 * t;
  const bf16* a1 = a0 + 8 * P;
  const bf16* b0 = b_s + (bc0 + g) * P + 2 * t;
#pragma unroll 4
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      a[p][0] = ld32(a0 + p * a_ps + kc * 16);
      a[p][1] = ld32(a1 + p * a_ps + kc * 16);
      a[p][2] = ld32(a0 + p * a_ps + kc * 16 + 8);
      a[p][3] = ld32(a1 + p * a_ps + kc * 16 + 8);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb0[NP], bb1[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bf16* br = b0 + p * b_ps + j * 8 * P + kc * 16;
        bb0[p] = ld32(br);
        bb1[p] = ld32(br + 8);
      }
      mma_parts(acc[j], a, bb0, bb1);
    }
  }
}

// acc (16 x 128) += A[ar0 .. ar0 + 16) (a 64 x BS tile of NP parts,
// row-major, TP padded) . X[:, col0 .. col0 + 128) (a staged BS x 256 tile
// of NP parts): ldmatrix.trans turns X's rows into B fragments (lanes 0-15
// address rows kk*16 + 0..15 of column block n, lanes 16-31 those of block
// n + 1).
template <typename T>
__device__ __forceinline__ void mma_acc(float (&acc)[16][4], const bf16* a_s, int ar0,
                                        const bf16* x_s, int col0) {
  using C = Cfg<T>;
  constexpr int NP = C::NP;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* a0 = a_s + (ar0 + g) * C::TP + 2 * t;
  const bf16* a1 = a0 + 8 * C::TP;
#pragma unroll
  for (int kk = 0; kk < C::BS / 16; ++kk) {
    uint32_t a[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      a[p][0] = ld32(a0 + p * C::PTILE + kk * 16);
      a[p][1] = ld32(a1 + p * C::PTILE + kk * 16);
      a[p][2] = ld32(a0 + p * C::PTILE + kk * 16 + 8);
      a[p][3] = ld32(a1 + p * C::PTILE + kk * 16 + 8);
    }
    const bf16* xrow = x_s + (kk * 16 + (lane & 15)) * P + col0 + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < 16; n += 2) {
      uint32_t b0[NP], b1[NP], b2[NP], b3[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        ldmatrix_x4_trans(b0[p], b1[p], b2[p], b3[p], xrow + p * C::STILE + n * 8);
      mma_parts(acc[n], a, b0, b1);
      mma_parts(acc[n + 1], a, b2, b3);
    }
  }
}

// Store a warp's 16 x 128 accumulator (rows row0.., columns col0..), times
// `mul`, in T; rows at or past n are not written.
template <typename T>
__device__ __forceinline__ void store16(T* out, long long sn, int row0, int n, int col0,
                                        const float (&acc)[16][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + j * 8 + 2 * t;
    if (r0 < n) st_pair(out + r0 * sn + c, acc[j][0] * mul, acc[j][1] * mul);
    if (r1 < n) st_pair(out + r1 * sn + c, acc[j][2] * mul, acc[j][3] * mul);
  }
}

// The pair (x, y) into a P or dS tile of NP parts at (r, c).
template <typename T>
__device__ __forceinline__ void store_pair(bf16* tile, int r, int c, float x, float y) {
  using C = Cfg<T>;
  uint32_t f[C::NP];
  pack_parts<C::NP>(x, y, f);
#pragma unroll
  for (int p = 0; p < C::NP; ++p)
    *reinterpret_cast<uint32_t*>(tile + p * C::PTILE + r * C::TP + c) = f[p];
}

template <typename T>
int dq_smem_bytes(int lk) {
  using C = Cfg<T>;
  return C::NP * (2 * TILE + 2 * C::STILE + C::PTILE) * 2 + (C::BS + 2 * BQ) * 4 +
         ((lk + C::BS - 1) / C::BS + 15) / 16 * 16;
}

template <typename T>
constexpr int dkv_smem_bytes() {
  using C = Cfg<T>;
  return C::NP * (2 * TILE + 2 * C::STILE + 2 * C::PTILE) * 2 + (BK + 2 * C::BS) * 4;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ key_bias,
              const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              T* __restrict__ dq, int H, int lq, int lk, float sm_scale,
              long long sqb, long long sqh, long long sqn, long long skb, long long skh,
              long long skn, long long svb, long long svh, long long svn, long long sob,
              long long soh, long long son, long long sdb, long long sdh, long long sdn,
              long long sgb, long long sgh, long long sgn) {
  using C = Cfg<T>;
  constexpr int NP = C::NP, BS = C::BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                 // [NP][BQ][P]
  bf16* dos = qs + NP * TILE;                                   // [NP][BQ][P]
  bf16* ks = dos + NP * TILE;                                   // [NP][BS][P]
  bf16* vs = ks + NP * C::STILE;                                // [NP][BS][P]
  bf16* dss = vs + NP * C::STILE;                               // [NP][BQ][TP] dS
  float* bias_s = reinterpret_cast<float*>(dss + NP * C::PTILE);  // [BS]
  float* lse_s = bias_s + BS;                                   // [BQ]
  float* delta_s = lse_s + BQ;                                  // [BQ]
  unsigned char* tile_live = reinterpret_cast<unsigned char*>(delta_s + BQ);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  o += b * sob + h * soh;
  dout += b * sdb + h * sdh;
  dq += b * sgb + h * sgh;
  key_bias += (long long)b * lk;
  lse += (long long)bh * lq;
  delta += (long long)bh * lq;

  stage_rows<BQ, D, P, NT>(qs, TILE, q, sqn, q0, lq);
  stage_rows<BQ, D, P, NT>(dos, TILE, dout, sdn, q0, lq);
  asm volatile("cp.async.commit_group;\n" ::);

  // Delta = rowsum(dO o O) in fp32: 8 rows a warp, 8 columns a lane
  for (int i = 0; i < BQ / 8; ++i) {
    const int r = warp * (BQ / 8) + i, row = q0 + r;
    float s = 0.f;
    if (row < lq) {
      float ov[8], dv[8];
      load8_f32(o + row * son + lane * 8, ov);
      load8_f32(dout + row * sdn + lane * 8, dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += ov[e] * dv[e];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) {
      delta_s[r] = s;
      lse_s[r] = row < lq ? lse[row] : NEG_INF;
      if (row < lq) delta[row] = s;
    }
  }

  // which BS-key tiles hold a live key (stores of 1 may race: same value)
  const int ntiles = (lk + BS - 1) / BS;
  for (int i = threadIdx.x; i < ntiles; i += NT) tile_live[i] = 0;
  __syncthreads();
  for (int key = threadIdx.x; key < lk; key += NT)
    if (key_bias[key] > 0.5f * NEG_INF) tile_live[key / BS] = 1;
  __syncthreads();

  const int sr0 = (warp & 3) * 16;             // this warp's score rows
  const int sc0 = (warp >> 2) * (BS / 2);      // and score columns (keys of the tile)
  const int oc0 = (warp >> 2) * 128;           // and dQ columns
  const int r0 = sr0 + g, r1 = r0 + 8;
  const float l0 = lse_s[r0], l1 = lse_s[r1];
  const float dl0 = delta_s[r0], dl1 = delta_s[r1];
  const bool v0 = l0 > 0.5f * NEG_INF, v1 = l1 > 0.5f * NEG_INF;

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    if (!tile_live[kt]) continue;  // every key of the tile masked (uniform)
    const int key0 = kt * BS;
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < BS) {
      const int key = key0 + threadIdx.x;
      bias_s[threadIdx.x] = key < lk ? key_bias[key] : NEG_INF;
    }
    stage_rows<BS, D, P, NT>(ks, C::STILE, k, skn, key0, lk);
    stage_rows<BS, D, P, NT>(vs, C::STILE, v, svn, key0, lk);
    cp_async_wait_all();
    __syncthreads();

    float s[C::NJ][4], dp[C::NJ][4];
    score16<NP>(s, qs, TILE, sr0, ks, C::STILE, sc0);     // S = Q K^T
    score16<NP>(dp, dos, TILE, sr0, vs, C::STILE, sc0);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int c = sc0 + j * 8 + 2 * t;
      const float b0 = bias_s[c], b1 = bias_s[c + 1];
      const float p00 = v0 ? __expf(s[j][0] * sm_scale + b0 - l0) : 0.f;
      const float p01 = v0 ? __expf(s[j][1] * sm_scale + b1 - l0) : 0.f;
      const float p10 = v1 ? __expf(s[j][2] * sm_scale + b0 - l1) : 0.f;
      const float p11 = v1 ? __expf(s[j][3] * sm_scale + b1 - l1) : 0.f;
      store_pair<T>(dss, r0, c, p00 * (dp[j][0] - dl0), p01 * (dp[j][1] - dl0));  // dS
      store_pair<T>(dss, r1, c, p10 * (dp[j][2] - dl1), p11 * (dp[j][3] - dl1));
    }
    __syncthreads();
    // dQ += dS K: the tile's products in a fresh fragment, then one round-
    // to-nearest add a tile. The tensor cores' fp32 accumulation truncates,
    // and over the 1136 tiles of a 36352-key row its bias reached 1.3e-4 of
    // dQ's largest magnitude
    float part[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
    mma_acc<T>(part, dss, sr0, ks, oc0);
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // the Q / dO copy when no tile was live
  store16(dq, sgn, q0 + sr0, lq, oc0, acc, sm_scale);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ key_bias,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int H, int lq, int lk, float sm_scale,
               long long sqb, long long sqh, long long sqn, long long skb, long long skh,
               long long skn, long long svb, long long svh, long long svn, long long sdb,
               long long sdh, long long sdn, long long skgb, long long skgh, long long skgn,
               long long svgb, long long svgh, long long svgn) {
  using C = Cfg<T>;
  constexpr int NP = C::NP, BS = C::BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                   // [NP][BK][P]
  bf16* vs = ks + NP * TILE;                                      // [NP][BK][P]
  bf16* qs = vs + NP * TILE;                                      // [NP][BS][P]
  bf16* dos = qs + NP * C::STILE;                                 // [NP][BS][P]
  bf16* pts = dos + NP * C::STILE;                                // [NP][BK][TP] P^T
  bf16* dsts = pts + NP * C::PTILE;                               // [NP][BK][TP] dS^T
  float* kb_s = reinterpret_cast<float*>(dsts + NP * C::PTILE);   // [BK]
  float* lse_s = kb_s + BK;                                       // [BS]
  float* delta_s = lse_s + BS;                                    // [BS]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.x * BK;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  dout += b * sdb + h * sdh;
  dk += b * skgb + h * skgh;
  dv += b * svgb + h * svgh;
  key_bias += (long long)b * lk;
  lse += (long long)bh * lq;
  delta += (long long)bh * lq;

  const int sk0 = (warp & 3) * 16;          // this warp's keys (rows of S^T)
  const int sq0 = (warp >> 2) * (BS / 2);   // and queries (columns of S^T)
  const int oc0 = (warp >> 2) * 128;        // and dK / dV columns
  float dkacc[16][4], dvacc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
    dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
  }
  int live = 0;
  if (threadIdx.x < BK) {
    const int key = key0 + threadIdx.x;
    const float kb = key < lk ? key_bias[key] : NEG_INF;
    kb_s[threadIdx.x] = kb;
    live = kb > 0.5f * NEG_INF;
  }
  if (!__syncthreads_or(live)) {  // every key of the block masked: zero gradients
    store16(dk, skgn, key0 + sk0, lk, oc0, dkacc, 0.f);
    store16(dv, svgn, key0 + sk0, lk, oc0, dvacc, 0.f);
    return;
  }
  stage_rows<BK, D, P, NT>(ks, TILE, k, skn, key0, lk);
  stage_rows<BK, D, P, NT>(vs, TILE, v, svn, key0, lk);
  asm volatile("cp.async.commit_group;\n" ::);
  const int k0 = sk0 + g, k1 = k0 + 8;
  const float kb0 = kb_s[k0], kb1 = kb_s[k1];

  const int nqt = (lq + BS - 1) / BS;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * BS;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<BS, D, P, NT>(qs, C::STILE, q, sqn, q0, lq);
    stage_rows<BS, D, P, NT>(dos, C::STILE, dout, sdn, q0, lq);
    if (threadIdx.x < BS) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < lq ? lse[row] : NEG_INF;
      delta_s[threadIdx.x] = row < lq ? delta[row] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float s[C::NJ][4], dp[C::NJ][4];
    score16<NP>(s, ks, TILE, sk0, qs, C::STILE, sq0);    // S^T = K Q^T (16 keys x BS/2 queries)
    score16<NP>(dp, vs, TILE, sk0, dos, C::STILE, sq0);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int c0 = sq0 + j * 8 + 2 * t, c1 = c0 + 1;
      const float L0 = lse_s[c0], L1 = lse_s[c1], D0 = delta_s[c0], D1 = delta_s[c1];
      const bool ok0 = L0 > 0.5f * NEG_INF, ok1 = L1 > 0.5f * NEG_INF;
      const float p00 = ok0 ? __expf(s[j][0] * sm_scale + kb0 - L0) : 0.f;
      const float p01 = ok1 ? __expf(s[j][1] * sm_scale + kb0 - L1) : 0.f;
      const float p10 = ok0 ? __expf(s[j][2] * sm_scale + kb1 - L0) : 0.f;
      const float p11 = ok1 ? __expf(s[j][3] * sm_scale + kb1 - L1) : 0.f;
      store_pair<T>(pts, k0, c0, p00, p01);  // P^T
      store_pair<T>(pts, k1, c0, p10, p11);
      store_pair<T>(dsts, k0, c0, p00 * (dp[j][0] - D0), p01 * (dp[j][1] - D1));  // dS^T
      store_pair<T>(dsts, k1, c0, p10 * (dp[j][2] - D0), p11 * (dp[j][3] - D1));
    }
    __syncthreads();
    mma_acc<T>(dvacc, pts, sk0, dos, oc0);  // dV += P^T dO
    mma_acc<T>(dkacc, dsts, sk0, qs, oc0);  // dK += dS^T Q
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // the K / V copy when Lq is 0
  store16(dk, skgn, key0 + sk0, lk, oc0, dkacc, sm_scale);
  store16(dv, svgn, key0 + sk0, lk, oc0, dvacc, 1.f);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, int B, int H, int lq,
              int lk, float sm_scale, long long sqb, long long sqh, long long sqn, long long skb,
              long long skh, long long skn, long long svb, long long svh, long long svn,
              long long sob, long long soh, long long son, long long sdb, long long sdh,
              long long sdn, long long sgb, long long sgh, long long sgn, cudaStream_t st) {
  const int smem = dq_smem_bytes<T>(lk);
  const cudaError_t err =
      cudaFuncSetAttribute(bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  bwd_dq_kernel<T><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), H, lq, lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob,
      soh, son, sdb, sdh, sdn, sgb, sgh, sgn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_bias,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int lq, int lk, float sm_scale, long long sqb, long long sqh, long long sqn,
               long long skb, long long skh, long long skn, long long svb, long long svh,
               long long svn, long long sdb, long long sdh, long long sdn, long long skgb,
               long long skgh, long long skgn, long long svgb, long long svgh, long long svgn,
               cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<T>();
  const cudaError_t err =
      cudaFuncSetAttribute(bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lk + BK - 1) / BK, B * H);
  bwd_dkv_kernel<T><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, lq, lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn,
      sdb, sdh, sdn, skgb, skgh, skgn, svgb, svgh, svgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
}  // namespace attn
