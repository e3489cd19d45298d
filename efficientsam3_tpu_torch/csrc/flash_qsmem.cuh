// Flash attention forward with the query tile staged in shared memory, for
// wide heads: dk = 256 keys/queries against values of width DV (256 for
// the tracker's self and plain cross-attention, 64 for the cached memory
// bank's raw values). Used by flash_sdpa.cu (d = 256 in fp32; bf16 is
// flash_sdpa_h.cu's wgmma kernel) and flash_memattn.cu.
//
// Why a layout of its own: an mma.sync kernel that keeps the Q fragments
// and the output accumulator in registers needs DK/16*4 + DV/8*4 = 192
// registers a thread at 256/256 before the score tile, which spills. Here
// one block of 4 warps owns BQ = 64 query rows (16 a warp); the Q tile
// (64 x 256 bf16, 33 KB with padding) is copied once into shared memory and
// its m16n8k16 A fragments are read from there at every key tile, so only
// the DV-wide accumulator (DV/8*4 fp32) and the 64-key score tile stay in
// registers. K and V tiles of BK = 64 keys are copied with cp.async (no
// register round trip) into row-padded shared buffers; the PV product reads
// V's B fragments with ldmatrix.trans, so V needs no transposed copy.
//
// Semantics (both callers): softmax(Q K^T * scale + key_bias) V, fp32
// online softmax, P rounded to bf16 only as the PV operand and the
// denominator summed in fp32 from the unrounded P; key tiles whose 64 keys
// are all masked (key_bias <= -5e8, or past Lk) are skipped without
// loading K or V. Each block first reads its key-bias row once, with all
// threads and 16-byte loads, into a byte per key tile in shared memory,
// and then walks only the live tiles: a tile-by-tile test (a bias load and
// two barriers per tile) cost ~1 us a tile, ~0.6 ms a block over the
// tracker's 576-tile bank even for an empty object slot. A row whose keys
// are all masked finishes as acc / max(l, 1e-30) = 0 with lse = -1e9.
// Rows past Lq are not written.
//
// fp32 operands (attn_common.cuh) are staged as bf16 hi and lo tiles, split
// on the way in through registers (cp.async copies bytes and cannot split),
// so the bf16 fragment and ldmatrix paths below run once a part. Shared
// memory doubles: 199 KB at <256, 256> (one block an SM, against two at
// bf16) and 150 KB at <256, 64>.
#pragma once

#include "attn_common.cuh"

namespace attn {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8x8 b16 matrices, transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

template <int DK, int DV, int NP>
struct QSmem {
  static constexpr int KP = DK + 8;  // padded row (bf16) of the Q and K tiles
  static constexpr int VP = DV + 8;  // padded row of the V tile
  // Q, K and V tiles (NP parts each), the tile's key bias, then one byte per key tile
  static constexpr int BYTES = NP * (BQ * KP + BK * KP + BK * VP) * 2 + BK * 4;
  static int bytes(int lk) { return BYTES + ((lk + BK - 1) / BK + 15) / 16 * 16; }
};

// Copy rows [row0, row0 + ROWS) of a (N, D) strided matrix into a padded
// shared tile of NP parts (part p at dst + p * part_stride); rows at or
// past n are zero. bf16 rows go by cp.async (the caller commits and waits),
// fp32 rows through registers, split into hi and lo.
template <int ROWS, int D, int P, int NTHR = NTHREADS, typename T>
__device__ __forceinline__ void stage_rows(bf16* dst, int part_stride, const T* src,
                                           long long sn, int row0, int n) {
  constexpr int CPR = D / 8;  // 8-element chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHR) {
    const int r = c / CPR, c8 = (c % CPR) * 8, row = row0 + r;
    const bool ok = row < n;
    if constexpr (Parts<T>::N == 1) {
      cp_async16(dst + r * P + c8, ok ? src + row * sn + c8 : src, ok);
    } else {
      uint32_t w[2][4];
      load8_parts(src + row * sn + c8, ok, w);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        *reinterpret_cast<uint4*>(dst + p * part_stride + r * P + c8) =
            make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
  }
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_qsmem_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ key_bias,
                   T* __restrict__ o, float* __restrict__ lse, int H, int lq,
                   int lk, float sm_scale, long long sqb, long long sqh, long long sqn,
                   long long skb, long long skh, long long skn, long long svb,
                   long long svh, long long svn, long long sob, long long soh,
                   long long son) {
  constexpr int NP = Parts<T>::N;
  using C = QSmem<DK, DV, NP>;
  constexpr int QT = BQ * C::KP, KT = BK * C::KP, VT = BK * C::VP;  // part strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                // [NP][BQ][KP]
  bf16* ks = qs + NP * QT;                                     // [NP][BK][KP]
  bf16* vs = ks + NP * KT;                                     // [NP][BK][VP]
  float* bias_s = reinterpret_cast<float*>(vs + NP * VT);      // [BK]
  unsigned char* tile_live = reinterpret_cast<unsigned char*>(bias_s + BK);  // [ntiles]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  key_bias += (long long)b * lk;

  stage_rows<BQ, DK, C::KP>(qs, QT, q, sqn, q0, lq);
  asm volatile("cp.async.commit_group;\n" ::);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const bf16* qrow0 = qs + (warp * 16 + g) * C::KP + 2 * t;
  const bf16* qrow1 = qrow0 + 8 * C::KP;
  const int ntiles = (lk + BK - 1) / BK;

  // which key tiles hold a live key (stores of 1 may race: same value)
  for (int i = threadIdx.x; i < ntiles; i += NTHREADS) tile_live[i] = 0;
  __syncthreads();
  if ((lk & 3) == 0 && (reinterpret_cast<uintptr_t>(key_bias) & 15) == 0) {
    // 4 keys a 16-byte load, all in one tile (BK % 4 == 0)
    const float4* kb4 = reinterpret_cast<const float4*>(key_bias);
#pragma unroll 4
    for (int i = threadIdx.x; i < lk / 4; i += NTHREADS) {
      const float4 bv = kb4[i];
      if (fmaxf(fmaxf(bv.x, bv.y), fmaxf(bv.z, bv.w)) > 0.5f * NEG_INF) tile_live[4 * i / BK] = 1;
    }
  } else {
    for (int key = threadIdx.x; key < lk; key += NTHREADS)
      if (key_bias[key] > 0.5f * NEG_INF) tile_live[key / BK] = 1;
  }
  __syncthreads();

  for (int kt = 0; kt < ntiles; ++kt) {
    if (!tile_live[kt]) continue;  // every key of the tile masked (uniform)
    const int key0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < BK) {
      const int key = key0 + threadIdx.x;
      bias_s[threadIdx.x] = key < lk ? key_bias[key] : NEG_INF;
    }
    stage_rows<BK, DK, C::KP>(ks, KT, k, skn, key0, lk);
    stage_rows<BK, DV, C::VP>(vs, VT, v, svn, key0, lk);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows, Q fragments read from shared memory
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < DK / 16; ++kc) {
      uint32_t qa[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bf16* q0p = qrow0 + p * QT + kc * 16;
        const bf16* q1p = qrow1 + p * QT + kc * 16;
        qa[p][0] = ld32(q0p);
        qa[p][1] = ld32(q1p);
        qa[p][2] = ld32(q0p + 8);
        qa[p][3] = ld32(q1p + 8);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0[NP], b1[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const bf16* kr = ks + p * KT + (j * 8 + g) * C::KP + kc * 16 + 2 * t;
          b0[p] = ld32(kr);
          b1[p] = ld32(kr + 8);
        }
        mma_parts(s[j], qa, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float b0 = bias_s[j * 8 + 2 * t], b1 = bias_s[j * 8 + 2 * t + 1];
      s[j][0] = s[j][0] * sm_scale + b0;
      s[j][1] = s[j][1] * sm_scale + b1;
      s[j][2] = s[j][2] * sm_scale + b0;
      s[j][3] = s[j][3] * sm_scale + b1;
    }

    // online softmax of rows (g, g + 8); l sums the unrounded fp32 P
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float corr0 = __expf(m[0] - mx[0]), corr1 = __expf(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = __expf(s[j][0] - mx[0]);
      s[j][1] = __expf(s[j][1] - mx[0]);
      s[j][2] = __expf(s[j][2] - mx[1]);
      s[j][3] = __expf(s[j][3] - mx[1]);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l[0] = l[0] * corr0 + ps0;
    l[1] = l[1] * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    // acc += P V; ldmatrix.trans turns row-major V into B fragments:
    // lanes 0-15 address keys kk*16 + 0..15 of column block n, lanes 16-31
    // the same keys of block n + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[NP][4];
      a_parts<NP>(pa, s, 2 * kk);
      const bf16* vrow = vs + (kk * 16 + (lane & 15)) * C::VP + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t b0[NP], b1[NP], b2[NP], b3[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) ldmatrix_x4_trans(b0[p], b1[p], b2[p], b3[p], vrow + p * VT + n * 8);
        mma_parts(acc[n], pa, b0, b1);
        mma_parts(acc[n + 1], pa, b2, b3);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // the Q copy when no tile was live

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  o += b * sob + h * soh;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
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

// Launch on `stream`: grid (Lq tiles, B * H), bytes(lk) of dynamic shared memory.
template <int DK, int DV, typename T>
int launch_qsmem(const void* q, const void* k, const void* v, const void* key_bias, void* o,
                 void* lse, int B, int H, int lq, int lk, float sm_scale, long long sqb,
                 long long sqh, long long sqn, long long skb, long long skh, long long skn,
                 long long svb, long long svh, long long svn, long long sob, long long soh,
                 long long son, cudaStream_t st) {
  const int smem = QSmem<DK, DV, Parts<T>::N>::bytes(lk);
  cudaError_t err = cudaFuncSetAttribute(flash_qsmem_kernel<DK, DV, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  flash_qsmem_kernel<DK, DV, T><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<T*>(o), static_cast<float*>(lse), H, lq,
      lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
