// Flash cross-attention over an int8 key bank and raw narrow values for
// Hopper (sm_90a).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py
// `flash_memattn_q8` (`_memattn_kernel_q8` and `_memattn_kernel_q8_lse`):
// the tracker's cached memory bank in its opt-in int8 serving mode. The
// bank's keys arrive quantized per row (`quantize_rows`: int8 values and an
// f32 scale per key); the queries are quantized per row here, with the
// softmax scale folded into their scale. The score tile is an
// int8 x int8 -> int32 tensor-core product and
//   logit[row, key] = float(s_i32) * k_scale[key] * q_scale[row],
// masked keys (key_bias <= -5e8) excluded. From the logits on it is
// flash_memattn_h.cu's function: fp32 online softmax, the denominator summed in fp32
// from the unrounded P, P rounded to bf16 only as the operand of P V over
// the raw dv = 64 values, an optional per-row log-sum-exp, 0 and lse -1e9
// for a row whose keys are all masked. One kernel serves both Pallas
// variants (lse is a null pointer or not).
//
// What the TPU kernel did for its own hardware and this one does not: it
// ran transposed with a row of ones folded into V for the denominator, and
// carried the key mask on the key scale (-1e9 marks a masked key) to save
// an input stream. Here the mask is the key-bias row beside the scales; a
// second 4-byte stream per key is nothing against the 256-byte key.
//
// Layout. One block of 4 warps owns BQ = 64 query rows of one (batch,
// head), 16 a warp (attn_common.cuh). Prologue: each warp reads its 16
// bf16 query rows from device memory (a row is 32 lanes x 16 bytes), takes
// the row's |max| by shuffles, and writes the int8 row and its scale into
// shared memory, so the Q tile costs 17 KB instead of 33 KB and the
// quantized queries never touch device memory. Division and rounding are
// IEEE (x / (amax / 127), round half to even), which gives the int8 values
// and scales of `quantize_rows`. Key tiles of BK = 64 keys are copied with
// cp.async as int8 rows of 256 + 16 bytes (the pad makes the 32-bit
// fragment loads of a warp hit 32 different banks); mma.m16n8k32.s8 reads
// A (row g / g + 8, bytes 4t.. and 16 + 4t..) and B (key g, the same
// bytes) as plain 32-bit loads, K being (keys, dk) row-major = the "col" B
// operand. Its 16x8 s32 accumulator has the thread layout of the bf16
// m16n8k16's f32 one, so the scaled scores feed the online softmax and then
// the A operand of P V in registers, as in the bf16 kernel.
//
// Bound on the H100, per active object slot and layer at the tracker shape
// (q 5184 x 256, 36864 bank keys): 97.8 G int8 operations of Q K^T (~0.05
// ms at the dense int8 peak), 24.5 GFLOP of P V in bf16 (~0.025 ms) and 191
// M exponentials (~0.05 ms), against 9.4 MB of keys, 4.7 MB of values and
// 2.7 MB of queries (~5 us): bound by operations, and with the product
// twice as fast the exponentials weigh as much as the product. Each of the
// 81 query tiles of a slot streams that slot's keys, so reuse comes from L2;
// the int8 bank halves that traffic. Dead 64-key tiles (invalid bank
// entries, the pad tail) are skipped through the byte-per-tile table, which
// one warp compacts into a list of live tiles.
//
// The first version walked the tiles one at a time (copy a tile,
// wait, compute) and took 1.90 ms at 3 live slots of 8 against the bf16
// kernel's 2.01 ms on the same keys (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W, in a CUDA graph): each block waited out its own copies. So the
// K / V / scale / bias tiles are double-buffered here: the copy of the next
// live tile is issued before the current one is computed (27 KB a stage; Q
// tile + two stages = 72 KB, 3 blocks an SM). By live slots, q8 against
// bf16 in ms: 1 slot 0.85 / 1.81, 2 slots 1.29 / 1.96, 3 slots 1.79 / 2.01,
// 4 slots 1.81 / 3.73, 8 slots 3.01 / 5.84. The int8 product pays once
// enough blocks are resident; at full occupancy a 64-key tile takes an SM
// about 1 us, close to what mma.sync fed from shared memory delivers
// (ops/mma_probe.py), so the next step is wgmma, not this layout.
//
// fp32 q and v (the default build): q is quantized in the prologue straight
// from fp32; v is staged as bf16 hi and lo tiles (attn_common.cuh) and P V
// runs as three products on them with P kept fp32 and split, as in JAX. A
// stage grows to 36 KB (90 KB a block): 2 blocks an SM instead of 3.

#include "flash_qsmem.cuh"

using namespace attn;

namespace {

constexpr int DK = 256;       // key / query width
constexpr int DV = 64;        // raw value width
constexpr int KP8 = DK + 16;  // padded int8 row of the Q and K tiles (bytes)
constexpr int VP = DV + 8;    // padded bf16 row of the V tile
constexpr int VT = BK * VP;   // elements of one part of the V tile

// Shared memory by value dtype: one stage is the K tile (int8), the V tile
// (NP bf16 parts), the tile's key scales and key bias; a block holds the Q
// tile (int8), two stages and the query scales.
template <typename T>
struct Q8Smem {
  static constexpr int NP = Parts<T>::N;
  static constexpr int STAGE = BK * KP8 + NP * VT * 2 + 2 * BK * 4;
  static constexpr int FIXED = BQ * KP8 + 2 * STAGE + BQ * 4;
  static constexpr int MIN_BLOCKS = NP == 1 ? 3 : 2;  // blocks an SM
};

__device__ __forceinline__ void mma16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32b(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c, float d, float s) {
  const int i0 = __float2int_rn(a / s), i1 = __float2int_rn(b / s);
  const int i2 = __float2int_rn(c / s), i3 = __float2int_rn(d / s);
  return (uint32_t)(i0 & 0xff) | ((uint32_t)(i1 & 0xff) << 8) | ((uint32_t)(i2 & 0xff) << 16) |
         ((uint32_t)(i3 & 0xff) << 24);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Keys [key0, key0 + BK) into one stage: the int8 key rows 16 bytes a
// cp.async, the value rows as flash_qsmem.cuh's stage_rows takes them
// (cp.async at bf16, split through registers at fp32), the keys' scales and
// bias 4 bytes a copy. Lk is a multiple of BK (the entry point checks), so
// no key is out of range.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* st, const int8_t* k, long long skn,
                                           const T* v, long long svn, const float* k_scale,
                                           const float* key_bias, int key0, int lk) {
  constexpr int NP = Parts<T>::N;
  int8_t* ks = reinterpret_cast<int8_t*>(st);
  bf16* vs = reinterpret_cast<bf16*>(st + BK * KP8);
  float* kscale_s = reinterpret_cast<float*>(st + BK * KP8 + NP * VT * 2);
  constexpr int CPR = DK / 16;  // 16-byte chunks per key row
  for (int c = threadIdx.x; c < BK * CPR; c += NTHREADS) {
    const int r = c / CPR, c16 = (c % CPR) * 16;
    cp_async16(ks + r * KP8 + c16, k + (key0 + r) * skn + c16, true);
  }
  stage_rows<BK, DV, VP>(vs, VT, v, svn, key0, lk);
  if (threadIdx.x < BK)
    cp_async4(kscale_s + threadIdx.x, k_scale + key0 + threadIdx.x);
  else
    cp_async4(kscale_s + threadIdx.x, key_bias + key0 + threadIdx.x - BK);  // bias_s follows
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, Q8Smem<T>::MIN_BLOCKS)
flash_memattn_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                        const float* __restrict__ k_scale, const T* __restrict__ v,
                        const float* __restrict__ key_bias, T* __restrict__ o,
                        float* __restrict__ lse, int H, int lq, int lk, float sm_scale,
                        long long sqb, long long sqh, long long sqn, long long skb, long long skh,
                        long long skn, long long svb, long long svh, long long svn, long long sob,
                        long long soh, long long son) {
  using C = Q8Smem<T>;
  constexpr int NP = C::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem_raw);                           // [BQ][KP8]
  unsigned char* stages = smem_raw + BQ * KP8;                                // 2 x STAGE
  float* qscale_s = reinterpret_cast<float*>(stages + 2 * C::STAGE);          // [BQ]
  unsigned char* tile_live = reinterpret_cast<unsigned char*>(qscale_s + BQ);  // [ntiles]
  __shared__ int nlive_s;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  k_scale += (long long)b * lk;
  key_bias += (long long)b * lk;

  // Prologue: this warp's 16 query rows, quantized per row into shared
  // memory; a lane holds 8 of the row's 256 values.
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r, row = q0 + lr;
    float x[8];
    if (row < lq) {
      load8_f32(q + row * sqn + lane * 8, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fmaxf(amax, 1e-8f) / 127.0f;
    uint2 packed;
    packed.x = pack_s8(x[0], x[1], x[2], x[3], s);
    packed.y = pack_s8(x[4], x[5], x[6], x[7], s);
    *reinterpret_cast<uint2*>(qs + lr * KP8 + lane * 8) = packed;
    if (lane == 0) qscale_s[lr] = s * sm_scale;
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int8_t* qrow0 = qs + (warp * 16 + g) * KP8 + 4 * t;
  const int8_t* qrow1 = qrow0 + 8 * KP8;
  const int ntiles = (lk + BK - 1) / BK;

  // which key tiles hold a live key (stores of 1 may race: same value)
  for (int i = threadIdx.x; i < ntiles; i += NTHREADS) tile_live[i] = 0;
  __syncthreads();
  if ((lk & 3) == 0 && (reinterpret_cast<uintptr_t>(key_bias) & 15) == 0) {
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
  // warp 0 compacts the live tiles' indices into a list behind the table
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);  // [ntiles]
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool lv = i < ntiles && tile_live[i];
      const unsigned mask = __ballot_sync(0xffffffffu, lv);
      if (lv) live_list[n + __popc(mask & ((1u << lane) - 1u))] = (unsigned short)i;
      n += __popc(mask);
    }
    if (lane == 0) nlive_s = n;
  }
  __syncthreads();
  const int nlive = nlive_s;
  const float qs0 = qscale_s[warp * 16 + g], qs1 = qscale_s[warp * 16 + g + 8];

  if (nlive > 0) stage_tile(stages, k, skn, v, svn, k_scale, key_bias, live_list[0] * BK, lk);
  for (int it = 0; it < nlive; ++it) {
    unsigned char* st = stages + (it & 1) * C::STAGE;
    if (it + 1 < nlive) {  // the next live tile's copy flies while this one is computed
      stage_tile(stages + ((it + 1) & 1) * C::STAGE, k, skn, v, svn, k_scale, key_bias,
                 live_list[it + 1] * BK, lk);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile `it` has landed for every thread
    const int8_t* ks = reinterpret_cast<const int8_t*>(st);
    const bf16* vs = reinterpret_cast<const bf16*>(st + BK * KP8);
    const float* kscale_s = reinterpret_cast<const float*>(st + BK * KP8 + NP * VT * 2);
    const float* bias_s = kscale_s + BK;

    // S = Q K^T in int32 for this warp's 16 rows
    int si[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll 4
    for (int kc = 0; kc < DK / 32; ++kc) {
      const uint32_t qa[4] = {ld32b(qrow0 + kc * 32), ld32b(qrow1 + kc * 32),
                              ld32b(qrow0 + kc * 32 + 16), ld32b(qrow1 + kc * 32 + 16)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int8_t* kr = ks + (j * 8 + g) * KP8 + kc * 32 + 4 * t;
        mma16832_s8(si[j], qa, ld32b(kr), ld32b(kr + 16));
      }
    }
    // logits: (s * k_scale) * q_scale, a masked key at NEG_INF
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const bool live0 = bias_s[j * 8 + 2 * t] > 0.5f * NEG_INF;
      const bool live1 = bias_s[j * 8 + 2 * t + 1] > 0.5f * NEG_INF;
      const float k0 = live0 ? kscale_s[j * 8 + 2 * t] : 0.f;
      const float k1 = live1 ? kscale_s[j * 8 + 2 * t + 1] : 0.f;
      const float b0 = live0 ? 0.f : NEG_INF, b1 = live1 ? 0.f : NEG_INF;
      s[j][0] = (float)si[j][0] * k0 * qs0 + b0;
      s[j][1] = (float)si[j][1] * k1 * qs0 + b1;
      s[j][2] = (float)si[j][2] * k0 * qs1 + b0;
      s[j][3] = (float)si[j][3] * k1 * qs1 + b1;
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
    // acc += P V, V's B fragments through ldmatrix.trans, a part at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[NP][4];
      a_parts<NP>(pa, s, 2 * kk);
      const bf16* vrow = vs + (kk * 16 + (lane & 15)) * VP + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t b0[NP], b1[NP], b2[NP], b3[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) ldmatrix_x4_trans(b0[p], b1[p], b2[p], b3[p], vrow + p * VT + n * 8);
        mma_parts(acc[n], pa, b0, b1);
        mma_parts(acc[n + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // this stage is free for the copy after the next
  }

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

template <typename T>
int launch_q8(const void* q, const void* k, const void* k_scale, const void* v,
              const void* key_bias, void* o, void* lse, int B, int H, int lq, int lk,
              float sm_scale, long long sqb, long long sqh, long long sqn, long long skb,
              long long skh, long long skn, long long svb, long long svh, long long svn,
              long long sob, long long soh, long long son, cudaStream_t st) {
  const int ntiles = lk / BK;  // the live table (bytes, padded) and the live list (u16)
  const int smem = Q8Smem<T>::FIXED + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(flash_memattn_q8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  flash_memattn_q8_kernel<T><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(k_scale), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<T*>(o), static_cast<float*>(lse), H, lq,
      lk, sm_scale, sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Lq, 256), k (B, H, Lk, 256) int8, v (B, H, Lk, 64), each with
// (batch, head, row) strides in elements and a contiguous last axis; q, v
// and o float32 when fp32 != 0, else bfloat16; k_scale, key_bias (B, Lk)
// f32 contiguous; o (B, H, Lq, 64) by strides; lse (B, H, Lq) f32
// contiguous or null. Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_memattn_q8_fwd(const void* q, const void* k, const void* k_scale,
                                    const void* v, const void* key_bias, void* o, void* lse,
                                    int B, int H, int lq, int lk, int dk, int dv, int fp32,
                                    float sm_scale, long long sqb, long long sqh, long long sqn,
                                    long long skb, long long skh, long long skn, long long svb,
                                    long long svh, long long svn, long long sob, long long soh,
                                    long long son, void* stream) {
  if (dk != DK || dv != DV || lk <= 0 || lk % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = fp32 ? launch_q8<float> : launch_q8<bf16>;
  return launch(q, k, k_scale, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb, sqh, sqn, skb,
                skh, skn, svb, svh, svn, sob, soh, son, static_cast<cudaStream_t>(stream));
}
