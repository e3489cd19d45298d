// Shared pieces of the mma.sync attention kernel that remains
// (flash_xattn_rpb.cu, the decoder's boxRPB cross-attention).
//
// One thread block of 4 warps owns BQ = 64 query rows of one (batch, head);
// each warp owns 16 rows. K and V tiles of BK = 64 keys are staged in shared
// memory (V transposed, so the PV product reads its B operand as contiguous
// pairs). Both products run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). The S accumulator fragment
// of QK^T has exactly the register layout of the A operand of PV, so P goes
// from the online softmax to the second product in registers: the score
// tile never touches shared or device memory.
//
// Operand types. Every kernel is instantiated for bf16 and for fp32
// operands (the JAX kernels take the model's dtype; the port's default
// build computes in fp32). An fp32 operand x goes to the bf16 tensor cores
// split in two: hi = bf16(x), lo = bf16(x - hi), so hi + lo carries 16 of
// fp32's 24 mantissa bits. A product a b is hi_a hi_b + hi_a lo_b + lo_a hi_b
// (three mma.sync into the same fp32 accumulator; lo_a lo_b, ~2^-16 of the
// product, is dropped), about 2^-16 relative error per product against
// bf16's 2^-8. Staged tiles hold the parts as separate bf16 tiles ("parts"
// below: 1 for bf16, 2 for fp32), so every fragment load and ldmatrix path
// is the bf16 one, run once a part. P stays fp32 as in JAX, where
// p.astype(v.dtype) is a no-op at fp32, and is split in registers the same
// way before its product.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8,  col): b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16x8):       c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e9f;  // the JAX kernels' mask value
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;
constexpr int VPAD = BK + 8;  // row length of the transposed V tile

using bf16 = __nv_bfloat16;

// bf16 parts an operand of type T is staged and multiplied as
template <typename T> struct Parts;
template <> struct Parts<bf16> { static constexpr int N = 1; };
template <> struct Parts<float> { static constexpr int N = 2; };

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over the parts of a and b: hi hi, then the two cross terms
template <int N>
__device__ __forceinline__ void mma_parts(float (&c)[4], const uint32_t (&a)[N][4],
                                          const uint32_t (&b0)[N], const uint32_t (&b1)[N]) {
  if constexpr (N == 2) {
    mma16816(c, a[1], b0[0], b1[0]);
    mma16816(c, a[0], b0[1], b1[1]);
  }
  mma16816(c, a[0], b0[0], b1[0]);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The pair (x, y) as N packed bf16 parts: N = 1 rounds to bf16; N = 2
// gives hi = bf16(x, y) and lo = bf16(x - hi, y - hi).
template <int N>
__device__ __forceinline__ void pack_parts(float x, float y, uint32_t (&r)[N]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  r[0] = as_u32(hi);
  if constexpr (N == 2) {
    const float2 h = __bfloat1622float2(hi);
    r[1] = pack_bf16(x - h.x, y - h.y);
  }
}

// Two consecutive elements as fp32, and as packed bf16 parts.
__device__ __forceinline__ float2 ld_f2(const bf16* p) { return unpack_bf16(ld32(p)); }
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__device__ __forceinline__ void ld_parts(const T* p, uint32_t (&r)[Parts<T>::N]) {
  if constexpr (Parts<T>::N == 1) {
    r[0] = ld32(p);
  } else {
    const float2 v = ld_f2(p);
    pack_parts<2>(v.x, v.y, r);
  }
}

// Eight consecutive elements at src (16-byte aligned) as packed bf16
// parts, four pairs a part; zeros when !ok.
template <typename T>
__device__ __forceinline__ void load8_parts(const T* src, bool ok,
                                            uint32_t (&w)[Parts<T>::N][4]) {
  if constexpr (Parts<T>::N == 1) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ok) v = *reinterpret_cast<const uint4*>(src);
    w[0][0] = v.x;
    w[0][1] = v.y;
    w[0][2] = v.z;
    w[0][3] = v.w;
  } else {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ok) {
      a = reinterpret_cast<const float4*>(src)[0];
      b = reinterpret_cast<const float4*>(src)[1];
    }
    uint32_t r[2];
    pack_parts<2>(a.x, a.y, r);
    w[0][0] = r[0];
    w[1][0] = r[1];
    pack_parts<2>(a.z, a.w, r);
    w[0][1] = r[0];
    w[1][1] = r[1];
    pack_parts<2>(b.x, b.y, r);
    w[0][2] = r[0];
    w[1][2] = r[1];
    pack_parts<2>(b.z, b.w, r);
    w[0][3] = r[0];
    w[1][3] = r[1];
  }
}

// Q fragments of this warp's 16 rows, read once from device memory, as
// NP = Parts<T>::N parts. Rows at or past lq read as zero.
template <int D, typename T>
__device__ __forceinline__ void load_q(uint32_t (&qa)[Parts<T>::N][D / 16][4], const T* q,
                                       long long sqn, int row0, int lq) {
  constexpr int NP = Parts<T>::N;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    uint32_t f[4][NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) f[0][p] = f[1][p] = f[2][p] = f[3][p] = 0u;
    if (r0 < lq) {
      ld_parts(q + r0 * sqn + c, f[0]);
      ld_parts(q + r0 * sqn + c + 8, f[2]);
    }
    if (r1 < lq) {
      ld_parts(q + r1 * sqn + c, f[1]);
      ld_parts(q + r1 * sqn + c + 8, f[3]);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[p][kc][i] = f[i][p];
  }
}

// Stage keys [key0, key0 + BK) of K (row-major, D + 8 padded rows) and V
// (transposed) into shared memory, one tile a part, with 16-byte loads.
// Keys at or past lk are zero, so they add nothing to P V.
template <int D, typename T>
__device__ __forceinline__ void stage_kv(bf16 (*ks)[BK][D + 8], bf16 (*vt)[D][VPAD],
                                         const T* k, long long skn, const T* v,
                                         long long svn, int key0, int lk) {
  constexpr int NP = Parts<T>::N;
  constexpr int CPR = D / 8;  // 8-element chunks per key row
  for (int c = threadIdx.x; c < BK * CPR; c += NTHREADS) {
    const int kr = c / CPR, c8 = (c % CPR) * 8, key = key0 + kr;
    uint32_t kw[NP][4], vw[NP][4];
    load8_parts(k + key * skn + c8, key < lk, kw);
    load8_parts(v + key * svn + c8, key < lk, vw);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      *reinterpret_cast<uint4*>(&ks[p][kr][c8]) = make_uint4(kw[p][0], kw[p][1], kw[p][2], kw[p][3]);
      const bf16* ve = reinterpret_cast<const bf16*>(vw[p]);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[p][c8 + j][kr] = ve[j];
    }
  }
}

// S = Q K^T for this warp's 16 rows against the staged BK keys.
template <int D, int NP>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4], const uint32_t (&qa)[NP][D / 16][4],
                                        const bf16* ks, int part_stride, int row_len) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[NP][4], b0[NP], b1[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bf16* kr = ks + p * part_stride + (j * 8 + g) * row_len + kc * 16 + 2 * t;
        b0[p] = ld32(kr);
        b1[p] = ld32(kr + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[p][i] = qa[p][kc][i];
      }
      mma_parts(s[j], a, b0, b1);
    }
  }
}

// P (a 16 x 16 slice of fp32 accumulator tiles j0, j0 + 1) as the A operand
// of the next product, NP parts.
template <int NP, int NJ>
__device__ __forceinline__ void a_parts(uint32_t (&pa)[NP][4], const float (&s)[NJ][4], int j0) {
  uint32_t f[NP];
  pack_parts<NP>(s[j0][0], s[j0][1], f);
#pragma unroll
  for (int p = 0; p < NP; ++p) pa[p][0] = f[p];
  pack_parts<NP>(s[j0][2], s[j0][3], f);
#pragma unroll
  for (int p = 0; p < NP; ++p) pa[p][1] = f[p];
  pack_parts<NP>(s[j0 + 1][0], s[j0 + 1][1], f);
#pragma unroll
  for (int p = 0; p < NP; ++p) pa[p][2] = f[p];
  pack_parts<NP>(s[j0 + 1][2], s[j0 + 1][3], f);
#pragma unroll
  for (int p = 0; p < NP; ++p) pa[p][3] = f[p];
}

// Online-softmax update of rows (g, g + 8) with the biased score tile s,
// then acc += P V, P rounded to the value dtype's parts. m/l/acc follow
// the JAX kernels: fp32 running max and sum; l sums the unrounded P. l is
// this thread's partial row sum; the quad's four partials are added at the
// end.
template <int D, int NP>
__device__ __forceinline__ void softmax_pv(float (&s)[BK / 8][4], float (&m)[2],
                                           float (&l)[2], float (&acc)[D / 8][4],
                                           bf16 (*vt)[D][VPAD]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= corr0;
    acc[n][1] *= corr0;
    acc[n][2] *= corr1;
    acc[n][3] *= corr1;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[NP][4];
    a_parts<NP>(pa, s, 2 * kk);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b0[NP], b1[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const bf16* vr = &vt[p][n * 8 + g][kk * 16 + 2 * t];
        b0[p] = ld32(vr);
        b1[p] = ld32(vr + 8);
      }
      mma_parts(acc[n], pa, b0, b1);
    }
  }
}

// Sum of the quad's partial row sums.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace attn
