// Shared pieces of the hand-written Hopper attention kernels
// (flash_sdpa.cu, flash_xattn_rpb.cu).
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

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Q fragments of this warp's 16 rows, read once from device memory.
// Rows at or past lq read as zero.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* q, long long sqn,
                                       int row0, int lq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qa[kc][0] = r0 < lq ? ld32(q + r0 * sqn + c) : 0u;
    qa[kc][1] = r1 < lq ? ld32(q + r1 * sqn + c) : 0u;
    qa[kc][2] = r0 < lq ? ld32(q + r0 * sqn + c + 8) : 0u;
    qa[kc][3] = r1 < lq ? ld32(q + r1 * sqn + c + 8) : 0u;
  }
}

// Stage keys [key0, key0 + BK) of K (row-major, D + 8 padded rows) and V
// (transposed) into shared memory with 16-byte loads. Keys at or past lk
// are zero, so they add nothing to P V.
template <int D>
__device__ __forceinline__ void stage_kv(__nv_bfloat16 (*ks)[D + 8],
                                         __nv_bfloat16 (*vt)[VPAD],
                                         const __nv_bfloat16* k, long long skn,
                                         const __nv_bfloat16* v, long long svn,
                                         int key0, int lk) {
  constexpr int CPR = D / 8;  // 16-byte chunks per key row
  for (int c = threadIdx.x; c < BK * CPR; c += NTHREADS) {
    const int kr = c / CPR, c8 = (c % CPR) * 8, key = key0 + kr;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (key < lk) {
      kv = *reinterpret_cast<const uint4*>(k + key * skn + c8);
      vv = *reinterpret_cast<const uint4*>(v + key * svn + c8);
    }
    *reinterpret_cast<uint4*>(&ks[kr][c8]) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[c8 + j][kr] = ve[j];
  }
}

// S = Q K^T for this warp's 16 rows against the staged BK keys.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4],
                                        const uint32_t (&qa)[D / 16][4],
                                        __nv_bfloat16 (*ks)[D + 8]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const __nv_bfloat16* kr = &ks[j * 8 + g][kc * 16 + 2 * t];
      mma16816(s[j], qa[kc], ld32(kr), ld32(kr + 8));
    }
  }
}

// Online-softmax update of rows (g, g + 8) with the biased score tile s,
// then acc += bf16(P) V. m/l/acc follow the JAX kernels: fp32 running max
// and sum, P rounded to bf16 only as the PV operand. l is this thread's
// partial row sum; the quad's four partials are added at the end.
template <int D>
__device__ __forceinline__ void softmax_pv(float (&s)[BK / 8][4], float (&m)[2],
                                           float (&l)[2], float (&acc)[D / 8][4],
                                           __nv_bfloat16 (*vt)[VPAD]) {
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
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
    };
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* vr = &vt[n * 8 + g][kk * 16 + 2 * t];
      mma16816(acc[n], pa, ld32(vr), ld32(vr + 8));
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
