// Staging helpers of the mma.sync kernels that remain (flash_memattn_q8.cu,
// the bf16 dq kernel of flash_sdpa_bwd.cu): cp.async copies of 16 bytes,
// ldmatrix with a transpose, and stage_rows, which copies rows of a strided
// (N, D) matrix into a row-padded shared tile (bf16 by cp.async, fp32
// through registers as split bf16 hi / lo parts, attn_common.cuh).
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

}  // namespace attn
