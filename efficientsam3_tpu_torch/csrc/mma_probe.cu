// Tensor-core rate probe for Hopper (sm_90a): a chain of matrix products
// with the operands held on chip, int8 -> int32 or bf16 -> f32.
//
// Replaces scripts/probe_int8_mxu.py `bench_dot` (`_kernel`): n_iter times
// d = x @ y over x (m, k) and y (k, n), accumulated as acc += d * (1 + i) in
// fp32 and written once as (m, n) f32. The TPU probe asked whether the
// matrix unit runs int8 at twice its bf16 rate at the block shape of the
// quantized memory attention, (768, 256) @ (256, 2048); this one asks the
// H100's tensor cores the same through mma.sync (m16n8k32.s8 against
// m16n8k16.bf16), the instruction family the int8 bank kernel used before
// it moved to wgmma (flash_memattn_h.cu).
//
// One launch does the whole chain. The grid runs over 96 x 128 output tiles
// (8 x 16 = 128 blocks at the default shape, one an SM); a block of 8 warps
// stages its x rows and its y columns (transposed to (n, k), so both
// operands are read as 32-bit words along k) in shared memory once, and each
// warp then computes its 48 x 32 sub-tile n_iter times from there: 12
// independent accumulators per k step. Every product re-reads its fragments
// from shared memory and the mma is volatile, so no iteration is folded into
// another although d is the same each time. Rows of padded length k + 16
// bytes keep a warp's fragment loads on 32 different banks.
//
// Bound: operations (2 m k n n_iter at the dense int8 or bf16 peak); the
// bytes, x and y read once and (m, n) f32 written once, are ~6.8 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 96, BN = 128, THREADS = 256;
constexpr int WM = 48, WN = 32;  // a warp's sub-tile: 3 x 4 mma tiles

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
struct Acc;
template <>
struct Acc<int8_t> {
  using type = int;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

// T = int8_t: one mma covers 32 of k (32 bytes); T = bf16: 16 of k (32 bytes).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
dot_chain_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ out, int m,
                 int k, int n, int n_iter) {
  using D = typename Acc<T>::type;
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = k * ES + 16;  // bytes per staged row
  unsigned char* xs = smem;                // [BM][pitch]
  unsigned char* ys = smem + BM * pitch;   // [BN][pitch], y transposed
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // x rows: 16-byte copies (k * ES is a multiple of 32); rows past m are zero
  const int cpr = k * ES / 16;
  for (int c = threadIdx.x; c < BM * cpr; c += THREADS) {
    const int r = c / cpr, c16 = (c % cpr) * 16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < m)
      val = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(x) +
                                            ((long long)(m0 + r) * k) * ES + c16);
    *reinterpret_cast<uint4*>(xs + r * pitch + c16) = val;
  }
  // y (k, n) row-major -> ys[col][kk]: neighbouring threads read neighbouring
  // columns of one y row; columns past n are zero
  for (int e = threadIdx.x; e < BN * k; e += THREADS) {
    const int kk = e / BN, c = e % BN;
    T val = T(0);
    if (n0 + c < n) val = y[(long long)kk * n + n0 + c];
    *reinterpret_cast<T*>(ys + c * pitch + kk * ES) = val;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 2) * WM, wn0 = (warp & 3) * WN;
  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // fragment words: A rows g / g + 8, B column g, both at bytes 4t and 16 + 4t
  // of each 32-byte k step
  const unsigned char* xa = xs + (wm0 + g) * pitch + 4 * t;
  const unsigned char* yb = ys + (wn0 + g) * pitch + 4 * t;
  const int ksteps = k * ES / 32;

  for (int it = 0; it < n_iter; ++it) {
    D d[WM / 16][WN / 8][4];
#pragma unroll
    for (int i = 0; i < WM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) d[i][j][0] = d[i][j][1] = d[i][j][2] = d[i][j][3] = 0;
    for (int kc = 0; kc < ksteps; ++kc) {
      uint32_t a[WM / 16][4], b[WN / 8][2];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        const unsigned char* p = xa + i * 16 * pitch + kc * 32;
        a[i][0] = *reinterpret_cast<const volatile uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const volatile uint32_t*>(p + 8 * pitch);
        a[i][2] = *reinterpret_cast<const volatile uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const volatile uint32_t*>(p + 8 * pitch + 16);
      }
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const unsigned char* p = yb + j * 8 * pitch + kc * 32;
        b[j][0] = *reinterpret_cast<const volatile uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const volatile uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
          if constexpr (ES == 1) {
            mma_s8(d[i][j], a[i], b[j][0], b[j][1]);
          } else {
            mma_bf16(d[i][j], a[i], b[j][0], b[j][1]);
          }
        }
    }
    const float w = 1.0f + (float)it;
#pragma unroll
    for (int i = 0; i < WM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += (float)d[i][j][e] * w;
  }

#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = n0 + wn0 + j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm0 + i * 16 + g + 8 * half;
        if (row >= m) continue;
        if (col < n) out[(long long)row * n + col] = acc[i][j][2 * half];
        if (col + 1 < n) out[(long long)row * n + col + 1] = acc[i][j][2 * half + 1];
      }
    }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int m, int k, int n, int n_iter,
           cudaStream_t st) {
  const int es = sizeof(T);
  if (k <= 0 || (k * es) % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (BM + BN) * (k * es + 16);
  cudaError_t err = cudaFuncSetAttribute(dot_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  dot_chain_kernel<T><<<grid, THREADS, smem, st>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(y),
                                                  static_cast<float*>(out), m, k, n, n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) and y (k, n) contiguous, int8 (is_int8 != 0) or bf16; out (m, n)
// f32. k * sizeof(element) must be a multiple of 32 and the staged tiles,
// (96 + 128) * (k * sizeof(element) + 16) bytes, must fit a block's shared
// memory. Launches on `stream`; returns cudaGetLastError().
extern "C" int mma_probe_dot_chain(const void* x, const void* y, void* out, int m, int k, int n,
                                   int n_iter, int is_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_int8 ? launch<int8_t>(x, y, out, m, k, n, n_iter, st)
                 : launch<__nv_bfloat16>(x, y, out, m, k, n, n_iter, st);
}
