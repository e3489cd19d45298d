// Tensor-core rate probe for Hopper (sm_90a): a chain of matrix products
// with the operands held on chip, int8 -> int32 or bf16 -> f32, on wgmma.
//
// Replaces scripts/probe_int8_mxu.py `bench_dot` (`_kernel`): n_iter times
// d = x @ y over x (m, k) and y (k, n), accumulated as acc += d * (1 + i) in
// fp32 and written once as (m, n) f32. The TPU probe asked whether the
// matrix unit runs int8 at twice its bf16 rate at the block shape of the
// quantized memory attention, (768, 256) @ (256, 2048); this one asks the
// H100's tensor cores the same through the instructions the bank kernels
// use (flash_memattn_h.cu): wgmma.mma_async m64n64k32.s32.s8.s8 against
// m64n64k16.f32.bf16.bf16.
//
// Bound: operations, 2 m k n n_iter at the dense int8 (1979 TOP/s) or bf16
// (989 TFLOP/s) peak: 0.0260 / 0.0521 ms at the probe's shape and 64
// products; the bytes (x and y read once, the f32 output written once,
// ~6.8 MB) are 0.002 ms.
//
// Design. A block is one warpgroup and one 64 x 64 output tile: the (768,
// 2048) output is 384 tiles, 3 at most on one of the 132 SMs against 2.91
// on average (64 x 128 tiles would be 192: 2 at most against 1.45), and 3
// blocks are resident on every SM, so the grid is one wave.
//  - x is the same in every product, so each thread loads its A fragments
//    from global memory into registers once: KA k-steps of 32 bytes, 4
//    registers each (8 int8 k-steps, 16 bf16 ones: k = 256 in both). A
//    longer row's further k-steps read A from shared memory.
//  - y is staged once into shared memory as (n, k) rows, K-major (the only
//    layout wgmma takes for 8-bit operands), in 128-byte slabs with the
//    128-byte swizzle, as TMA would lay them out.
//  - Each product is issued as real wgmma instructions (volatile asm: no
//    product folded into another although d is the same each time) into a
//    fresh fragment apart from acc, double-buffered: product i + 1 is in
//    flight on the tensor cores while product i's fragment is converted
//    and added into acc (acc += float(d) * (1 + i), one FMA an element).
//  - An s32 fragment is converted by `cvt.rn.f32.s32`. Its clock64
//    section (chip_smoke.py [probe]) is a small share of a block's clocks
//    (PERF.md §6), so the conversion does not hold the chain.
// Registers: A (32 int8 / 64 bf16), two fragments of 32 and acc of 32.
// y's staging reads 16 bytes a load and transposes them in registers by
// byte permutes.
// With `clocks`, thread 0 of each block writes clock64 sections (staging,
// waiting on the tensor cores, converting) for the probe's report.

#include "wgmma_common.cuh"

namespace {

using wgmma::bf16;

constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr int SLAB = BN * 128;  // bytes a 128-byte slab of a 64-row tile
constexpr int KMAX_BYTES = 992;  // the longest row: (64 + 64) rows of it fit

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d (64 x 64) (+)= A B in int32, int8 operands, both from shared memory,
// K-major.
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The operand types of one chain: D the product's fragment, KA the k-steps
// of A a thread holds in registers.
template <typename T>
struct Chain;
template <>
struct Chain<int8_t> {
  using D = int;
  static constexpr int KA = 8;
};
template <>
struct Chain<bf16> {
  using D = float;
  static constexpr int KA = 16;
};

// k-step kk (32 bytes) of a K-major 64-row tile of 128-byte slabs at saddr
__device__ __forceinline__ uint64_t desc(uint32_t saddr, int kk) {
  return wgmma::desc_k<128>(saddr + (kk / 4) * SLAB, kk % 4);
}

// One product d = x y over ks k-steps: A from registers for the first KA,
// then (TAIL) from shared memory; committed as one group.
template <typename T, bool TAIL>
__device__ __forceinline__ void product(typename Chain<T>::D (&d)[32],
                                        const uint32_t (&a)[Chain<T>::KA][4], uint32_t sa,
                                        uint32_t sb, int ks) {
  constexpr int KA = Chain<T>::KA;
  wgmma::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KA; ++kk) {
    if (kk < ks) {
      if constexpr (sizeof(T) == 1)
        wgmma::wgmma_s8_rs(d, a[kk], desc(sb, kk), kk > 0);
      else
        wgmma::wgmma_rs<0>(d, a[kk], desc(sb, kk), kk > 0);
    }
  }
  if constexpr (TAIL) {
    for (int kk = KA; kk < ks; ++kk) {
      if constexpr (sizeof(T) == 1)
        wgmma_s8_ss(d, desc(sa, kk), desc(sb, kk), 1);
      else
        wgmma::wgmma_m64n64k16_ss(d, desc(sa, kk), desc(sb, kk), 1);
    }
  }
  wgmma::wgmma_commit();
}

// EW = 4 / ES rows' 16 bytes (rows[e]: CW = 16 / ES columns of row e) ->
// CW words, word j holding column j's EW elements, row 0 in the low bits
template <int ES>
__device__ __forceinline__ void transpose(const uint4 (&rows)[4 / ES], uint32_t (&w)[16 / ES]) {
  const uint32_t* v[4 / ES];
#pragma unroll
  for (int e = 0; e < 4 / ES; ++e) v[e] = reinterpret_cast<const uint32_t*>(&rows[e]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 32-bit word i of each row
    if constexpr (ES == 1) {  // bytes: columns 4i .. 4i + 3
      const uint32_t lo01 = __byte_perm(v[0][i], v[1][i], 0x5140);
      const uint32_t hi01 = __byte_perm(v[0][i], v[1][i], 0x7362);
      const uint32_t lo23 = __byte_perm(v[2][i], v[3][i], 0x5140);
      const uint32_t hi23 = __byte_perm(v[2][i], v[3][i], 0x7362);
      w[4 * i] = __byte_perm(lo01, lo23, 0x5410);
      w[4 * i + 1] = __byte_perm(lo01, lo23, 0x7632);
      w[4 * i + 2] = __byte_perm(hi01, hi23, 0x5410);
      w[4 * i + 3] = __byte_perm(hi01, hi23, 0x7632);
    } else {  // halves: columns 2i, 2i + 1
      w[2 * i] = __byte_perm(v[0][i], v[1][i], 0x5410);
      w[2 * i + 1] = __byte_perm(v[0][i], v[1][i], 0x7632);
    }
  }
}

// acc += float(d) * w
template <typename D>
__device__ __forceinline__ void accumulate(float (&acc)[32], const D (&d)[32], float w) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = fmaf(static_cast<float>(d[e]), w, acc[e]);
}

// TAIL: rows longer than KA k-steps (their further k-steps' A from shared
// memory); a kernel of its own, so that the probe's k = 256 holds no
// registers for it
template <typename T, bool PROF, bool TAIL>
__global__ void __launch_bounds__(THREADS, 3)
dot_chain_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ out, int m,
                 int k, int n, int n_iter, long long* __restrict__ clocks) {
  using D = typename Chain<T>::D;
  constexpr int KA = Chain<T>::KA, ES = sizeof(T), EW = 4 / ES;  // elements a 32-bit word
  extern __shared__ unsigned char smem_raw[];
  // slabs start on 1024-byte boundaries (the 128-byte swizzle's atom)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int kbytes = k * ES, ks = kbytes / 32, nslab = (kbytes + 127) / 128;
  unsigned char* ys = smem;                // B: (BN rows, kbytes), slab s at s * SLAB
  unsigned char* xs = smem + nslab * SLAB;  // A's rows (TAIL)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  long long t0 = 0, t_wait = 0, t_cvt = 0;
  if constexpr (PROF) t0 = clock64();

  // A: rows r0 = m0 + 16 warp + g and r0 + 8, words at bytes 4t and 16 + 4t
  // of each 32-byte k-step (the m16n8k16 / m16n8k32 fragment of the warp's
  // 16 rows); rows past m are zero. In flight while y is staged.
  const int words = kbytes / 4;
  const int r0 = m0 + 16 * warp + g;
  const uint32_t* xr0 = reinterpret_cast<const uint32_t*>(x) + static_cast<long long>(r0) * words;
  const uint32_t* xr1 = xr0 + 8LL * words;
  uint32_t a[KA][4];
#pragma unroll
  for (int kk = 0; kk < KA; ++kk) {
    const int w0 = kk * 8 + t;
    const bool in = kk < ks;
    a[kk][0] = in && r0 < m ? __ldg(xr0 + w0) : 0u;
    a[kk][1] = in && r0 + 8 < m ? __ldg(xr1 + w0) : 0u;
    a[kk][2] = in && r0 < m ? __ldg(xr0 + w0 + 4) : 0u;
    a[kk][3] = in && r0 + 8 < m ? __ldg(xr1 + w0 + 4) : 0u;
  }
  // y (k, n) row-major -> ys row j, word q: y[q * EW + e][n0 + j], e < EW
  // (the K-major tile). Where y's rows are 16-byte aligned, a thread reads
  // 16 bytes (CW columns) of each of EW rows and turns them into CW words
  // by byte permutes (neighbouring threads on neighbouring 16 bytes of a
  // row); else one element a load, neighbouring threads on neighbouring
  // columns. Columns past n are zero.
  constexpr int CW = 16 / ES, CHUNKS = BN / CW;
  if ((static_cast<long long>(n) * ES) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
#pragma unroll 2
    for (int i = tid; i < CHUNKS * words; i += THREADS) {
      const int cc = i % CHUNKS, q = i / CHUNKS, col = n0 + cc * CW;
      uint32_t wv[CW];
      if (col < n) {
        uint4 rows[EW];
#pragma unroll
        for (int e = 0; e < EW; ++e)
          rows[e] = __ldg(reinterpret_cast<const uint4*>(y + static_cast<long long>(q * EW + e) * n + col));
        transpose<ES>(rows, wv);
      } else {
#pragma unroll
        for (int j = 0; j < CW; ++j) wv[j] = 0u;
      }
      unsigned char* dst = ys + (4 * q / 128) * SLAB;
#pragma unroll
      for (int j = 0; j < CW; ++j)
        *reinterpret_cast<uint32_t*>(dst + wgmma::swz128(cc * CW + j, 4 * q % 128)) = wv[j];
    }
  } else {
    for (int i = tid; i < BN * words; i += THREADS) {
      const int j = i % BN, q = i / BN, col = n0 + j;
      uint32_t wv = 0;
      if (col < n) {
        const T* src = y + static_cast<long long>(q * EW) * n + col;
#pragma unroll
        for (int e = 0; e < EW; ++e) {
          T v = src[static_cast<long long>(e) * n];
          uint32_t bits;
          if constexpr (ES == 1)
            bits = static_cast<uint8_t>(v);
          else
            bits = *reinterpret_cast<const uint16_t*>(&v);
          wv |= bits << (8 * ES * e);
        }
      }
      *reinterpret_cast<uint32_t*>(ys + (4 * q / 128) * SLAB + wgmma::swz128(j, 4 * q % 128)) = wv;
    }
  }
  if constexpr (TAIL) {  // A's rows in shared memory too, as y's
    for (int i = tid; i < BM * words; i += THREADS) {
      const int r = i / words, q = i % words;
      const uint32_t wv = m0 + r < m ? __ldg(reinterpret_cast<const uint32_t*>(x) +
                                              static_cast<long long>(m0 + r) * words + q)
                                     : 0u;
      const int byte = 4 * q;
      *reinterpret_cast<uint32_t*>(xs + (byte / 128) * SLAB + wgmma::swz128(r, byte % 128)) = wv;
    }
  }
  wgmma::fence_proxy_async();  // the staged tiles before wgmma reads them
  __syncthreads();
  long long t1 = 0;
  if constexpr (PROF) t1 = clock64();

  const uint32_t sb = wgmma::smem_u32(ys), sa = wgmma::smem_u32(xs);
  float acc[32];
  D d0[32], d1[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f, d0[e] = d1[e] = 0;

  // product i into d[i % 2]; i + 1 issued before product i is converted
  product<T, TAIL>(d0, a, sa, sb, ks);
  for (int i = 0; i < n_iter; i += 2) {
    long long c0 = 0;
    if constexpr (PROF) c0 = clock64();
    if (i + 1 < n_iter) {
      product<T, TAIL>(d1, a, sa, sb, ks);
      wgmma_wait1();
    } else {
      wgmma::wgmma_wait0();
    }
    wgmma::fence_regs(d0);
    long long c1 = 0;
    if constexpr (PROF) c1 = clock64();
    accumulate(acc, d0, 1.0f + static_cast<float>(i));
    if constexpr (PROF) {
      const long long c2 = clock64();
      t_wait += c1 - c0, t_cvt += c2 - c1, c0 = c2;
    }
    if (i + 1 >= n_iter) break;
    if (i + 2 < n_iter) {
      product<T, TAIL>(d0, a, sa, sb, ks);
      wgmma_wait1();
    } else {
      wgmma::wgmma_wait0();
    }
    wgmma::fence_regs(d1);
    if constexpr (PROF) c1 = clock64();
    accumulate(acc, d1, 2.0f + static_cast<float>(i));
    if constexpr (PROF) {
      const long long c2 = clock64();
      t_wait += c1 - c0, t_cvt += c2 - c1;
    }
  }

  // acc's layout: element 4j + 2h + e at row r0 + 8h, column 8j + 2t + e
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= m || col >= n) continue;
      float* o = out + static_cast<long long>(row) * n + col;
      if (col + 1 < n && n % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[0] = acc[4 * j + 2 * h];
        if (col + 1 < n) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
  if constexpr (PROF) {
    if (tid == 0) {
      long long* c = clocks + 4LL * (blockIdx.y * gridDim.x + blockIdx.x);
      c[0] = t1 - t0, c[1] = t_wait, c[2] = t_cvt, c[3] = clock64() - t0;
    }
  }
}

// alignment slack, y's tile, and A's where its rows do not fit registers
int smem_bytes(int kbytes, int is_int8) {
  const int slabs = (kbytes + 127) / 128;
  const int ka_bytes = 32 * (is_int8 ? Chain<int8_t>::KA : Chain<bf16>::KA);
  return 1024 + slabs * SLAB * (kbytes > ka_bytes ? 2 : 1);
}

template <typename T, bool TAIL>
void* kernel_of(bool prof) {
  return prof ? reinterpret_cast<void*>(dot_chain_kernel<T, true, TAIL>)
              : reinterpret_cast<void*>(dot_chain_kernel<T, false, TAIL>);
}

// The kernel of a call: int8 or bf16, rows past the registers (tail), clocks
void* pick(int is_int8, bool tail, bool prof) {
  if (!is_int8) return tail ? kernel_of<bf16, true>(prof) : kernel_of<bf16, false>(prof);
  return tail ? kernel_of<int8_t, true>(prof) : kernel_of<int8_t, false>(prof);
}

}  // namespace

// x (m, k) and y (k, n) contiguous, x 4-byte aligned, int8 (is_int8 != 0)
// or bf16; out (m, n) f32. k * sizeof(element) a multiple of 32, at most
// 992 bytes. clocks: null, or 4 int64 a block of the
// (ceil(n / 64), ceil(m / 64)) grid, row-major: clock64 of staging, of
// waiting on products, of converting them, and of the block. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int mma_probe_dot_chain(const void* x, const void* y, void* out, int m, int k, int n,
                                   int n_iter, int is_int8, void* clocks,
                                   void* stream) {
  const int kbytes = k * (is_int8 ? 1 : 2);
  if (m <= 0 || n <= 0 || n_iter <= 0 || k <= 0 || kbytes % 32 != 0 || kbytes > KMAX_BYTES ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ka_bytes = 32 * (is_int8 ? Chain<int8_t>::KA : Chain<bf16>::KA);
  void* kernel = pick(is_int8, kbytes > ka_bytes, clocks != nullptr);
  const int smem = smem_bytes(kbytes, is_int8);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  void* args[] = {(void*)&x, (void*)&y, &out, &m, &k, &n, &n_iter, &clocks};
  err = cudaLaunchKernel(kernel, grid, dim3(THREADS), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The resources of the chain's kernel (int8 or bf16) at the probe's k = 256: out = {registers, spilled bytes a thread,
// shared memory a block, resident blocks an SM}.
extern "C" int mma_probe_attrs(int is_int8, int* out) {
  void* kernel = pick(is_int8, false, false);
  const int smem = smem_bytes(256 * (is_int8 ? 1 : 2), is_int8);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = smem;
  out[3] = blocks;
  return 0;
}
