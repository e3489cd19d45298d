// Row LayerNorm for Hopper (sm_90a), forward and backward: y = (x - mean) *
// rsqrt(var + eps) * w + b over the last axis, fp32 statistics, the biased
// two-pass variance, eps inside the sqrt; x and y each bf16 or fp32. The
// backward recomputes the statistics from x, as the JAX VJP does, and
// writes dx = rstd * (wg - mean(wg) - xhat * mean(wg * xhat)) with wg = dy *
// w (in x's dtype), dw = sum dy * xhat and db = sum dy (fp32).
//
// Replaces efficientsam3_tpu/ops/pallas/layer_norm.py `_fwd_call` (:71, body
// `_fwd_kernel` :43) and `_bwd_call` (:85, body `_bwd_kernel` :49). Shapes:
// the fusion encoder's norms, (5184, 256) bf16 -> bf16 in the bf16 build and
// fp32 -> fp32 in the default one, 18 of a `ground`'s 27 launches; the
// decoder's and the tracker's, (201, 256) and (5184 x slots, 256); the
// backward at the Stage-3 step's (4 x 5184, 256), 27 a step.
//
// Bound on the H100: bytes. (5184, 256) bf16 reads and writes 2.65 MB with
// ~8 flops an element: 0.0016 ms at 3.35 TB/s. What held the Triton kernel
// before it back (0.0173 ms in a CUDA graph): one row a program and one
// warp a program at 256 channels, so each warp had one 512-byte load in
// flight and then waited through two dependent reductions; every program
// reloaded W and B, 2 KB of fp32 for a 512-byte row.
//
// This kernel:
//  - eight warps a block, one row a warp at a time, each lane NV 16-byte
//    loads (8 bf16 or 4 fp32 columns each) strided over the row: at 256
//    bf16 channels one load a lane covers the row;
//  - W and B in registers, loaded once a warp for every row it walks;
//  - each warp walks rows at the grid's stride, and issues the next row's
//    loads before the current row's reductions, so a load is in flight
//    under every reduction;
//  - the grid is the resident blocks of every SM (the occupancy API), at
//    most one row a warp: 5184 rows are 648 blocks;
//  - statistics in fp32 by butterfly shuffles, mean first and then the sum
//    of squared deviations from the registers, as the plain version.
// A row whose width the vector does not divide, a misaligned row, or a
// row wider than 512 columns takes the masked path: one warp a row, one
// column a lane at a time, the row read three times from L1 / L2.
//
// The column path. The fusion encoder's tokens reach its norms as a
// channel-major map seen as (rows, c): a row's columns 5184 elements
// apart (x strides (1, 5184)). Made contiguous first, as the Triton
// forward's wrapper did, the copy took 0.0122 of the call's 0.0150 ms
// (profiler, H100 80GB HBM3, 700 W). This path reads that layout itself:
// a block stages 16 consecutive rows of every column in shared memory
// (32 or 64 adjacent bytes a column, 16 a thread), then each warp
// normalises its rows from the tile and writes them row-major; up to 256
// columns (wider strided rows take the masked path). 16 rows a block (324
// blocks at 5184 rows) ran faster than 8 or 32 (bench_decoder_kernels.py
// times the chosen one).
//
// The backward (its own section below) is bound by bytes too: at (4 x
// 5184, 256) bf16 it reads x and dy and writes dx, 31.9 MB, 0.0095 ms. The
// Triton kernel it replaces ran one warp a program walking 32 rows, each
// two loads and four dependent reductions with nothing in flight, and a
// second launch summed its partials (0.0386 ms). Here it reuses the
// forward's machinery: a row a warp, the next row's x and dy in flight
// under the current row's two reduction rounds (sum x and sum wg; then sum
// (x - mean)^2 and sum wg (x - mean)), W in registers. A lane owns fixed
// columns, so its dw and db sums stay in registers over every row its warp
// walks; the block's warps add them in shared memory into one row a block.
// The last block of each group of ~sqrt(blocks) blocks sums its group's
// rows, and the last such block sums the groups' rows into dw and db (an
// atomic ticket at each level, sums in block order: the same bits on every
// run), in the same launch. Channel-major x or dy (the fusion encoder's
// tokens, at batch 4 a (4, 5184, 256) view of strides (1327104, 1, 5184)
// that no row axis describes) take a column path with batch strides: a
// block stages 16 rows of x and dy, its warps take each row's statistics,
// then a thread a column writes dx row-major and adds that column's dw and
// db over the tile. Other layouts and widths up to 8192 take a masked path
// (a row a block, a thread's columns 256 apart).
//
// RMSNorm's backward (`rms_norm_bwd`) is a mode of the vector and masked
// backward kernels. It replaces efficientsam3_tpu/ops/pallas/rms_norm.py
// `_bwd_call` (:83, body `_bwd_kernel` :38) and the call's final sum of the
// per-block partials (:106): xhat = x rstd from the forward's saved rstd
// (read, not recomputed), dx = rstd (wg - xhat mean(wg xhat)), dw = sum dy
// xhat and db = sum dy in fp32. Row-major (rows, c) only; no mean, so a
// row takes one reduction round, and each row's rstd load is in flight
// with its x and dy. Bound by bytes: at the tracker's (8, 72, 72, 256)
// bf16 it reads x and dy and writes dx, 63.9 MB with rstd, 0.0191 ms. The
// Triton kernel it replaces (0.0692 ms in a CUDA graph) wrote 16-row
// partials of dw and db (5.3 MB) that a second launch summed; here they
// stay in registers and are finished in the launch by the same tickets.
// Rows up to 256 columns take the vector path, wider ones the masked path.
// At 97 registers (bf16) one 512-thread block is resident an SM, 16 warps
// with two rows' loads ahead each; capped at 64 registers for two blocks
// the bf16 kernel spilled and ran slower (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int NTH = 32 * WARPS;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC elements of T in a 16-byte load, as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

// VEC floats stored as T at p (VEC * sizeof(T) bytes, aligned to that)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&v);
    }
    if constexpr (VEC == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

// The vector path: lane l holds vectors v * 32 + l (VEC columns each) of a
// row, v < NV; vectors at or past c are masked.
template <typename TI, typename TO, int NV>
__global__ void __launch_bounds__(NTH)
ln_fwd_vec(const TI* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
           TO* __restrict__ y, int rows, int c, long long sx, long long sy, float eps) {
  constexpr int VEC = 16 / sizeof(TI);
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;

  bool live[NV];
  float wr[NV][VEC], br[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = (v * 32 + lane) * VEC;
    live[v] = col < c;
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f), bv = wv;
      if (live[v]) {
        wv = *reinterpret_cast<const float4*>(w + col + i);
        bv = *reinterpret_cast<const float4*>(bias + col + i);
      }
      wr[v][i] = wv.x, wr[v][i + 1] = wv.y, wr[v][i + 2] = wv.z, wr[v][i + 3] = wv.w;
      br[v][i] = bv.x, br[v][i + 1] = bv.y, br[v][i + 2] = bv.z, br[v][i + 3] = bv.w;
    }
  }

  uint4 cur[NV], nxt[NV];
  auto load = [&](uint4 (&buf)[NV], int r) {
    const TI* xr = x + r * sx;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      buf[v] = live[v] ? __ldg(reinterpret_cast<const uint4*>(xr + (v * 32 + lane) * VEC))
                       : make_uint4(0u, 0u, 0u, 0u);
  };
  load(cur, row);
  const float inv_c = 1.f / static_cast<float>(c);
  for (; row < rows; row += nwarps) {
    if (row + nwarps < rows) load(nxt, row + nwarps);  // in flight under this row's work
    float xv[NV][VEC];
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      unpack<TI>(cur[v], xv[v]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += xv[v][i];
    }
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = live[v] ? xv[v][i] - mean : 0.f;
        xv[v][i] = d;
        q += d * d;
      }
    const float rstd = 1.f / sqrtf(warp_sum(q) * inv_c + eps);
    TO* yr = y + row * sy;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!live[v]) continue;
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = xv[v][i] * rstd * wr[v][i] + br[v][i];
      store_vec<TO, VEC>(yr + (v * 32 + lane) * VEC, out);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) cur[v] = nxt[v];
  }
}

// The masked path: any width and alignment, one column a lane at a time.
template <typename TI, typename TO>
__global__ void __launch_bounds__(NTH)
ln_fwd_any(const TI* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
           TO* __restrict__ y, int rows, int c, long long sx, long long sxc, long long sy,
           float eps) {
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * WARPS;
  const float inv_c = 1.f / static_cast<float>(c);
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows; row += nwarps) {
    const TI* xr = x + row * sx;
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += to_f(xr[i * sxc]);
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float d = to_f(xr[i * sxc]) - mean;
      q += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) * inv_c + eps);
    TO* yr = y + row * sy;
    for (int i = lane; i < c; i += 32)
      from_f(yr + i, (to_f(xr[i * sxc]) - mean) * rstd * w[i] + bias[i]);
  }
}

constexpr int TR = 16;          // rows a block of the column path
constexpr int COLS_MAX = 256;   // its widest row: the tile is 17,408 bytes

// The column path: rows r0 .. r0 + TR of x (row stride sx, column stride
// sxc), staged as tile[col][row] (a row stride of TR + 1 floats: the
// warp's reads of one row down the columns hit 32 banks). Adjacent rows
// (sx = 1) 16-byte aligned load 16 bytes a thread, 8 bf16 or 4 fp32 rows
// of a column; else one element a thread.
template <typename TI, typename TO>
__global__ void __launch_bounds__(NTH)
ln_fwd_cols(const TI* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
            TO* __restrict__ y, int rows, int c, long long sx, long long sxc, long long sy,
            float eps) {
  constexpr int CPL = COLS_MAX / 32;  // columns a lane at most
  constexpr int VEC = 16 / sizeof(TI), CHUNKS = TR / VEC;
  __shared__ float tile[COLS_MAX][TR + 1];
  const int r0 = blockIdx.x * TR, nr = min(TR, rows - r0);
  const TI* xb = x + r0 * sx;
  if (nr == TR && sx == 1 && sxc % VEC == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0) {
#pragma unroll 4
    for (int i = threadIdx.x; i < c * CHUNKS; i += NTH) {
      const int col = i / CHUNKS, r = (i % CHUNKS) * VEC;
      float f[VEC];
      unpack<TI>(__ldg(reinterpret_cast<const uint4*>(xb + col * sxc + r)), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tile[col][r + j] = f[j];
    }
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < c * TR; i += NTH) {
      const int col = i / TR, r = i % TR;
      tile[col][r] = r < nr ? to_f(xb[r * sx + col * sxc]) : 0.f;
    }
  }
  const int lane = threadIdx.x & 31;
  float wr[CPL], br[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int col = lane + 32 * k;
    wr[k] = col < c ? w[col] : 0.f;
    br[k] = col < c ? bias[col] : 0.f;
  }
  __syncthreads();
  const float inv_c = 1.f / static_cast<float>(c);
  for (int r = threadIdx.x >> 5; r < nr; r += WARPS) {
    float v[CPL];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int col = lane + 32 * k;
      v[k] = col < c ? tile[col][r] : 0.f;
      s += v[k];
    }
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float d = lane + 32 * k < c ? v[k] - mean : 0.f;
      v[k] = d;
      q += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) * inv_c + eps);
    TO* yr = y + (r0 + r) * sy;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int col = lane + 32 * k;
      if (col < c) from_f(yr + col, v[k] * rstd * wr[k] + br[k]);
    }
  }
}

// vectors a lane, 16 columns: 512 of either dtype (at 32 a lane bf16 spills)
__host__ __device__ constexpr int nv_max(int x_bytes) { return x_bytes == 4 ? 4 : 2; }

// The kernel a call takes, by path (nv = 1, 2 or 4: the vector path with
// nv vectors a lane; 0: the masked path; -1: the column path).
template <typename TI, typename TO>
void* pick(int nv) {
  if (nv == -1) return reinterpret_cast<void*>(ln_fwd_cols<TI, TO>);
  if (nv == 1) return reinterpret_cast<void*>(ln_fwd_vec<TI, TO, 1>);
  if (nv == 2) return reinterpret_cast<void*>(ln_fwd_vec<TI, TO, 2>);
  if constexpr (nv_max(sizeof(TI)) == 4)
    if (nv == 4) return reinterpret_cast<void*>(ln_fwd_vec<TI, TO, 4>);
  return reinterpret_cast<void*>(ln_fwd_any<TI, TO>);
}

void* kernel_for(int x_fp32, int y_fp32, int nv) {
  if (x_fp32) return y_fp32 ? pick<float, float>(nv) : pick<float, bf16>(nv);
  return y_fp32 ? pick<bf16, float>(nv) : pick<bf16, bf16>(nv);
}

// The path for c columns of x at column stride sxc and row stride sx: the
// column path for strided columns up to COLS_MAX; else the vector path when
// c and sx are multiples of the vector (8 bf16 or 4 fp32), x 16-byte
// aligned and at most nv_max vectors a lane cover the row (`rest`: the
// other operands aligned for its 16-byte loads and stores); else the
// masked path.
int path(const void* x, int c, long long sx, long long sxc, int x_fp32, bool rest) {
  if (sxc != 1) return c <= COLS_MAX ? -1 : 0;
  const int vec = x_fp32 ? 4 : 8;
  if (!rest || c % vec != 0 || sx % vec != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return 0;
  const int need = (c + 32 * vec - 1) / (32 * vec);
  for (int nv = 1; nv <= nv_max(x_fp32 ? 4 : 2); nv *= 2)
    if (nv >= need) return nv;
  return 0;
}

int resident_blocks(void* kernel, int* out, int threads = NTH, int smem = 0) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * per_sm;
  return 0;
}

// ---------------------------------------------------------------- backward

constexpr int BWARPS = 16, BNT = 32 * BWARPS;  // the backward's blocks: 512 threads
constexpr int BTR = BWARPS;  // rows a tile of the column path: a warp a row

struct BwdArgs {
  const void* x;
  const void* g;
  const float* w;
  const float* rstd;  // RMS mode: the forward's rstd a row (rows,); else unread
  void* dx;        // (rows, c) row-major, x's dtype
  float* dw;       // (c,)
  float* db;       // (c,)
  float* part;     // (grid + groups, 2c): a block's dw / db sums, then each group's
  int* cnt;        // groups + 1 zeroed tickets, left zeroed
  long long sxb, sxn, sxc, sgb, sgn, sgc;  // x and g: row r = (r / n, r % n), column
  int nb, n, c, gsize;                      // gsize: blocks a group of the finish
  float eps;
};

template <typename T>
__device__ __forceinline__ float ldg_f(const T* p) { return to_f(__ldg(p)); }

// VEC elements of T as they are loaded (16 or 8 bytes), and as floats
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <typename T, int VEC>
using Raw = typename RawOf<VEC * static_cast<int>(sizeof(T))>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack_raw(const Raw<T, VEC>& u, float* f) {
  if constexpr (VEC * sizeof(T) == 16) {
    unpack<T>(u, f);
  } else {  // 4 bf16 in 8 bytes
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sum over rows k < count of part[(first + k) * stride + j], in k order, 16
// loads in flight
__device__ __forceinline__ float ordered_sum(const float* part, long long first, int count,
                                             long long stride, int j) {
  float v = 0.f;
  for (int k0 = 0; k0 < count; k0 += 16) {
    float t[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      t[u] = k0 + u < count ? __ldcg(part + (first + k0 + u) * stride + j) : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) v += t[u];
  }
  return v;
}

// The block's dw / db sums are in part's row blockIdx.x: the last block of
// each group of gsize blocks adds its group's rows (in block order) into the
// group's row, and the last group adds the groups' rows into dw and db.
__device__ __forceinline__ void fence_gpu() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }

// A ticket of counter k after the block's writes: true in the last of n
// blocks to take one (the block's threads all see it, and every other
// block's writes before its ticket). The block's barrier, then one thread's
// release / acquire fence around the atomic.
__device__ __forceinline__ bool last_ticket(int* cnt, int n, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_gpu();
    const bool last = atomicAdd(cnt, 1) == n - 1;
    if (last) fence_gpu();
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

__device__ void bwd_finish(const BwdArgs& a) {
  __shared__ int last;
  const int G = gridDim.x, c2 = 2 * a.c;
  const int groups = (G + a.gsize - 1) / a.gsize, grp = blockIdx.x / a.gsize;
  const int first = grp * a.gsize, members = min(a.gsize, G - first);
  if (!last_ticket(a.cnt + grp, members, &last)) return;
  for (int j = threadIdx.x; j < c2; j += BNT)
    a.part[static_cast<long long>(G + grp) * c2 + j] = ordered_sum(a.part, first, members, c2, j);
  if (threadIdx.x == 0) a.cnt[grp] = 0;
  if (!last_ticket(a.cnt + groups, groups, &last)) return;
  for (int j = threadIdx.x; j < c2; j += BNT) {
    const float v = ordered_sum(a.part, G, groups, c2, j);
    if (j < a.c)
      a.dw[j] = v;
    else
      a.db[j - a.c] = v;
  }
  if (threadIdx.x == 0) a.cnt[groups] = 0;
}

// The vector path: x and dy row-major (columns adjacent), lane l holds
// vectors v * 32 + l (VEC columns each) of a row, v < NV; VEC is 8 when
// both are bf16 (a 16-byte load), else 4. Each warp walks rows at the
// grid's stride with the loads of the next two rows in registers: three
// rows' buffers used in turn (the loop unrolled by three), so no register
// is copied while its load is in flight. (A ring of rows in shared memory
// filled by cp.async, with pairs of rows' reductions interleaved, ran
// slower at the Stage-3 shape.)
//
// RMS mode (rms_norm_bwd): no mean; rstd is the forward's, read a row (its
// load in flight with the row's x and dy), so a row takes one reduction
// round, sum wg x, and dx = rstd (wg - xhat mean(wg xhat)).
template <typename TX, typename TG, int NV, bool RMS>
__global__ void __launch_bounds__(BNT)
ln_bwd_vec(const BwdArgs a) {
  constexpr int VEC = (sizeof(TX) == 4 || sizeof(TG) == 4) ? 4 : 8, CW = NV * 32 * VEC;
  __shared__ float red[BWARPS / 2][2][CW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = a.nb * a.n, c = a.c, nwarps = gridDim.x * BWARPS;
  const TX* x = static_cast<const TX*>(a.x);
  const TG* g = static_cast<const TG*>(a.g);
  TX* dx = static_cast<TX*>(a.dx);
  bool live[NV];
  float wr[NV][VEC], dwp[NV][VEC], dbp[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = (v * 32 + lane) * VEC;
    live[v] = col < c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      wr[v][i] = live[v] ? a.w[col + i] : 0.f;
      dwp[v][i] = dbp[v][i] = 0.f;
    }
  }
  using RX = Raw<TX, VEC>;
  using RG = Raw<TG, VEC>;
  // three rows' loads in registers, used in turn
  RX xa[NV], xb[NV], xc[NV];
  RG ga[NV], gb[NV], gc[NV];
  float ra = 0.f, rb = 0.f, rc = 0.f;  // RMS: the rows' rstd
  auto load = [&](RX (&xo)[NV], RG (&go)[NV], float& ro, int r) {
    if (r >= rows) return;
    if constexpr (RMS) ro = __ldg(a.rstd + r);
    const int bi = r / a.n, i = r - bi * a.n;
    const TX* xr = x + bi * a.sxb + i * a.sxn;
    const TG* gr = g + bi * a.sgb + i * a.sgn;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * 32 + lane) * VEC;
      if (live[v]) {
        xo[v] = __ldg(reinterpret_cast<const RX*>(xr + col));
        go[v] = __ldg(reinterpret_cast<const RG*>(gr + col));
      } else {
        xo[v] = RX{};
        go[v] = RG{};
      }
    }
  };
  const float inv_c = 1.f / static_cast<float>(c);
  auto process = [&](const RX (&xr)[NV], const RG (&gr)[NV], float rs, int row) {
    float xv[NV][VEC], gv[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      unpack_raw<TX, VEC>(xr[v], xv[v]);
      unpack_raw<TG, VEC>(gr[v], gv[v]);
    }
    float rstd, c1 = 0.f, c2;
    if constexpr (RMS) {
      float p = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) p += gv[v][i] * wr[v][i] * xv[v][i];
      rstd = rs;
      c2 = warp_sum(p) * rstd * inv_c;
    } else {
      float s = 0.f, sg = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s += xv[v][i];
          sg += gv[v][i] * wr[v][i];
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        sg += __shfl_xor_sync(0xffffffffu, sg, o);
      }
      const float mean = s * inv_c;
      c1 = sg * inv_c;
      float q = 0.f, p = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = live[v] ? xv[v][i] - mean : 0.f;
          xv[v][i] = d;
          q += d * d;
          p += gv[v][i] * wr[v][i] * d;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        q += __shfl_xor_sync(0xffffffffu, q, o);
        p += __shfl_xor_sync(0xffffffffu, p, o);
      }
      rstd = 1.f / sqrtf(q * inv_c + a.eps);
      c2 = p * rstd * inv_c;
    }
    TX* dr = dx + static_cast<long long>(row) * c;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = xv[v][i] * rstd;
        out[i] = rstd * (gv[v][i] * wr[v][i] - c1 - xhat * c2);
        dwp[v][i] += gv[v][i] * xhat;
        dbp[v][i] += gv[v][i];
      }
      if (live[v]) store_vec<TX, VEC>(dr + (v * 32 + lane) * VEC, out);
    }
  };
  int row = blockIdx.x * BWARPS + warp;
  load(xa, ga, ra, row);
  load(xb, gb, rb, row + nwarps);
  for (; row < rows; row += 3 * nwarps) {  // each row's loads two rows ahead
    load(xc, gc, rc, row + 2 * nwarps);
    process(xa, ga, ra, row);
    if (row + nwarps >= rows) break;
    load(xa, ga, ra, row + 3 * nwarps);
    process(xb, gb, rb, row + nwarps);
    if (row + 2 * nwarps >= rows) break;
    load(xb, gb, rb, row + 4 * nwarps);
    process(xc, gc, rc, row + 2 * nwarps);
  }
  // the block's sums, in warp order: warps 0-7 write, 8-15 add theirs, then
  // the 8 rows are added
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    if ((warp >> 3) == half) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (live[v])
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float* r = &red[warp & 7][0][(v * 32 + lane) * VEC + i];
            r[0] = half ? r[0] + dwp[v][i] : dwp[v][i];
            r[CW] = half ? r[CW] + dbp[v][i] : dbp[v][i];
          }
    }
    __syncthreads();
  }
  float* mine = a.part + static_cast<long long>(blockIdx.x) * 2 * c;
  for (int j = threadIdx.x; j < 2 * c; j += BNT) {
    const int k = j < c ? 0 : 1, col = j - k * c;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < BWARPS / 2; ++w) v += red[w][k][col];
    mine[j] = v;
  }
  bwd_finish(a);
}

// The column path (c <= COLS_MAX, any strides): blocks walk tiles of BTR rows
// of one image, staged as tile[col][row] (x and dy), and each warp takes one
// row of the tile as the vector path takes a row: lane l holds columns l +
// 32 k, their dw and db sums in registers over every tile the block walks.
//
// The tiles come in by cp.async through a ring of RAW_STAGES raw copies,
// two tiles ahead of the one computed: by 16-byte vectors down each column
// where rows are adjacent (sn = 1; a ragged last tile's vectors cut short,
// zero-filled), along each row where columns are (sc = 1); other layouts
// are read element by element as the tile is staged.
constexpr int RAW_STAGES = 3;

// One operand's tiles: its layout's mode (0: rows adjacent, 1: columns
// adjacent, 2: elements); a thread's chunks of a tile (the same every
// tile); the async copy into a raw stage and the staging into
// tile[col][row].
template <typename T>
struct Tiles {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int RAW_BYTES = COLS_MAX * BTR * sizeof(T);
  static constexpr int CHUNKS = (COLS_MAX * BTR / VEC + BNT - 1) / BNT;  // a thread's, a tile
  const T* base;
  long long sb, sn, sc;
  int c, mode;
  int cu[CHUNKS], cv[CHUNKS];  // (col, row0) or (row, col0); cu < 0: no chunk

  __device__ void init(const void* p, long long sb_, long long sn_, long long sc_, int c_) {
    base = static_cast<const T*>(p), sb = sb_, sn = sn_, sc = sc_, c = c_;
    const bool al = reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % VEC == 0;
    mode = (al && sn == 1 && sc % VEC == 0)                  ? 0
           : (al && sc == 1 && sn % VEC == 0 && c % VEC == 0) ? 1
                                                              : 2;
    const int per = mode == 0 ? BTR / VEC : c / VEC;  // chunks a column / a row
    const int count = mode == 0 ? c * per : BTR * per;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = threadIdx.x + k * BNT;
      cu[k] = i < count && mode < 2 ? i / per : -1;
      cv[k] = i < count && mode < 2 ? (i % per) * VEC : 0;
    }
  }
  __device__ const T* at(int bi, int i0) const { return base + bi * sb + i0 * sn; }
  __device__ void issue(unsigned char* raw, int bi, int i0, int nr) const {
    if (mode == 2) return;
    const T* src = at(bi, i0);
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int u = cu[k], v = cv[k];
      if (u < 0) continue;
      int bytes;
      const T* from;
      T* to = reinterpret_cast<T*>(raw);
      if (mode == 0) {
        bytes = max(0, min(VEC, nr - v)) * static_cast<int>(sizeof(T));
        from = src + u * sc + v;
        to += u * BTR + v;
      } else {
        bytes = u < nr ? 16 : 0;
        from = src + u * sn + v;
        to += u * COLS_MAX + v;
      }
      cp_async16(to, bytes ? from : base, bytes);
    }
  }
  __device__ void stage(float (*tile)[BTR + 1], const unsigned char* raw, int bi, int i0,
                        int nr) const {
    if (mode == 2) {
      const T* src = at(bi, i0);
      for (int i = threadIdx.x; i < c * BTR; i += BNT) {
        const int col = sc == 1 ? i % c : i / BTR, r = sc == 1 ? i / c : i % BTR;
        tile[col][r] = r < nr ? ldg_f(src + r * sn + col * sc) : 0.f;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int u = cu[k], v = cv[k];
      if (u < 0) continue;
      const T* from = reinterpret_cast<const T*>(raw) + (mode == 0 ? u * BTR + v : u * COLS_MAX + v);
      float f[VEC];
      unpack<T>(*reinterpret_cast<const uint4*>(from), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (mode == 0)
          tile[u][v + j] = f[j];
        else
          tile[v + j][u] = f[j];
      }
    }
  }
};

template <typename TX, typename TG>
constexpr int cols_smem() {
  return RAW_STAGES * (Tiles<TX>::RAW_BYTES + Tiles<TG>::RAW_BYTES);
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(BNT)
ln_bwd_cols(const BwdArgs a) {
  constexpr int CPL = COLS_MAX / 32, XB = Tiles<TX>::RAW_BYTES;
  constexpr int STAGE = Tiles<TX>::RAW_BYTES + Tiles<TG>::RAW_BYTES;
  extern __shared__ __align__(16) unsigned char ring[];  // [RAW_STAGES][x | g]
  __shared__ float tx[COLS_MAX][BTR + 1], tg[COLS_MAX][BTR + 1];
  const int c = a.c, per_image = (a.n + BTR - 1) / BTR, tiles = a.nb * per_image;
  Tiles<TX> lx;
  Tiles<TG> lg;
  lx.init(a.x, a.sxb, a.sxn, a.sxc, c);
  lg.init(a.g, a.sgb, a.sgn, a.sgc, c);
  auto issue = [&](int tile, int stage) {
    if (tile < tiles) {
      const int bi = tile / per_image, i0 = (tile - bi * per_image) * BTR, nr = min(BTR, a.n - i0);
      lx.issue(ring + stage * STAGE, bi, i0, nr);
      lg.issue(ring + stage * STAGE + XB, bi, i0, nr);
    }
    cp_async_commit();
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wr[CPL], dwp[CPL], dbp[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    wr[k] = lane + 32 * k < c ? a.w[lane + 32 * k] : 0.f;
    dwp[k] = dbp[k] = 0.f;
  }
  const float inv_c = 1.f / static_cast<float>(c);
#pragma unroll
  for (int k = 0; k < RAW_STAGES - 1; ++k) issue(blockIdx.x + k * gridDim.x, k);
  for (int k = 0, tile = blockIdx.x; tile < tiles; ++k, tile += gridDim.x) {
    const int bi = tile / per_image, i0 = (tile - bi * per_image) * BTR, nr = min(BTR, a.n - i0);
    cp_async_wait<RAW_STAGES - 2>();
    __syncthreads();  // this tile's copies are in; the last tile's reads are done
    const unsigned char* raw = ring + (k % RAW_STAGES) * STAGE;
    lx.stage(tx, raw, bi, i0, nr);
    lg.stage(tg, raw + XB, bi, i0, nr);
    __syncthreads();
    issue(tile + (RAW_STAGES - 1) * gridDim.x, (k + RAW_STAGES - 1) % RAW_STAGES);
    const int r = warp;
    if (r < nr) {
      float xv[CPL], gv[CPL];
      float s = 0.f, sg = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < CPL; ++k2) {
        const bool live = lane + 32 * k2 < c;
        xv[k2] = live ? tx[lane + 32 * k2][r] : 0.f;
        gv[k2] = live ? tg[lane + 32 * k2][r] : 0.f;
        s += xv[k2];
        sg += gv[k2] * wr[k2];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        sg += __shfl_xor_sync(0xffffffffu, sg, o);
      }
      const float mean = s * inv_c, c1 = sg * inv_c;
      float q = 0.f, p = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < CPL; ++k2) {
        const float d = lane + 32 * k2 < c ? xv[k2] - mean : 0.f;
        xv[k2] = d;
        q += d * d;
        p += gv[k2] * wr[k2] * d;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        q += __shfl_xor_sync(0xffffffffu, q, o);
        p += __shfl_xor_sync(0xffffffffu, p, o);
      }
      const float rstd = 1.f / sqrtf(q * inv_c + a.eps), c2 = p * rstd * inv_c;
      TX* dr = static_cast<TX*>(a.dx) + (static_cast<long long>(bi) * a.n + i0 + r) * c;
#pragma unroll
      for (int k2 = 0; k2 < CPL; ++k2) {
        const int col = lane + 32 * k2;
        if (col < c) {
          const float xhat = xv[k2] * rstd;
          from_f(dr + col, rstd * (gv[k2] * wr[k2] - c1 - xhat * c2));
          dwp[k2] += gv[k2] * xhat;
          dbp[k2] += gv[k2];
        }
      }
    }
  }
  cp_async_wait<0>();
  // the block's sums in warp order, through the tiles' memory
  __syncthreads();
  float* rw = &tx[0][0];  // [BWARPS][COLS_MAX]: dw, then db in tg
  float* rb = &tg[0][0];
#pragma unroll
  for (int k2 = 0; k2 < CPL; ++k2) {
    rw[warp * COLS_MAX + lane + 32 * k2] = dwp[k2];
    rb[warp * COLS_MAX + lane + 32 * k2] = dbp[k2];
  }
  __syncthreads();
  float* mine = a.part + static_cast<long long>(blockIdx.x) * 2 * c;
  for (int j = threadIdx.x; j < 2 * c; j += BNT) {
    const float* src = j < c ? rw + j : rb + (j - c);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < BWARPS; ++w) v += src[w * COLS_MAX];
    mine[j] = v;
  }
  bwd_finish(a);
}

// The masked path: any strides, widths up to CMAX; a row a block, thread t
// holding columns t + BNT * k, its dw / db sums in registers. RMS mode as
// on the vector path: rstd read, one reduction round a row.
constexpr int CMAX = 8192, KMAX = CMAX / BNT;

__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < BWARPS; ++w) r.x += scratch[w].x, r.y += scratch[w].y;
  __syncthreads();
  return r;
}

template <typename TX, typename TG, bool RMS>
__global__ void __launch_bounds__(BNT)
ln_bwd_any(const BwdArgs a) {
  __shared__ float2 scratch[BWARPS];
  const int c = a.c, rows = a.nb * a.n;
  const TX* x = static_cast<const TX*>(a.x);
  const TG* g = static_cast<const TG*>(a.g);
  float dwp[KMAX], dbp[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) dwp[k] = dbp[k] = 0.f;
  const float inv_c = 1.f / static_cast<float>(c);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int bi = row / a.n, i = row - bi * a.n;
    const TX* xr = x + bi * a.sxb + i * a.sxn;
    const TG* gr = g + bi * a.sgb + i * a.sgn;
    float mean = 0.f, c1 = 0.f, rstd, c2;
    if constexpr (RMS) {
      rstd = a.rstd[row];
      float p = 0.f;
      for (int col = threadIdx.x; col < c; col += BNT)
        p += ldg_f(gr + col * a.sgc) * a.w[col] * ldg_f(xr + col * a.sxc);
      c2 = block_sum2(p, 0.f, scratch).x * rstd * inv_c;
    } else {
      float s = 0.f, sg = 0.f;
      for (int col = threadIdx.x; col < c; col += BNT) {
        s += ldg_f(xr + col * a.sxc);
        sg += ldg_f(gr + col * a.sgc) * a.w[col];
      }
      const float2 m = block_sum2(s, sg, scratch);
      mean = m.x * inv_c, c1 = m.y * inv_c;
      float q = 0.f, p = 0.f;
      for (int col = threadIdx.x; col < c; col += BNT) {
        const float d = ldg_f(xr + col * a.sxc) - mean;
        q += d * d;
        p += ldg_f(gr + col * a.sgc) * a.w[col] * d;
      }
      const float2 qp = block_sum2(q, p, scratch);
      rstd = 1.f / sqrtf(qp.x * inv_c + a.eps), c2 = qp.y * rstd * inv_c;
    }
    TX* dr = static_cast<TX*>(a.dx) + static_cast<long long>(row) * c;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int col = threadIdx.x + BNT * k;
      if (col < c) {
        const float xhat = (ldg_f(xr + col * a.sxc) - mean) * rstd;
        const float gv = ldg_f(gr + col * a.sgc);
        from_f(dr + col, rstd * (gv * a.w[col] - c1 - xhat * c2));
        dwp[k] += gv * xhat;
        dbp[k] += gv;
      }
    }
  }
  float* mine = a.part + static_cast<long long>(blockIdx.x) * 2 * c;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int col = threadIdx.x + BNT * k;
    if (col < c) {
      mine[col] = dwp[k];
      mine[c + col] = dbp[k];
    }
  }
  bwd_finish(a);
}

// The widest rows the vector path takes: RMSNorm's up to 256 columns (its
// wider instantiations, 512 columns, spilled 300-500 bytes; they take the
// masked path, which spills nothing)
constexpr int vec_cols(bool rms) { return rms ? 256 : 512; }

// The backward kernel a call takes, by path (nv > 0: the vector path with
// nv vectors a lane; -1: the column path; 0: the masked path) and mode
// (rms: RMSNorm's, on the vector and masked paths).
template <typename TX, typename TG, bool RMS>
void* pick_bwd(int nv) {
  constexpr int NVMAX = vec_cols(RMS) / (32 * ((sizeof(TX) == 4 || sizeof(TG) == 4) ? 4 : 8));
  if constexpr (!RMS)
    if (nv == -1) return reinterpret_cast<void*>(ln_bwd_cols<TX, TG>);
  if (nv == 1) return reinterpret_cast<void*>(ln_bwd_vec<TX, TG, 1, RMS>);
  if constexpr (NVMAX >= 2)
    if (nv == 2) return reinterpret_cast<void*>(ln_bwd_vec<TX, TG, 2, RMS>);
  if constexpr (NVMAX >= 4)
    if (nv == 4) return reinterpret_cast<void*>(ln_bwd_vec<TX, TG, 4, RMS>);
  return reinterpret_cast<void*>(ln_bwd_any<TX, TG, RMS>);
}

template <bool RMS>
void* bwd_kernel_for(int x_fp32, int g_fp32, int nv) {
  if (x_fp32) return g_fp32 ? pick_bwd<float, float, RMS>(nv) : pick_bwd<float, bf16, RMS>(nv);
  return g_fp32 ? pick_bwd<bf16, float, RMS>(nv) : pick_bwd<bf16, bf16, RMS>(nv);
}

void* bwd_kernel_for(int x_fp32, int g_fp32, int nv, bool rms) {
  return rms ? bwd_kernel_for<true>(x_fp32, g_fp32, nv) : bwd_kernel_for<false>(x_fp32, g_fp32, nv);
}

// The dynamic shared memory of the backward kernel of a path: the column
// path's raw ring
int bwd_smem(int x_fp32, int g_fp32, int nv) {
  if (nv != -1) return 0;
  if (x_fp32) return g_fp32 ? cols_smem<float, float>() : cols_smem<float, bf16>();
  return g_fp32 ? cols_smem<bf16, float>() : cols_smem<bf16, bf16>();
}

// The backward kernel of a path and mode, its dynamic shared memory allowed
void* bwd_kernel_ready(int x_fp32, int g_fp32, int nv, bool rms, int* err) {
  void* kernel = bwd_kernel_for(x_fp32, g_fp32, nv, rms);
  const int smem = bwd_smem(x_fp32, g_fp32, nv);
  *err = smem ? static_cast<int>(cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
              : 0;
  return kernel;
}

// The backward's path: the vector path when x's and dy's columns are
// adjacent, every stride and c a multiple of the vector (8 when both are
// bf16, else 4), both 16-byte aligned and at most vec_cols(rms) columns
// (`rest`: dx aligned too); else the column path up to COLS_MAX columns
// (LayerNorm's only); else the masked path.
int bwd_path(const void* x, const void* g, int c, const long long* sx, const long long* sg,
             int x_fp32, int g_fp32, bool rest, bool rms) {
  const int vec = (x_fp32 || g_fp32) ? 4 : 8;
  bool ok = rest && sx[2] == 1 && sg[2] == 1 && c % vec == 0 &&
            (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 == 0;
  for (int i = 0; i < 2; ++i) ok = ok && sx[i] % vec == 0 && sg[i] % vec == 0;
  if (ok) {
    const int need = (c + 32 * vec - 1) / (32 * vec);
    for (int nv = 1; nv <= vec_cols(rms) / (32 * vec); nv *= 2)
      if (nv >= need) return nv;
  }
  return c <= COLS_MAX && !rms ? -1 : 0;
}

int isqrt_up(int v) {
  int r = 1;
  while (r * r < v) ++r;
  return r;
}

// One launch of the backward kernel of path nv (rms: RMSNorm's) over a's
// operands: persistent blocks, the resident ones at most, their finish in
// groups of ~sqrt(grid) blocks (a's gsize set here). Returns a CUDA error.
int bwd_launch(BwdArgs a, int nv, int x_fp32, int g_fp32, bool rms, long long part_rows, int cnt_n,
               cudaStream_t stream) {
  void* kernel = bwd_kernel_for(x_fp32, g_fp32, nv, rms);
  const int smem = bwd_smem(x_fp32, g_fp32, nv);
  const long long rows = static_cast<long long>(a.nb) * a.n;
  // the blocks resident on every SM, by device, mode, dtypes and path
  static int grid_cap[64][2][4][6] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& cap = grid_cap[dev][rms][2 * x_fp32 + g_fp32][nv + 1];
  if (cap == 0) {
    int err = 0;
    bwd_kernel_ready(x_fp32, g_fp32, nv, rms, &err);
    if (err == 0) err = resident_blocks(kernel, &cap, BNT, smem);
    if (err != 0) return err;
  }
  // persistent blocks: a row a warp (vector), a tile of BTR rows (column) or
  // a row (masked) each at least
  const long long work = nv > 0 ? (rows + BWARPS - 1) / BWARPS
                                : nv == -1 ? a.nb * static_cast<long long>((a.n + BTR - 1) / BTR) : rows;
  const long long grid = min(static_cast<long long>(cap), work);
  a.gsize = isqrt_up(static_cast<int>(grid));
  const int groups = (static_cast<int>(grid) + a.gsize - 1) / a.gsize;
  if (grid + groups > part_rows || groups + 1 > cnt_n) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  e = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(BNT), args,
                       static_cast<size_t>(smem), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The resources of the backward kernel of path nv: out = {registers,
// spilled bytes a thread, nv, resident blocks an SM}.
int bwd_attrs(int x_fp32, int g_fp32, int nv, bool rms, int* out) {
  int ready = 0;
  void* kernel = bwd_kernel_ready(x_fp32, g_fp32, nv, rms, &ready);
  if (ready != 0) return ready;
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BNT,
                                                      bwd_smem(x_fp32, g_fp32, nv));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = nv;
  out[3] = blocks;
  return 0;
}

}  // namespace

// x (rows, c) with row stride sx and column stride sxc elements (bf16, or
// fp32 when x_fp32), w and b (c,) f32 contiguous, y (rows, c) with row
// stride sy (fp32 when y_fp32, else bf16). Returns a CUDA error.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b, void* y, int rows,
                              int c, long long sx, long long sxc, long long sy, int x_fp32,
                              int y_fp32, float eps, void* stream) {
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool rest = sy % 8 == 0 && (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(w) |
                                    reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const int nv = path(x, c, sx, sxc, x_fp32, rest);
  void* kernel = kernel_for(x_fp32, y_fp32, nv);
  int grid = (rows + BTR - 1) / BTR;  // the column path: a tile a block
  if (nv != -1) {  // a row a warp, the blocks resident on every SM at most
    static int grid_cap[64][4][5] = {};  // by device, dtypes and path
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    int& cap = grid_cap[dev][2 * x_fp32 + y_fp32][nv];
    if (cap == 0) {
      const int err = resident_blocks(kernel, &cap);
      if (err != 0) return err;
    }
    grid = min(cap, (rows + WARPS - 1) / WARPS);
  }
  void* vec_args[] = {(void*)&x, (void*)&w, (void*)&b, &y, &rows, &c, &sx, &sy, &eps};
  void* args[] = {(void*)&x, (void*)&w, (void*)&b, &y, &rows, &c, &sx, &sxc, &sy, &eps};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(grid), dim3(NTH), nv > 0 ? vec_args : args,
                                         0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The resources of the kernel that layer_norm_fwd takes for c columns of a
// 16-byte aligned x of row stride c (column stride 1), or with col_stride
// != 1 of column stride col_stride: out = {registers, spilled bytes a
// thread, the path (vectors a lane on the vector path, 0 the masked path,
// -1 the column path), resident blocks an SM}.
extern "C" int layer_norm_fwd_attrs(int x_fp32, int y_fp32, int c, long long col_stride,
                                    int* out) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = path(reinterpret_cast<const void*>(256), c, col_stride == 1 ? c : 1, col_stride,
                      x_fp32, true);
  void* kernel = kernel_for(x_fp32, y_fp32, nv);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NTH, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = nv;
  out[3] = blocks;
  return 0;
}

// The backward: x and dy as (nb, n, c) at strides (s*b, s*n, s*c)
// elements (x_fp32 / g_fp32: float32, else bfloat16), w (c,) f32
// contiguous; writes dx (nb * n, c) row-major in x's dtype, dw and db (c,)
// f32. part: part_rows x 2c floats of scratch, at least the grid's blocks
// (the blocks resident on the card at most: 4 of 512 threads an SM) and
// its finish's groups (ceil(grid / ceil(sqrt(grid)))); cnt: cnt_n zeroed
// ints, at least the groups and one, left zeroed. Returns a CUDA error.
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* w, void* dx, void* dw,
                              void* db, void* part, long long part_rows, void* cnt, int cnt_n,
                              int nb, int n, int c, long long sxb, long long sxn, long long sxc,
                              long long sgb, long long sgn, long long sgc, int x_fp32,
                              int g_fp32, float eps, void* stream) {
  if (nb <= 0 || n <= 0 || c <= 0 || c > CMAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long sx[3] = {sxb, sxn, sxc}, sg[3] = {sgb, sgn, sgc};
  const bool rest = reinterpret_cast<uintptr_t>(dx) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int nv = bwd_path(x, g, c, sx, sg, x_fp32, g_fp32, rest, false);
  const BwdArgs a = {x, g, static_cast<const float*>(w), nullptr, dx, static_cast<float*>(dw),
                     static_cast<float*>(db), static_cast<float*>(part), static_cast<int*>(cnt),
                     sxb, sxn, sxc, sgb, sgn, sgc, nb, n, c, 0, eps};
  return bwd_launch(a, nv, x_fp32, g_fp32, false, part_rows, cnt_n,
                    static_cast<cudaStream_t>(stream));
}

// The resources of the backward kernel that layer_norm_bwd takes for c
// columns of 16-byte aligned row-major x and dy (col_stride 1), or with
// col_stride != 1 of channel-major ones: out = {registers, spilled bytes a
// thread, the path (vectors a lane on the vector path, 0 the masked path,
// -1 the column path), resident blocks an SM}.
extern "C" int layer_norm_bwd_attrs(int x_fp32, int g_fp32, int c, long long col_stride,
                                    int* out) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[3] = {col_stride == 1 ? 16LL * c : 1, col_stride == 1 ? c : 1, col_stride};
  const void* aligned = reinterpret_cast<const void*>(256);
  return bwd_attrs(x_fp32, g_fp32, bwd_path(aligned, aligned, c, s, s, x_fp32, g_fp32, true, false),
                   false, out);
}

// RMSNorm's backward (rms_norm_2d): x and dy (rows, c) row-major
// contiguous (x_fp32 / g_fp32: float32, else bfloat16), w (c,) f32, rstd
// (rows,) f32 the forward's; writes dx (rows, c) in x's dtype and dw = sum
// dy xhat, db = sum dy (c,) f32, finished in the launch as layer_norm_bwd
// finishes them (part, part_rows, cnt and cnt_n as there). Up to 256
// columns a multiple of the vector (8 when both are bf16, else 4), 16-byte
// aligned, take the vector path; other rows the masked path (c <= CMAX).
// Returns a CUDA error.
extern "C" int rms_norm_bwd(const void* x, const void* g, const void* w, const void* rstd,
                            void* dx, void* dw, void* db, void* part, long long part_rows,
                            void* cnt, int cnt_n, int rows, int c, int x_fp32, int g_fp32,
                            void* stream) {
  if (rows <= 0 || c <= 0 || c > CMAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[3] = {0, c, 1};
  const bool rest = reinterpret_cast<uintptr_t>(dx) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int nv = bwd_path(x, g, c, s, s, x_fp32, g_fp32, rest, true);
  const BwdArgs a = {x, g, static_cast<const float*>(w), static_cast<const float*>(rstd), dx,
                     static_cast<float*>(dw), static_cast<float*>(db), static_cast<float*>(part),
                     static_cast<int*>(cnt), 0, c, 1, 0, c, 1, 1, rows, c, 0, 0.f};
  return bwd_launch(a, nv, x_fp32, g_fp32, true, part_rows, cnt_n,
                    static_cast<cudaStream_t>(stream));
}

// The resources of the kernel that rms_norm_bwd takes for c columns of
// 16-byte aligned x and dy: out = {registers, spilled bytes a thread, the
// path (vectors a lane, or 0 the masked path), resident blocks an SM}.
extern "C" int rms_norm_bwd_attrs(int x_fp32, int g_fp32, int c, int* out) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[3] = {0, c, 1};
  const void* aligned = reinterpret_cast<const void*>(256);
  return bwd_attrs(x_fp32, g_fp32, bwd_path(aligned, aligned, c, s, s, x_fp32, g_fp32, true, true),
                   true, out);
}
