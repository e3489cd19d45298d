// Row LayerNorm forward for Hopper (sm_90a): y = (x - mean) * rsqrt(var +
// eps) * w + b over the last axis, fp32 statistics, the biased two-pass
// variance, eps inside the sqrt; x and y each bf16 or fp32.
//
// Replaces efficientsam3_tpu/ops/pallas/layer_norm.py `_fwd_call` (:71, body
// `_fwd_kernel` :43). Shapes: the fusion encoder's norms, (5184, 256) bf16
// -> bf16 in the bf16 build and fp32 -> fp32 in the default one, 18 of a
// `ground`'s 27 launches; the decoder's and the tracker's, (201, 256) and
// (5184 x slots, 256).
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

int resident_blocks(void* kernel, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTH, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * per_sm;
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
  int grid = (rows + TR - 1) / TR;  // the column path: a tile a block
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
