// Same-padded 7x7 depthwise convolution over NHWC maps for Hopper (sm_90a).
//
// Replaces efficientsam3_tpu/ops/pallas/depthwise.py `_dw_call`
// (`_dw_kernel`), the forward of the tracker memory encoder's ConvNeXt
// fuser (models/memory_encoder.CXBlock): y[b, i, j, c] = bias[c] +
// sum_{di, dj} w[di, dj, c] * x[b, i + di - 3, j + dj - 3, c], zero padding,
// fp32 accumulation, bf16 in and out.
//
// Bound on the H100 at the tracker shape (8, 72, 72, 256) bf16: 21.2 MB
// in and 21.2 MB out (~12.6 us at 3.35 TB/s) against 49 fp32 FMAs an
// output, 1.04 GFLOP (~15.5 us at 67 TFLOP/s): the two bounds are close,
// with the fp32 arithmetic a little ahead. The TPU kernel's 128-lane
// channel blocking existed for the vector unit's lanes; here a block owns
// an 8-row x 16-column x 32-channel output tile of one image, copies the
// input tile with its 3-pixel halo (14 x 22 x 32 bf16, 19.7 KB) into
// shared memory once, and each thread produces a vertical strip of 8
// outputs for one column and two channels: every input value read from
// shared memory feeds up to 7 of the strip's accumulators, and the 49 x 2
// weights of its channels sit in registers. Any channel count works (a
// 16-byte staging path when C % 8 == 0, element copies otherwise), as do
// any H and W (the tiles are masked at the edges).
//
// The backward (depthwise.py `_dw_bwd`): dx is dw7_kernel over the output
// gradient with the taps flipped and a zero bias; dw and db, which JAX
// computes with jnp reductions, are dw7_wgrad_kernel: per output tile, the
// 49 x C tap sums and the C bias sums in fp32 from one staged copy of the
// tile of x (with its halo) and of g, written as per-block partials that
// one sum finishes (~1 GFLOP of fp32 FMAs and two 21 MB reads at the
// tracker shape: ~31 us at the fp32 peak).
//
// fp32 maps (the default build) take the same kernels: the arithmetic was
// fp32 FMA already, so only the loads, the stores and the staged tiles'
// type change. An fp32 tile of 32 channels would take 39 KB (the weight
// gradient's two tiles 55 KB, past the 48 KB of static shared memory), so
// the fp32 kernels run 16-channel tiles: CG is a template parameter with
// the thread count, 32 at bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 7, PAD = 3;
constexpr int TH = 8, TW = 16;  // output tile: rows, columns
constexpr int SH = TH + KS - 1, SW = TW + KS - 1;

// Channels a block owns, and its threads: one per (channel pair, column)
// in the forward, one per (channel pair, tap row) in the weight gradient.
template <typename T>
struct Cfg {
  static constexpr int CG = sizeof(T) == 2 ? 32 : 16;
  static constexpr int NT = (CG / 2) * TW;
  static constexpr int NTW = (CG / 2) * KS;
  static constexpr int EPC = 16 / sizeof(T);  // elements in a 16-byte chunk
};

__device__ __forceinline__ float2 ld_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st_one(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void st_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void zero(bf16& x) { x = __float2bfloat16(0.f); }
__device__ __forceinline__ void zero(float& x) { x = 0.f; }

// Copy the ROWS x COLS x CG block at (y0, x0, c0) of one (H, W, C) map into
// shared memory, zero outside the map: 16-byte chunks when `vec` (C a
// multiple of the chunk's elements and an aligned map), element copies
// otherwise.
template <int ROWS, int COLS, int NTHR, typename T>
__device__ __forceinline__ void stage_tile(T (*tile)[COLS][Cfg<T>::CG], const T* xb, int H,
                                           int W, int C, int y0, int x0, int c0, int vec) {
  constexpr int CG = Cfg<T>::CG, EPC = Cfg<T>::EPC;
  if (vec) {
    constexpr int CH = CG / EPC;
    for (int i = threadIdx.x; i < ROWS * COLS * CH; i += NTHR) {
      const int ch = i % CH, p = i / CH, xx = p % COLS, yy = p / COLS;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + ch * EPC;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        val = *reinterpret_cast<const uint4*>(xb + ((long long)gy * W + gx) * C + gc);
      *reinterpret_cast<uint4*>(&tile[yy][xx][ch * EPC]) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS * CG; i += NTHR) {
      const int c = i % CG, p = i / CG, xx = p % COLS, yy = p / COLS;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + c;
      T val;
      zero(val);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        val = xb[((long long)gy * W + gx) * C + gc];
      tile[yy][xx][c] = val;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::NT, 2)
dw7_kernel(const T* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, T* __restrict__ out, int H, int W,
           int C, int tiles_x, int vec) {
  constexpr int CG = Cfg<T>::CG;
  __shared__ __align__(16) T tile[SH][SW][CG];
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int c0 = blockIdx.y * CG, b = blockIdx.z;
  stage_tile<SH, SW, Cfg<T>::NT>(tile, x + (long long)b * H * W * C, H, W, C, ty * TH - PAD,
                                 tx * TW - PAD, c0, vec);
  __syncthreads();

  const int cp = threadIdx.x % (CG / 2), xl = threadIdx.x / (CG / 2);
  const int ca = c0 + 2 * cp;  // this thread's channels: ca, ca + 1
  const int gx = tx * TW + xl;
  if (ca >= C || gx >= W) return;
  const bool has1 = ca + 1 < C;
  float wa[KS * KS], wb[KS * KS];
#pragma unroll
  for (int i = 0; i < KS * KS; ++i) {
    wa[i] = w[i * C + ca];
    wb[i] = has1 ? w[i * C + ca + 1] : 0.f;
  }
  float acc[TH][2];
#pragma unroll
  for (int o = 0; o < TH; ++o) acc[o][0] = acc[o][1] = 0.f;
#pragma unroll
  for (int r = 0; r < SH; ++r) {
#pragma unroll
    for (int dj = 0; dj < KS; ++dj) {
      const float2 val = ld_f2(&tile[r][xl + dj][2 * cp]);
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        const int di = r - o;
        if (di >= 0 && di < KS) {
          acc[o][0] = fmaf(wa[di * KS + dj], val.x, acc[o][0]);
          acc[o][1] = fmaf(wb[di * KS + dj], val.y, acc[o][1]);
        }
      }
    }
  }
  const float ba = bias[ca], bb = has1 ? bias[ca + 1] : 0.f;
  const bool pair = has1 && (C % 2 == 0);
#pragma unroll
  for (int o = 0; o < TH; ++o) {
    const int gy = ty * TH + o;
    if (gy >= H) break;
    T* dst = out + (((long long)b * H + gy) * W + gx) * C + ca;
    if (pair) {
      st_pair(dst, acc[o][0] + ba, acc[o][1] + bb);
    } else {
      st_one(dst, acc[o][0] + ba);
      if (has1) st_one(dst + 1, acc[o][1] + bb);
    }
  }
}

// Weight and bias gradients of one output tile: dw[di, dj, c] = sum over
// the tile's 8 x 16 positions (i, j) of x[i + di - 3, j + dj - 3, c] *
// g[i, j, c], db[c] = sum of g[i, j, c], fp32. Each thread owns a channel
// pair and one tap row di and keeps its 7 x 2 sums in registers (no sum
// crosses threads); the block writes its partial sums to its own row of
// dwp (blocks, 49, C) / dbp (blocks, C), which the caller sums in fp32.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::NTW)
dw7_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 float* __restrict__ dwp, float* __restrict__ dbp, int H, int W, int C,
                 int tiles_x, int vec) {
  constexpr int CG = Cfg<T>::CG, NTW = Cfg<T>::NTW;
  __shared__ __align__(16) T xt[SH][SW][CG];
  __shared__ __align__(16) T gt[TH][TW][CG];
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int c0 = blockIdx.y * CG, b = blockIdx.z;
  const long long map = (long long)b * H * W * C;
  stage_tile<SH, SW, NTW>(xt, x + map, H, W, C, ty * TH - PAD, tx * TW - PAD, c0, vec);
  stage_tile<TH, TW, NTW>(gt, g + map, H, W, C, ty * TH, tx * TW, c0, vec);
  __syncthreads();

  const int cp = threadIdx.x % (CG / 2), di = threadIdx.x / (CG / 2);
  float acc[KS][2], s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int dj = 0; dj < KS; ++dj) acc[dj][0] = acc[dj][1] = 0.f;
#pragma unroll 1
  for (int o = 0; o < TH; ++o) {
    float2 xr[SW];
#pragma unroll
    for (int xx = 0; xx < SW; ++xx) xr[xx] = ld_f2(&xt[o + di][xx][2 * cp]);
#pragma unroll
    for (int xl = 0; xl < TW; ++xl) {
      const float2 gv = ld_f2(&gt[o][xl][2 * cp]);
      s0 += gv.x;
      s1 += gv.y;
#pragma unroll
      for (int dj = 0; dj < KS; ++dj) {
        acc[dj][0] = fmaf(xr[xl + dj].x, gv.x, acc[dj][0]);
        acc[dj][1] = fmaf(xr[xl + dj].y, gv.y, acc[dj][1]);
      }
    }
  }
  const int ca = c0 + 2 * cp;
  const long long blk = (long long)b * gridDim.x + blockIdx.x;
  float* out = dwp + blk * KS * KS * C;
#pragma unroll
  for (int dj = 0; dj < KS; ++dj) {
    if (ca < C) out[(di * KS + dj) * C + ca] = acc[dj][0];
    if (ca + 1 < C) out[(di * KS + dj) * C + ca + 1] = acc[dj][1];
  }
  if (di == 0) {
    if (ca < C) dbp[blk * C + ca] = s0;
    if (ca + 1 < C) dbp[blk * C + ca + 1] = s1;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
               int C, cudaStream_t st) {
  using Cf = Cfg<T>;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (C + Cf::CG - 1) / Cf::CG, B);
  const int vec = (C % Cf::EPC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dw7_kernel<T><<<grid, Cf::NT, 0, st>>>(static_cast<const T*>(x), static_cast<const float*>(w),
                                         static_cast<const float*>(bias), static_cast<T*>(out), H,
                                         W, C, tiles_x, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgrad(const void* x, const void* g, void* dwp, void* dbp, int B, int H, int W, int C,
                 cudaStream_t st) {
  using Cf = Cfg<T>;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (C + Cf::CG - 1) / Cf::CG, B);
  const int vec = (C % Cf::EPC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  dw7_wgrad_kernel<T><<<grid, Cf::NTW, 0, st>>>(static_cast<const T*>(x),
                                                static_cast<const T*>(g), static_cast<float*>(dwp),
                                                static_cast<float*>(dbp), H, W, C, tiles_x, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, H, W, C) contiguous, float32 when fp32 != 0 else bfloat16;
// w (k, k, C) f32; bias (C,) f32.
extern "C" int depthwise_conv2d_fwd(const void* x, const void* w, const void* bias, void* out,
                                    int B, int H, int W, int C, int k, int fp32, void* stream) {
  if (k != KS) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = fp32 ? launch_fwd<float> : launch_fwd<bf16>;
  return launch(x, w, bias, out, B, H, W, C, static_cast<cudaStream_t>(stream));
}

// Partial weight and bias gradients of the same-padded 7x7 depthwise conv:
// x, g (B, H, W, C) contiguous (float32 when fp32 != 0 else bfloat16); dwp
// (B * tiles, 49, C) and dbp (B * tiles, C) f32, tiles = ceil(H / 8) *
// ceil(W / 16), one row per block.
extern "C" int depthwise_conv2d_wgrad(const void* x, const void* g, void* dwp, void* dbp, int B,
                                      int H, int W, int C, int k, int fp32, void* stream) {
  if (k != KS) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = fp32 ? launch_wgrad<float> : launch_wgrad<bf16>;
  return launch(x, g, dwp, dbp, B, H, W, C, static_cast<cudaStream_t>(stream));
}
