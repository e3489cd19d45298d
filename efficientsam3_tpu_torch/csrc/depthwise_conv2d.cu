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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 7, PAD = 3;
constexpr int TH = 8, TW = 16, CG = 32;  // output tile: rows, columns, channels
constexpr int SH = TH + KS - 1, SW = TW + KS - 1;
constexpr int NT = (CG / 2) * TW;  // one thread per (channel pair, column)
constexpr int NTW = (CG / 2) * KS;  // weight gradient: one thread per (channel pair, tap row)

// Copy the ROWS x COLS x CG block at (y0, x0, c0) of one (H, W, C) map into
// shared memory, zero outside the map: 16-byte chunks of 8 channels when
// `vec` (C % 8 == 0 and an aligned map), element copies otherwise.
template <int ROWS, int COLS, int NTHR>
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*tile)[COLS][CG],
                                           const __nv_bfloat16* xb, int H, int W, int C,
                                           int y0, int x0, int c0, int vec) {
  if (vec) {
    constexpr int CH = CG / 8;
    for (int i = threadIdx.x; i < ROWS * COLS * CH; i += NTHR) {
      const int ch = i % CH, p = i / CH, xx = p % COLS, yy = p / COLS;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + ch * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        val = *reinterpret_cast<const uint4*>(xb + ((long long)gy * W + gx) * C + gc);
      *reinterpret_cast<uint4*>(&tile[yy][xx][ch * 8]) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS * CG; i += NTHR) {
      const int c = i % CG, p = i / CG, xx = p % COLS, yy = p / COLS;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + c;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        val = xb[((long long)gy * W + gx) * C + gc];
      tile[yy][xx][c] = val;
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
dw7_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
           int C, int tiles_x, int vec) {
  __shared__ __align__(16) __nv_bfloat16 tile[SH][SW][CG];
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int c0 = blockIdx.y * CG, b = blockIdx.z;
  stage_tile<SH, SW, NT>(tile, x + (long long)b * H * W * C, H, W, C, ty * TH - PAD,
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
      const float2 val = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&tile[r][xl + dj][2 * cp]));
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
    __nv_bfloat16* dst = out + (((long long)b * H + gy) * W + gx) * C + ca;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[o][0] + ba, acc[o][1] + bb);
    } else {
      dst[0] = __float2bfloat16(acc[o][0] + ba);
      if (has1) dst[1] = __float2bfloat16(acc[o][1] + bb);
    }
  }
}

// Weight and bias gradients of one output tile: dw[di, dj, c] = sum over
// the tile's 8 x 16 positions (i, j) of x[i + di - 3, j + dj - 3, c] *
// g[i, j, c], db[c] = sum of g[i, j, c], fp32. Each thread owns a channel
// pair and one tap row di and keeps its 7 x 2 sums in registers (no sum
// crosses threads); the block writes its partial sums to its own row of
// dwp (blocks, 49, C) / dbp (blocks, C), which the caller sums in fp32.
__global__ void __launch_bounds__(NTW)
dw7_wgrad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ dwp, float* __restrict__ dbp, int H, int W, int C,
                 int tiles_x, int vec) {
  __shared__ __align__(16) __nv_bfloat16 xt[SH][SW][CG];
  __shared__ __align__(16) __nv_bfloat16 gt[TH][TW][CG];
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
    for (int xx = 0; xx < SW; ++xx)
      xr[xx] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xt[o + di][xx][2 * cp]));
#pragma unroll
    for (int xl = 0; xl < TW; ++xl) {
      const float2 gv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gt[o][xl][2 * cp]));
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

}  // namespace

// x, out (B, H, W, C) bf16 contiguous; w (k, k, C) f32; bias (C,) f32.
extern "C" int depthwise_conv2d_fwd(const void* x, const void* w, const void* bias, void* out,
                                    int B, int H, int W, int C, int k, void* stream) {
  if (k != KS) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (C + CG - 1) / CG, B);
  const int vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dw7_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, C, tiles_x, vec);
  return static_cast<int>(cudaGetLastError());
}

// Partial weight and bias gradients of the same-padded 7x7 depthwise conv:
// x, g (B, H, W, C) bf16 contiguous; dwp (B * tiles, 49, C) and dbp (B *
// tiles, C) f32, tiles = ceil(H / 8) * ceil(W / 16), one row per block.
extern "C" int depthwise_conv2d_wgrad(const void* x, const void* g, void* dwp, void* dbp, int B,
                                      int H, int W, int C, int k, void* stream) {
  if (k != KS) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (C + CG - 1) / CG, B);
  const int vec = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  dw7_wgrad_kernel<<<grid, NTW, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(dwp), static_cast<float*>(dbp), H, W, C, tiles_x, vec);
  return static_cast<int>(cudaGetLastError());
}
