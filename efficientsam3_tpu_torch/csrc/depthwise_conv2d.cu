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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 7, PAD = 3;
constexpr int TH = 8, TW = 16, CG = 32;  // output tile: rows, columns, channels
constexpr int SH = TH + KS - 1, SW = TW + KS - 1;
constexpr int NT = (CG / 2) * TW;  // one thread per (channel pair, column)

__global__ void __launch_bounds__(NT, 2)
dw7_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
           int C, int tiles_x, int vec) {
  __shared__ __align__(16) __nv_bfloat16 tile[SH][SW][CG];
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int c0 = blockIdx.y * CG, b = blockIdx.z;
  const int y0 = ty * TH - PAD, x0 = tx * TW - PAD;
  const __nv_bfloat16* xb = x + (long long)b * H * W * C;

  if (vec) {  // C % 8 == 0: 16-byte chunks of 8 channels
    constexpr int CH = CG / 8;
    for (int i = threadIdx.x; i < SH * SW * CH; i += NT) {
      const int ch = i % CH, p = i / CH, xx = p % SW, yy = p / SW;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + ch * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        val = *reinterpret_cast<const uint4*>(xb + ((long long)gy * W + gx) * C + gc);
      *reinterpret_cast<uint4*>(&tile[yy][xx][ch * 8]) = val;
    }
  } else {
    for (int i = threadIdx.x; i < SH * SW * CG; i += NT) {
      const int c = i % CG, p = i / CG, xx = p % SW, yy = p / SW;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + c;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        val = xb[((long long)gy * W + gx) * C + gc];
      tile[yy][xx][c] = val;
    }
  }
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
