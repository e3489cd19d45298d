// Flash attention backward at head dim 256 on fp32 operands (the default
// build), for Hopper (sm_90a): the dQ kernel and the dK / dV kernel on
// split-bf16 wgmma products, TMA and a warp-specialised pipeline, and the
// split pass that feeds them (and, at d = 32, 64 and 80,
// flash_sdpa_bwd_h_fp32.cu and flash_sdpa_bwd_dq_h_fp32.cu).
// bf16 at d = 256 is flash_sdpa_bwd_wide_h.cu's (the design this one starts
// from); the smaller head dims are the *_h.cu and *_h_fp32.cu kernels'.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`
// (`_bwd_dq_kernel` :930, its pallas_call at :1082; `_bwd_dkv_kernel` :970,
// at :1098) where the tracker's memory attention runs under autograd in
// the default build: self-attention q/k/v (8, 1, 5184, 256) and the plain
// path's cross-attention over up to 36352 keys, 8 object slots of which 3
// are live.
//
// What it computes is the Pallas kernels' function at fp32: P = exp(S *
// scale + key_bias - lse) in fp32, 0 on a row whose lse is masked (<=
// -5e8); dS = P o (dP - Delta); P and dS enter the gradient products as
// fp32 (JAX's p.astype(v.dtype) is a no-op at fp32), the scale applied to
// dQ and dK at the end; the dq kernel also writes Delta = rowsum(dO o O)
// from fp32 O and dO. Key tiles whose keys are all masked are skipped, a
// slot whose keys are all masked gets zero gradients, ragged Lq and Lk are
// masked in the kernel; q, k, v and dO take any (B, H, N) strides with D
// contiguous; dQ, dK and dV are written in (B, N, H, D) memory order. No
// atomics: a rerun gives the same bits.
//
// Products. wgmma's tf32 form needs both operands K-major, and the B
// operands of dV += P^T dO, dK += dS^T Q and dQ += dS K are MN-major;
// tf32 would also keep ~2^-11 of a product. So every product is three bf16
// wgmma on split parts (wgmma_common.cuh: hi = bf16(x), lo = bf16(x - hi);
// a b = hi hi + hi lo + lo hi, ~2^-16 of a product), as the mma.sync
// kernels before them did, and P, dS are split in registers.
//
// Where the split happens. An fp32 landing tile does not fit beside the
// parts in shared memory, and wgmma cannot read fp32 as bf16:
//  - streamed operands (K and V in dq, Q and dO in dkv), which every block
//    of their slot reads again, are split once a call by split_parts_kernel
//    into a (2, B, H, N, 256) bf16 copy (hi, then lo) that TMA reads: the
//    same bytes as the fp32 tensor. For K and V it writes only the rows of
//    32-key tiles that hold a live key, which are all the dq kernel reads
//    (an unwritten row of a read tile would put NaN into 0 * NaN);
//  - resident operands (Q and dO in dq, K and V in dkv), read once a block,
//    are split in the prologue from fp32 in device memory: the hi part kept
//    in registers as the A operand of the score product (64 registers a
//    thread), the lo part written to shared memory in TMA's 128-byte
//    swizzle.
//
// Budget (227 KB of shared memory, 240 registers a consumer thread), and
// why. Resident lo parts take 64 KB; a 32-row stage of the streamed pair
// in two parts takes 64 KB, so two stages fit and TMA loads overlap the
// products (a 64-row stage would take 128 KB: one stage, no overlap). The
// price is N = 32 score products. Each score product is 16 k-steps of
// X_hi Y_hi and X_hi Y_lo (X_hi from registers) and X_lo Y_hi (both from
// shared memory), each gradient product 2 k-steps of G_hi Z_hi, G_hi Z_lo
// and G_lo Z_hi with G from registers and Z MN-major.
//   dq: a block owns 64 queries; group 0 holds Q_hi (64 registers) and
//   computes S, P and dS; group 1 holds dO_hi and computes dP, sent to
//   group 0 in fp32 (8 KB); dS goes back as hi / lo A fragments (8 KB);
//   each group adds dS K[:, 128 g ..) into its half of dQ (64 registers).
//   The tensor cores' fp32 accumulation truncates, and a sum over 36352 keys
//   would carry its bias (1.3e-4 of dQ's largest magnitude at 36352 keys
//   when the mma.sync kernel summed in the tensor cores), but a
//   second 64-register fragment to add each tile into spills: so the
//   fragment sums FLUSH key tiles and is then added into the block's own
//   output rows in device memory with round-to-nearest (flush_dq; the
//   last flush applies the scale). Both groups issue the next tile's score
//   product with this tile's gradient product: 64 + 64 + 16 + 16 registers.
//   dkv: a block owns 64 keys; group 0 computes S^T and P^T (sent to group 1
//   in fp32, 8 KB) and dV += P^T dO, group 1 dP^T, dS^T and dK += dS^T Q.
//   A group holds dV or dK (128 registers), so it keeps only NR = 12 of
//   K_hi's or V_hi's 16 k-steps in registers (48) and the last slab in
//   shared memory (8 KB a group), and does not overlap the next tile's
//   score product with this tile's gradient product: both would hold two
//   tiles' fragments at once and spill. The sums over Lq (5184) go straight
//   into the accumulator, as the mma.sync kernel did within the 1e-4
//   tolerance.
//
// Bound on the H100 at the [fp32] clip's cross shape (q (8, 1, 5184, 256),
// k/v (8, 1, 10376, 256), 31128 live keys): the function's products at the
// TF32 rate, dq 0.5007 ms and dkv 0.6676 ms (chip_smoke.py); three bf16
// products at the bf16 rate put this design's own floor at 1.5x those,
// 0.75 and 1.00 ms. The split passes move ~0.30 GB (K and V of the live
// slots, all of Q and dO, read in fp32 and written as parts: ~0.09 ms at
// the memory rate).
//
// As built (ptxas, cudaFuncGetAttributes; chip_smoke.py [build]): 168
// registers a thread at launch, 240 a consumer thread (setmaxnreg), no
// spills, one block an SM; shared memory dq 217,984 bytes at 36352 keys,
// dkv 222,752. On the H100 (80GB HBM3, 700 W), split passes included, in a
// CUDA graph: chip_smoke.py's [fp32] rows at the cross shape dq 1.8311 ms,
// dkv 1.7028 (the mma.sync kernels before them: 4.4089 / 5.1066); variants
// by bench_bwd_d256.py --dtype fp32 --set NAME=VALUE, in turns with the
// kept build (cross / self shape):
//   kept (FLUSH 64, NR 12): dq 1.8709 / 0.9538, dkv 1.6189 / 0.8384 ms;
//   dkv issuing the next tile's score product with this tile's gradient
//     product, as the dq kernel does (timed with a switch since removed):
//     2.0784 / 1.0649 (16 bytes spilled, ptxas C7512: wgmma serialised for
//     want of registers);
//   NR 16 (all of K_hi / V_hi in registers): dkv 2.0539 / 1.0737 (16 bytes
//     spilled, C7512);
//   FLUSH 16 / 4: dq 1.9280 / 0.9740 and 2.1372 / 1.0779.
// A first build with a second 64-register dQ fragment a tile (no flush)
// and both kernels pipelined spilled in both and was not timed.
//
// Why a file of its own and not the bf16 kernels templated on the parts:
// the two designs part where the registers go. Here a resident operand is
// split in the prologue (its hi part in registers, lo in shared memory, the
// dkv kernel keeping only NR k-steps of it), the streamed tiles are half as
// tall, each product is three, and the dq kernel flushes its fragment into
// device memory; a template would branch on the parts at each of those
// places. What both share is in wgmma_common.cuh: the descriptors, TMA
// slab loads, live-tile list, producer loop, the dq kernel's dS step and
// the dkv kernel's P^T exchange (dq_ds, dkv_send_p, dkv_recv_ds), the
// zeroing exit of a dead block and the epilogue store.

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int D = 256;
constexpr int BR = 64;            // rows a block owns: queries (dq) or keys (dkv)
constexpr int BS = 32;            // streamed rows a stage: keys (dq) or queries (dkv)
constexpr int NSTAGE = 2;
constexpr int NCONS = 256;        // two consumer warpgroups and a producer warpgroup
constexpr int NTHP = NCONS + 128;
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
constexpr int RSLAB = BR * 128;   // a 64-row, 64-column slab (128-byte rows)
constexpr int RTILE = 4 * RSLAB;  // one part of a 64 x 256 tile
constexpr int SSLAB = BS * 128;   // a 32-row slab
constexpr int STILE = 4 * SSLAB;  // one part of a 32 x 256 tile
constexpr int STAGE = 4 * STILE;  // two operands of two parts

// Split copies: hi at batch b of a (2 B, H, N, 256) map, lo at b + B.
__device__ __forceinline__ void load_parts(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int row0, int h, int b, int B) {
  tma_load_slabs<SSLAB>(dst, map, bar, row0, h, b);
  tma_load_slabs<SSLAB>(dst + STILE, map, bar, row0, h, b + B);
}

// A resident 64-row fp32 operand of one (batch, head), as this thread's
// fragments (rows row0 + (warp % 4) * 16 + {g, g + 8}, rows past n 0): the
// hi parts of the first NR k-steps of 16 columns as A fragments, those of
// the rest written to the slabs at hi_s (NR a multiple of 4: whole 64-column
// slabs), the lo parts to the 64-row tile at lo_s (shared, 128-byte
// swizzle). The caller fences and syncs the warpgroup before wgmma reads
// them.
template <int NR>
__device__ __forceinline__ void load_resident(uint32_t (&a)[NR][4], unsigned char* lo_s,
                                              unsigned char* hi_s, const float* x, long long sn,
                                              int row0, int n) {
  static_assert(NR % 4 == 0 && NR <= D / 16, "whole slabs in registers");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tr0 = (warp & 3) * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tr = tr0 + 8 * (e & 1), c = 16 * kk + 8 * (e >> 1) + 2 * t;
      float2 v = make_float2(0.f, 0.f);
      if (row0 + tr < n) v = *reinterpret_cast<const float2*>(x + (row0 + tr) * sn + c);
      uint32_t hi, lo;
      split_pair(v.x, v.y, hi, lo);
      const uint32_t at = swz128(tr, (c & 63) * 2);
      *reinterpret_cast<uint32_t*>(lo_s + (c >> 6) * RSLAB + at) = lo;
      if (kk < NR)
        a[kk < NR ? kk : 0][e] = hi;
      else
        *reinterpret_cast<uint32_t*>(hi_s + ((c >> 6) - NR / 4) * RSLAB + at) = hi;
    }
}

// acc (64 x 32) = X Y^T over the 256 columns in split parts: X_hi Y_hi and
// X_hi Y_lo with X_hi from registers (k-steps below NR; the rest from the
// slabs at x_hi), X_lo Y_hi with X_lo the resident 64-row tile at x_lo; Y a
// streamed 32-row tile (hi at y, lo at y + STILE); all K-major. The fence comes first: the product may be issued inside a
// branch while the previous tile's gradient product runs (ptxas would
// insert and serialise its own arrives there, C7519 / C7520). The addresses
// pass through an empty asm, so that the 48 descriptors are made here each
// time and not hoisted out of the caller's loop into registers.
template <int NR>
__device__ __forceinline__ void score3(float (&acc)[16], const uint32_t (&xa)[NR][4],
                                       uint32_t x_lo, uint32_t x_hi, uint32_t y) {
  asm volatile("" : "+r"(x_lo), "+r"(x_hi), "+r"(y));
  const uint64_t dyh = desc_k<128>(y, 0), dyl = desc_k<128>(y + STILE, 0);
  const uint64_t dxl = desc_k<128>(x_lo, 0), dxh = desc_k<128>(x_hi, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NR; ++kk) {
    wgmma_rs<0>(acc, xa[kk], dyh + kstep_off<SSLAB>(kk), kk > 0);
    wgmma_rs<0>(acc, xa[kk], dyl + kstep_off<SSLAB>(kk));
  }
#pragma unroll
  for (int kk = NR; kk < D / 16; ++kk) {
    wgmma_m64n32k16_ss(acc, dxh + kstep_off<RSLAB>(kk - NR), dyh + kstep_off<SSLAB>(kk), 1);
    wgmma_m64n32k16_ss(acc, dxh + kstep_off<RSLAB>(kk - NR), dyl + kstep_off<SSLAB>(kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n32k16_ss(acc, dxl + kstep_off<RSLAB>(kk), dyh + kstep_off<SSLAB>(kk), 1);
}

// acc (64 x N) (+)= G Z over 32 rows in split parts: G_hi Z_hi + G_hi Z_lo +
// G_lo Z_hi, G (64 x 32) as hi and lo A fragments of two k-steps, Z a
// streamed 32-row tile (hi at z, lo at z + STILE) read MN-major from the
// slab at z on (N = 128: two slabs, 256: four). fresh: the first product
// overwrites acc.
template <int NACC>
__device__ __forceinline__ void grad3(float (&acc)[NACC], const uint32_t (&gh)[2][4],
                                      const uint32_t (&gl)[2][4], uint32_t z, bool fresh) {
  asm volatile("" : "+r"(z));  // as in score3
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_rs(acc, gh[kk], desc_mn_wide(z, kk, SSLAB), !(fresh && kk == 0));
    wgmma_rs(acc, gh[kk], desc_mn_wide(z + STILE, kk, SSLAB));
    wgmma_rs(acc, gl[kk], desc_mn_wide(z, kk, SSLAB));
  }
}

// ---------------------------------------------------------------- split
// hi and lo of the rows of x (B, H, n, SD) f32 with element strides (sb,
// sh, sn), into parts (2, B, H, n, SD) bf16 contiguous, SD = 256 (this
// file's kernels, flash_sdpa_h_fp32.cu's d = 256 forward and
// flash_memattn_h.cu's keys) or 32, 64 and 80 (flash_sdpa_bwd_h_fp32.cu's Q
// and dO, flash_sdpa_bwd_dq_h_fp32.cu's and flash_sdpa_h_fp32.cu's K and V,
// flash_memattn_h.cu's values at 64): 8 columns a lane, SD / 8 lanes a row,
// RPB rows a block of 256 (25 at SD = 80, whose 10 lanes a row leave the
// last 6 threads idle). With tile > 0 (SD = 256 and 64) a row is written
// only when its tile of `tile` rows holds a live key (key_bias (B, lkb) >
// -5e8): the row's lanes read the tile's biases between them.
template <int SD>
__host__ __device__ constexpr int split_rows_a_block() {
  return 256 / (SD / 8);
}

template <int SD>
__global__ void __launch_bounds__(256)
split_parts_kernel(const float* __restrict__ x, const float* __restrict__ key_bias,
                   bf16* __restrict__ parts, int B, int H, int n, int lkb, int tile, long long sb,
                   long long sh, long long sn) {
  constexpr int LPR = SD / 8;  // lanes a row
  constexpr int RPB = split_rows_a_block<SD>();
  if (threadIdx.x >= RPB * LPR) return;
  const long long rows = static_cast<long long>(B) * H * n;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + threadIdx.x / LPR;
  const bool in = row < rows;
  const int lane = threadIdx.x % LPR;
  const int r = static_cast<int>(row % n);
  const long long bh = row / n;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  if constexpr (SD == 256 || SD == 64) {
    if (tile > 0) {  // a whole warp of rows takes this branch (tile is the call's)
      const int t0 = r / tile * tile;
      bool live = false;
      if (in)
        for (int i = t0 + lane; i < t0 + tile && i < lkb; i += LPR)
          live |= key_bias[static_cast<long long>(b) * lkb + i] > 0.5f * NEG_INF;
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1)  // the row's LPR lanes, aligned in the warp
        live |= __shfl_xor_sync(0xffffffffu, live, off);
      if (!live) return;
    }
  }
  if (!in) return;  // at SD = 256 the whole warp
  const float4* src = reinterpret_cast<const float4*>(x + b * sb + h * sh + r * sn + lane * 8);
  const float4 a = src[0], c = src[1];
  uint4 hi, lo;
  split_pair(a.x, a.y, hi.x, lo.x);
  split_pair(a.z, a.w, hi.y, lo.y);
  split_pair(c.x, c.y, hi.z, lo.z);
  split_pair(c.z, c.w, hi.w, lo.w);
  bf16* dst = parts + row * SD + lane * 8;
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + rows * SD) = lo;
}

// ---------------------------------------------------------------- dq
namespace dq {
// key tiles a dQ fragment sums before it is added into the output rows
constexpr int FLUSH = 64;
constexpr int OFF_S = 0;                             // [NSTAGE] stages: K hi, K lo, V hi, V lo
constexpr int K_OFF = 0, V_OFF = 2 * STILE;          // within a stage
constexpr int OFF_X = OFF_S + NSTAGE * STAGE;        // Q lo (group 0), dO lo (group 1)
constexpr int OFF_BIAS = OFF_X + 2 * RTILE;          // [NSTAGE][BS] f32
constexpr int OFF_DP = OFF_BIAS + NSTAGE * BS * 4;   // dP, [16][128] f32
constexpr int OFF_DS = OFF_DP + 16 * 128 * 4;        // dS hi / lo fragments, [16][128] u32
constexpr int OFF_DELTA = OFF_DS + 16 * 128 * 4;     // [BR] f32
constexpr int OFF_BAR = OFF_DELTA + BR * 4;          // full[NSTAGE], empty[NSTAGE]
constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte a tile, then the list
constexpr int STAGE_TX = STAGE + BS * 4;
constexpr int BAR_DP = 1, BAR_DS = 2, BAR_G = 3;     // named barriers: dP sent, dS sent, a group
int bytes(int ntiles) {
  return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
}
}  // namespace dq

// Add this thread's part of a 64 x 128 dQ fragment (rows r0, r1 of the
// block, columns col0 + 8 n + 2 t) into the output rows with round-to-
// nearest: the rows hold the sum of the earlier fragments unless `first`;
// `last` applies the scale. Rows past lq are not touched.
__device__ __forceinline__ void flush_dq(float* dq, long long sgn, const float (&acc)[64], int q0,
                                         int r0, int lq, int col0, bool first, bool last,
                                         float sm_scale) {
  const int t = threadIdx.x & 3;
  const float mul = last ? sm_scale : 1.f;
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int row = q0 + r0 + 8 * hrow;
    if (row >= lq) continue;
    float* out = dq + row * sgn + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      float2 v = make_float2(acc[4 * n + 2 * hrow], acc[4 * n + 2 * hrow + 1]);
      if (!first) {
        const float2 prev = *reinterpret_cast<const float2*>(out + 8 * n);
        v.x += prev.x;
        v.y += prev.y;
      }
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(v.x * mul, v.y * mul);
    }
  }
}

__global__ void __launch_bounds__(NTHP, 1)
flash_bwd_dq_wide_f32_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_bias,
                             const float* __restrict__ key_bias, const float* __restrict__ q,
                             const float* __restrict__ o, const float* __restrict__ dout,
                             const float* __restrict__ lse, float* __restrict__ delta,
                             float* __restrict__ dq, int B, int H, int lq, int lk, int lkb,
                             float sm_scale, long long sqb, long long sqh, long long sqn,
                             long long sob, long long soh, long long son, long long sdb,
                             long long sdh, long long sdn, long long sgb, long long sgh,
                             long long sgn) {
  using namespace dq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  float* delta_s = reinterpret_cast<float*>(smem + OFF_DELTA);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (lk + BS - 1) / BS;
  unsigned char* tile_live = smem + OFF_LIVE;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += static_cast<long long>(b) * lkb;
  q += b * sqb + h * sqh;
  dout += b * sdb + h * sdh;
  dq += b * sgb + h * sgh;

  // Delta = rowsum(dO o O) in fp32, 4 consumer threads a row of 64 columns
  if (threadIdx.x < NCONS) {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
    float sum = 0.f;
    if (row < lq) {
      const float4* orow = reinterpret_cast<const float4*>(o + b * sob + h * soh + row * son +
                                                           part * 64);
      const float4* drow = reinterpret_cast<const float4*>(dout + row * sdn + part * 64);
#pragma unroll 4
      for (int c = 0; c < 16; ++c) {
        const float4 ov = orow[c], dv = drow[c];
        sum += ov.x * dv.x + ov.y * dv.y + ov.z * dv.z + ov.w * dv.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      if (row < lq) delta[static_cast<long long>(bh) * lq + row] = sum;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  const int nlive = live_tiles<BS, NTHP>(key_bias, lkb, ntiles, tile_live, live_list,
                                         reinterpret_cast<int*>(smem + OFF_NLIVE));

  if (nlive == 0) {  // an empty slot: zero dQ, no loads
    zero_rows<BR, D, NTHP>(dq, sgn, q0, lq);
    return;
  }

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nlive, bar_full, bar_empty, STAGE_TX, [&](int i, int s, uint32_t full) {
        const int key0 = live_list[i] * BS;
        const uint32_t st = s_base + OFF_S + s * STAGE;
        load_parts(st + K_OFF, &tm_k, full, key0, h, b, B);
        load_parts(st + V_OFF, &tm_v, full, key0, h, b, B);
        tma_load_2d(s_base + OFF_BIAS + s * BS * 4, &tm_bias, full, key0, b);
      });
    return;
  }

  // ---------------- consumer warpgroups: group 0 S, P, dS; group 1 dP
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  const int wg = warp >> 2, wt = threadIdx.x & 127;
  const int r0 = (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's rows of the tile
  const float scale2 = sm_scale * LOG2E;
  float* xs = reinterpret_cast<float*>(smem + OFF_DP);
  uint32_t* dss = reinterpret_cast<uint32_t*>(smem + OFF_DS);
  const float* bias_s = reinterpret_cast<const float*>(smem + OFF_BIAS);

  // Q (group 0) or dO (group 1): hi as A fragments, lo resident
  uint32_t xa[D / 16][4];
  const uint32_t x_lo = s_base + OFF_X + wg * RTILE;
  if (wg == 0)
    load_resident(xa, smem + OFF_X, nullptr, q, sqn, q0, lq);
  else
    load_resident(xa, smem + OFF_X + RTILE, nullptr, dout, sdn, q0, lq);
  fence_proxy_async();
  named_sync<128>(BAR_G + wg);

  float acc[64];  // dQ[:, 128 wg .. 128 wg + 128) over the tiles since the last flush
  float sc[16];  // S (group 0) or dP (group 1) of the next tile
  uint32_t dh[2][4], dl[2][4];  // dS as hi / lo A fragments of two k-steps of 16 keys
  const uint32_t y_off = wg == 0 ? K_OFF : V_OFF;

  // the first tile's S or dP
  mbar_wait(bar_full, 0);
  score3(sc, xa, x_lo, 0, s_base + OFF_S + y_off);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(sc);

  if (wg == 0) {
    float nl0 = DEAD, nl1 = DEAD;
    if (q0 + r0 < lq) {
      const float l = lse[static_cast<long long>(bh) * lq + q0 + r0];
      if (l > 0.5f * NEG_INF) nl0 = -l * LOG2E;
    }
    if (q0 + r1 < lq) {
      const float l = lse[static_cast<long long>(bh) * lq + q0 + r1];
      if (l > 0.5f * NEG_INF) nl1 = -l * LOG2E;
    }
    const float dl0 = delta_s[r0], dl1 = delta_s[r1];
    for (int i = 0; i < nlive; ++i) {
      const int s = i % NSTAGE;
      named_sync<NCONS>(BAR_DP);  // dP of tile i
      dq_ds<4>(sc, bias_s + s * BS, xs, live_list[i] * BS, lk, scale2, nl0, nl1, dl0, dl1);
      split_frags<4>(sc, dh, dl);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dss[(kk * 4 + e) * 128 + wt] = dh[kk][e];
          dss[(8 + kk * 4 + e) * 128 + wt] = dl[kk][e];
        }
      named_arrive<NCONS>(BAR_DS);

      // dQ[:, 0 .. 128) += dS K[:, 0 .. 128) (a fresh fragment every FLUSH
      // tiles), then the next tile's S
      grad3(acc, dh, dl, s_base + OFF_S + s * STAGE + K_OFF, i % FLUSH == 0);
      wgmma_commit();
      if (i + 1 < nlive) {
        const int s1 = (i + 1) % NSTAGE;
        mbar_wait(bar_full + 8 * s1, ((i + 1) / NSTAGE) & 1);
        score3(sc, xa, x_lo, 0, s_base + OFF_S + s1 * STAGE + K_OFF);
        wgmma_commit();
      }
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(sc);
      fence_regs(dh);
      fence_regs(dl);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
      if ((i + 1) % FLUSH == 0 || i + 1 == nlive)
        flush_dq(dq, sgn, acc, q0, r0, lq, 0, i < FLUSH, i + 1 == nlive, sm_scale);
    }
  } else {
    xchg_put(xs, wt, sc);
    named_arrive<NCONS>(BAR_DP);  // dP of tile 0
    for (int i = 0; i < nlive; ++i) {
      const int s = i % NSTAGE;
      // the next tile's dP, while group 0 turns this tile's dP into dS
      if (i + 1 < nlive) {
        const int s1 = (i + 1) % NSTAGE;
        mbar_wait(bar_full + 8 * s1, ((i + 1) / NSTAGE) & 1);
        score3(sc, xa, x_lo, 0, s_base + OFF_S + s1 * STAGE + V_OFF);
        wgmma_commit();
      }
      named_sync<NCONS>(BAR_DS);  // dS of tile i
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dh[kk][e] = dss[(kk * 4 + e) * 128 + wt];
          dl[kk][e] = dss[(8 + kk * 4 + e) * 128 + wt];
        }
      // dQ[:, 128 .. 256) += dS K[:, 128 .. 256)
      grad3(acc, dh, dl, s_base + OFF_S + s * STAGE + K_OFF + 2 * SSLAB, i % FLUSH == 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(sc);
      fence_regs(dh);
      fence_regs(dl);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
      if ((i + 1) % FLUSH == 0 || i + 1 == nlive)
        flush_dq(dq, sgn, acc, q0, r0, lq, 128, i < FLUSH, i + 1 == nlive, sm_scale);
      if (i + 1 < nlive) {  // group 0 has read dP of tile i (it sent dS)
        xchg_put(xs, wt, sc);
        named_arrive<NCONS>(BAR_DP);
      }
    }
  }
}

// ---------------------------------------------------------------- dkv
namespace dkv {
// k-steps of K_hi / V_hi held in registers; the last slab's hi parts stay
// in shared memory (16 registers a thread fewer: 240 hold dV or dK, the rest
// of the resident operand and a tile's scores without spilling)
constexpr int NR = 12;
constexpr int OFF_X = 0;                              // K lo (group 0), V lo (group 1)
constexpr int OFF_XH = OFF_X + 2 * RTILE;             // K hi, V hi: their last 16 - NR k-steps
constexpr int OFF_S = OFF_XH + 2 * (16 - NR) / 4 * RSLAB;  // [NSTAGE] stages: Q hi, Q lo, dO hi, dO lo
constexpr int Q_OFF = 0, DO_OFF = 2 * STILE;          // within a stage
constexpr int OFF_LSE = OFF_S + NSTAGE * STAGE;       // [NSTAGE][BS] f32
constexpr int OFF_DELTA = OFF_LSE + NSTAGE * BS * 4;  // [NSTAGE][BS] f32
constexpr int OFF_P = OFF_DELTA + NSTAGE * BS * 4;    // P^T, [16][128] f32
constexpr int OFF_BAR = OFF_P + 16 * 128 * 4;         // full[NSTAGE], empty[NSTAGE]
constexpr int SMEM = 1024 + OFF_BAR + 2 * NSTAGE * 8;
constexpr int STAGE_TX = STAGE + 2 * BS * 4;
constexpr int BAR_READY = 1, BAR_FREE = 2, BAR_G = 3;  // named barriers: P^T sent, read; a group
}  // namespace dkv

__global__ void __launch_bounds__(NTHP, 1)
flash_bwd_dkv_wide_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_lse,
                              const __grid_constant__ CUtensorMap tm_delta,
                              const float* __restrict__ key_bias, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ dk,
                              float* __restrict__ dv, int B, int H, int lq, int lk,
                              float sm_scale, long long skb, long long skh, long long skn,
                              long long svb, long long svh, long long svn, long long skgb,
                              long long skgh, long long skgn, long long svgb, long long svgh,
                              long long svgn) {
  using namespace dkv;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + OFF_BAR, bar_empty = bar_full + NSTAGE * 8;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  key_bias += static_cast<long long>(b) * lk;
  k += b * skb + h * skh;
  v += b * svb + h * svh;
  dk += b * skgb + h * skgh;
  dv += b * svgb + h * svgh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  // every key of the block masked: zero gradients
  if (!keys_live<BR, D, NTHP>(key_bias, key0, lk, dk, skgn, dv, svgn)) return;
  const int nq = (lq + BS - 1) / BS;

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nq, bar_full, bar_empty, STAGE_TX, [&](int i, int s, uint32_t full) {
        const int q0 = i * BS;
        const uint32_t st = s_base + OFF_S + s * STAGE;
        load_parts(st + Q_OFF, &tm_q, full, q0, h, b, B);
        load_parts(st + DO_OFF, &tm_do, full, q0, h, b, B);
        tma_load_2d(s_base + OFF_LSE + s * BS * 4, &tm_lse, full, q0, bh);
        tma_load_2d(s_base + OFF_DELTA + s * BS * 4, &tm_delta, full, q0, bh);
      });
    return;
  }

  // ---------------- consumer warpgroups: group 0 P^T and dV, group 1 dK
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  const int wg = warp >> 2;
  const int kr0 = key0 + (warp & 3) * 16 + (lane >> 2), kr1 = kr0 + 8;  // this thread's keys
  const float scale2 = sm_scale * LOG2E;
  const float kb0 = kr0 < lk ? key_bias[kr0] * LOG2E : NEG_INF * LOG2E;
  const float kb1 = kr1 < lk ? key_bias[kr1] * LOG2E : NEG_INF * LOG2E;
  float* ps = reinterpret_cast<float*>(smem + OFF_P);
  const float* lse_s = reinterpret_cast<const float*>(smem + OFF_LSE);
  const float* delta_s = reinterpret_cast<const float*>(smem + OFF_DELTA);

  // K (group 0) or V (group 1): hi as A fragments, lo resident
  uint32_t xa[NR][4];
  constexpr int XH = (16 - NR) / 4 * RSLAB;  // a group's hi slabs in shared memory
  const uint32_t x_lo = s_base + OFF_X + wg * RTILE, x_hi = s_base + OFF_XH + wg * XH;
  if (wg == 0)
    load_resident(xa, smem + OFF_X, smem + OFF_XH, k, skn, key0, lk);
  else
    load_resident(xa, smem + OFF_X + RTILE, smem + OFF_XH + XH, v, svn, key0, lk);
  fence_proxy_async();
  named_sync<128>(BAR_G + wg);

  float acc[128];  // dV (group 0) or dK (group 1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // the score product's B: Q (group 0) or dO (group 1); the gradient
  // product's: dO (group 0) or Q (group 1)
  const uint32_t y_off = wg == 0 ? Q_OFF : DO_OFF, z_off = wg == 0 ? DO_OFF : Q_OFF;
  float sc[16];  // S^T or dP^T, 64 keys x 32 queries, of the tile in hand
  for (int i = 0; i < nq; ++i) {
    const int s = i % NSTAGE;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    score3(sc, xa, x_lo, x_hi, s_base + OFF_S + s * STAGE + y_off);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    if (wg == 0)
      dkv_send_p<4, NCONS>(sc, ps, lse_s + s * BS, i, i * BS, lq, kb0, kb1, scale2, BAR_READY,
                           BAR_FREE);
    else
      dkv_recv_ds<4, NCONS>(sc, ps, delta_s + s * BS, i + 1 < nq, BAR_READY, BAR_FREE);
    uint32_t ph[2][4], pl[2][4];  // P^T or dS^T as hi / lo A fragments of two k-steps of 16 queries
    split_frags<4>(sc, ph, pl);

    // dV += P^T dO (group 0) or dK += dS^T Q (group 1), MN-major over four
    // slabs (not overlapped with the next tile's score product: the other
    // group's products fill the tensor cores meanwhile)
    grad3(acc, ph, pl, s_base + OFF_S + s * STAGE + z_off, false);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(sc);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
  }

  // keys kr0, kr1: dV (group 0) or dK * scale (group 1)
  if (wg == 0)
    store_acc(dv, svgn, acc, kr0, lk, 0, 1.f);
  else
    store_acc(dk, skgn, acc, kr0, lk, 0, sm_scale);
}

// The kernels' shared-memory limits, raised once a device (the dq
// kernel's again for a key count whose tile list needs more).
int prepare_dq(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = dq::bytes((lk + BS - 1) / BS);
  return raise_smem(flash_bwd_dq_wide_f32_kernel, *smem, smem_set);
}

int prepare_dkv() {
  static int smem_set[64] = {};
  return raise_smem(flash_bwd_dkv_wide_f32_kernel, dkv::SMEM, smem_set);
}

template <int SD>
void launch_split(const float* x, const float* key_bias, bf16* parts, int B, int H, int n,
                  int lkb, int tile, long long sb, long long sh, long long sn, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * H * n;
  constexpr long long RPB = split_rows_a_block<SD>();
  const unsigned blocks = static_cast<unsigned>((rows + RPB - 1) / RPB);
  split_parts_kernel<SD><<<blocks, 256, 0, st>>>(x, key_bias, parts, B, H, n, lkb, tile, sb, sh,
                                                 sn);
}

}  // namespace

// The split copy of x (B, H, n, d) f32, d = 256, 32, 64 or 80, element
// strides (sb, sh, sn) each a multiple of 4 and the base 16-byte aligned:
// parts (2, B, H, n, d) bf16 contiguous, hi = bf16(x) then lo = bf16(x -
// hi). With tile > 0 (d = 256 and 64) only the rows of tiles of `tile`
// rows that hold a live key (key_bias (B, lkb) f32 contiguous > -5e8) are
// written. Returns a CUDA error.
extern "C" int flash_sdpa_split_parts(const void* x, const void* key_bias, void* parts, int B,
                                      int H, int n, int d, int lkb, int tile, long long sb,
                                      long long sh, long long sn, void* stream) {
  decltype(&launch_split<32>) run = nullptr;
  if (d == 32) run = launch_split<32>;
  if (d == 64) run = launch_split<64>;
  if (d == 80) run = launch_split<80>;
  if (d == 256) run = launch_split<256>;
  if (run == nullptr || B <= 0 || H <= 0 || n <= 0 || tile < 0 ||
      (tile > 0 && ((d != 256 && d != 64) || key_bias == nullptr || lkb < n)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || sb % 4 != 0 || sh % 4 != 0 || sn % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  run(static_cast<const float*>(x), static_cast<const float*>(key_bias), static_cast<bf16*>(parts),
      B, H, n, lkb, tile, sb, sh, sn, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// dQ and Delta. q, o, dout (B, H, Lq, 256) f32 with (batch, head, row)
// element strides, each a multiple of 4 and the base 16-byte aligned; kp,
// vp the split copies of k and v (flash_sdpa_split_parts with tile 32, the
// key tile here); key_bias (B, lkb) f32 contiguous and 16-byte aligned, lkb
// >= Lk a multiple of 4, columns past Lk at -1e9; lse (B, H, Lq) f32
// contiguous; delta (B, H, Lq) f32 written; dq f32 by strides. Returns a
// CUDA error, 1000 + the CUresult if a tensor map is refused, or 999 when
// cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_bwd_dq_wide_f32(const void* q, const void* kp, const void* vp,
                                          const void* key_bias, const void* o, const void* dout,
                                          const void* lse, void* delta, void* dq, int B, int H,
                                          int lq, int lk, int lkb, float sm_scale, long long sqb,
                                          long long sqh, long long sqn, long long sob,
                                          long long soh, long long son, long long sdb,
                                          long long sdh, long long sdn, long long sgb,
                                          long long sgh, long long sgn, void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv, tb;
  CUresult r = map_parts(fn, &tk, kp, D, lk, H, B, BS);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, vp, D, lk, H, B, BS);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BS);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  int smem = 0;
  const int err = prepare_dq(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + BR - 1) / BR, B * H);
  flash_bwd_dq_wide_f32_kernel<<<grid, NTHP, smem, static_cast<cudaStream_t>(stream)>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const float*>(q),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq), B, H,
      lq, lk, lkb, sm_scale, sqb, sqh, sqn, sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn);
  return static_cast<int>(cudaGetLastError());
}

// dK and dV. qp, dop the split copies of q and dout (every row); k, v (B,
// H, Lk, 256) f32 with (batch, head, row) element strides, each a multiple
// of 4 and the base 16-byte aligned; key_bias (B, Lk) f32 contiguous; lse
// and delta (B * H, lqp) f32 contiguous and 16-byte aligned, lqp >= Lq a
// multiple of 4; dk, dv f32 by strides. Returns as
// flash_sdpa_bwd_dq_wide_f32.
extern "C" int flash_sdpa_bwd_dkv_wide_f32(const void* qp, const void* dop, const void* k,
                                           const void* v, const void* key_bias, const void* lse,
                                           const void* delta, void* dk, void* dv, int B, int H,
                                           int lq, int lk, int lqp, float sm_scale, long long skb,
                                           long long skh, long long skn, long long svb,
                                           long long svh, long long svn, long long skgb,
                                           long long skgh, long long skgn, long long svgb,
                                           long long svgh, long long svgn, void* stream) {
  if (lqp % 4 != 0 || lqp < lq || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 || reinterpret_cast<uintptr_t>(delta) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tq, tdo, tl, td;
  CUresult r = map_parts(fn, &tq, qp, D, lq, H, B, BS);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tdo, dop, D, lq, H, B, BS);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tl, lse, lqp, B * H, BS);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &td, delta, lqp, B * H, BS);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const int err = prepare_dkv();
  if (err != 0) return err;
  const dim3 grid((lk + BR - 1) / BR, B * H);
  flash_bwd_dkv_wide_f32_kernel<<<grid, NTHP, dkv::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tl, td, static_cast<const float*>(key_bias), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(dk), static_cast<float*>(dv), B, H, lq,
      lk, sm_scale, skb, skh, skn, svb, svh, svn, skgb, skgh, skgn, svgb, svgh, svgn);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' resources (wgmma_common.cuh kernel_attrs): out = {registers,
// spilled bytes a thread, shared bytes a block, blocks an SM}; the dq
// kernel's at lk keys.
extern "C" int flash_sdpa_bwd_dq_wide_f32_attrs(int lk, int* out) {
  int smem = 0;
  const int err = prepare_dq(lk, &smem);
  return err != 0 ? err : kernel_attrs(flash_bwd_dq_wide_f32_kernel, NTHP, smem, out);
}

extern "C" int flash_sdpa_bwd_dkv_wide_f32_attrs(int* out) {
  const int err = prepare_dkv();
  return err != 0 ? err : kernel_attrs(flash_bwd_dkv_wide_f32_kernel, NTHP, dkv::SMEM, out);
}
