// Flash attention backward at head dim 256, bf16, for Hopper (sm_90a): the
// dQ kernel and the dK / dV kernel on wgmma, TMA and a warp-specialised
// pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`
// (`_bwd_dq_kernel` :930, its pallas_call at :1082; `_bwd_dkv_kernel` :970,
// at :1098) where the tracker's memory attention runs under autograd:
// self-attention q/k/v (8, 1, 5184, 256) and the plain path's
// cross-attention over up to 36352 keys (frame 7 of an 8-frame clip), 8
// object slots of which 3 are live, 56 + 56 launches a clip. fp32 operands
// at d = 256 are flash_sdpa_bwd_wide_h_fp32.cu's (the same design on split
// bf16 parts: wgmma's tf32 form needs both operands K-major, and V and dO
// are not); d = 32, 64 and 80 are the *_h.cu and *_h_fp32.cu kernels'.
//
// What it computes is the Pallas kernels': P rebuilt from the forward's
// saved natural-log LSE, P = exp(S * scale + key_bias - lse) in fp32, 0 on
// a row whose lse is masked (<= -5e8: every key of the batch row masked);
// dS = P o (dP - Delta) with P in fp32; P rounded to bf16 before the dV
// product and dS before the dQ and dK products, fp32 accumulation, the
// scale applied to dQ and dK at the end. The dq kernel also writes Delta =
// rowsum(dO o O) (fp32), which the dkv kernel reads. Key tiles whose keys
// are all masked are skipped; ragged Lq and Lk are masked in the kernel
// (TMA reads rows past N as zeros, and such keys score -1e9, such queries
// get P = 0); q, k, v and dO take any (B, H, N) strides with D contiguous
// (dO arrives as a view of the (B, N, H * D) gradient and TMA reads it in
// place); dQ, dK and dV are written in (B, N, H, D) memory order.
// Deterministic: every block owns its rows' sums, no atomics.
//
// Bound on the H100 at the cross shape (q (8, 1, 5184, 256), k/v (8, 1,
// 36352, 256), 108,948 live keys): the dq kernel does 3 products of
// 5184 x 108948 x 256 (S, dP, dQ), 868 GFLOP (0.877 ms at the bf16 peak),
// the dkv kernel 4 (S, dP, dV, dK), 1157 GFLOP (1.170 ms), against one
// exponential per 256 multiply-adds and ~150 MB of operands: both bound by
// the tensor cores. The mma.sync kernels before these took 5.4496 and
// 6.1859 ms there (6.2x and 5.3x): mma.sync from shared memory (a third of
// the peak), B fragments by ldmatrix.trans, cp.async tiles with no
// pipelining, P and dS through shared memory in two phases a tile.
//
// Layout (wgmma_common.cuh): a 64 x 256 bf16 tile is four 64-column slabs
// of 8 KB, each a TMA box with the 128-byte swizzle. Q K^T-type products
// read their shared-memory operands K-major (the dq kernel holds Q and dO
// in registers), moving to the next slab every four k-steps;
// dS K, P^T dO and dS^T Q read K, dO and Q MN-major with N = 128 or 256,
// across two or four slabs through the descriptor's leading byte offset.
//
// Registers: a 64-row accumulator 256 wide is 128 fp32 registers a thread
// of a warpgroup, so no warpgroup can hold two of them (dK and dV), and one
// leaves little room beside it. Each kernel's block is two consumer
// warpgroups (warps 0-7) and a producer warpgroup (warps 8-11, one thread
// of which issues TMA), one block an SM. ptxas allocates a wgmma kernel's
// registers for whole warpgroups, so at 288 threads (two consumer groups
// and a producer warp) the launch gets 168 a thread (65,536 over 384); here
// setmaxnreg moves them: 24 for the producers, 240 for the consumers.
//
// dq kernel: a block owns 64 queries. Q (group 0) and dO (group 1) are held
// in registers as the A operand of their score product (64 registers a
// thread, loaded once), and the producer streams 64-key K and V tiles (64
// KB a stage, three stages) over the block's live key tiles (a byte a tile
// from the key-bias row, compacted into a list, as flash_sdpa_h.cu). A tile:
//   group 0: S = Q K^T (m64n64k16 x 16, Q from registers, K K-major);
//   group 1: dP = dO V^T (the same), sent to group 0 as fp32 (16 KB);
//   group 0: P and dS = P o (dP - Delta) in registers (S's accumulator
//            layout is the A-operand layout), dS sent back as bf16 A
//            fragments (8 KB);
//   both:    dQ[:, 128 g .. 128 g + 128) += dS K[:, 128 g ..] (m64n128k16
//            x 4, dS from registers, K MN-major over two slabs), so each
//            group holds half of dQ (64 registers).
// Pipelined: group 1 issues the next tile's dP before it waits for this
// tile's dS, group 0 the next tile's S with this tile's dQ product, so the
// exchanges and the exponentials overlap the tensor cores' work. The
// exchanges go through shared memory in a thread-indexed layout (value e
// of thread t at [e][t]: no bank conflicts) under two named barriers.
// Delta is computed in the prologue from O and dO in device memory (4
// threads a row). A block whose key row has no live key (an empty object
// slot) writes Delta and zeros and exits before any load.
//
// dkv kernel: a block owns 64 keys; K and V (64 KB) stay resident and the
// producer streams 64-query Q and dO tiles with their lse and Delta (64 KB
// a stage, two stages). A query tile:
//   group 0: S^T = K Q^T (m64n64k16 x 16, both from shared memory), P^T in
//            fp32 registers, sent to group 1 (16 KB); dV += bf16(P^T) dO
//            (m64n256k16 x 4, dO MN-major over four slabs): 128 registers;
//   group 1: dP^T = V dO^T (the same), dS^T = P^T o (dP^T - Delta);
//            dK += bf16(dS^T) Q (m64n256k16 x 4): 128 registers.
// So each group runs two products of equal size, each group issues the
// next tile's score product with this tile's gradient product, and the
// only exchange is P^T, single-buffered under two named barriers (ready,
// free). A block whose keys are all masked writes zeros and returns.
//
// Shared memory: dq 225,008 bytes at 36352 keys (223,568 at 5184: three K
// / V stages, the exchanges, the tile list), dkv 215,080 (K, V, two Q / dO
// stages, the P^T exchange): what 227 KB holds. 32-row stages would allow
// more of them, at twice the barrier rounds and N = 32 score products,
// which read more shared memory than the tensor cores use.
//
// Waves: the dq grid is 81 query tiles x 8 slots; the 5 empty slots' 405
// blocks exit after the prologue, and the 243 live ones make 1.84 waves of
// 132 (the second 84% full: blocks are dispatched in blockIdx order, so
// dead and live blocks interleave by slot and the tail is the last live
// slot's). The dkv grid is 568 key tiles x 8 slots at frame 7, 1704 live
// blocks, 12.9 waves.
//
// As built (ptxas, cudaFuncGetAttributes; chip_smoke.py [build]): 168
// registers a thread at launch (240 for the consumers), no spills, one
// block an SM. On the H100 (80GB HBM3, 700 W; bench_bwd_d256.py and
// chip_smoke.py, PERF.md), at the cross shape in a CUDA graph:
//   first build, 288 threads, Q and dO staged, two stages, no pipelining:
//     dq 2.14 ms; dkv 4.92 ms at 168 registers with 672 bytes spilled;
//   dkv at 240 registers (setmaxnreg): 2.22 ms;
//   both CTAs of a 2-CTA cluster sharing the streamed tiles by TMA
//     multicast (half the L2 reads): dq 3.01, dkv 2.51 ms, slower: the
//     lockstep of the pair's stage barriers costs more than the reads save;
//   dq with Q and dO in registers, three stages, pipelined: 1.90 ms;
//     with the fence inside each score product (ptxas no longer inserts
//     and serialises its own): 1.53 ms;
//   dkv pipelined: 2.00 ms. Kept: 1.7x the bound each.

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int D = 256;
constexpr int BQ = 64;            // queries a tile
constexpr int BK = 64;            // keys a tile
constexpr int NCONS = 256;        // two consumer warpgroups
// and a producer warpgroup: the launch's 168 registers a thread (65,536
// over 384 threads) become 24 for the producers and 240 for the consumers
// (setmaxnreg), which hold a 64 x 256 accumulator or its half beside their
// score tile and operand fragments
constexpr int NTHP = NCONS + 128;
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
constexpr int SLAB = 64 * 128;    // a 64-row, 64-column slab (128-byte rows)
constexpr int TILE = 4 * SLAB;    // a 64 x 256 tile

// Four slabs of rows row0.. of one (batch, head) into the tile at dst.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int h, int b) {
  tma_load_slabs<SLAB>(dst, map, bar, row0, h, b);
}

// acc (64 x 64) = A B^T over the 256 columns, A and B 64-row tiles, both
// K-major (16 k-steps, a slab every four: kstep_off). The fence comes first: the
// product may be issued inside a branch while the previous tile's
// gradient product runs, and without it ptxas inserts its own warpgroup
// arrives there and serialises the wgmma (its warnings C7519 / C7520).
__device__ __forceinline__ void score(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
  const uint64_t da = desc_k<128>(a_addr, 0), db = desc_k<128>(b_addr, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n64k16_ss(acc, da + kstep_off<SLAB>(kk), db + kstep_off<SLAB>(kk), kk > 0);
  }
}

// ---------------------------------------------------------------- dq
namespace dq {
constexpr int NSTAGE = 3;                          // K / V ring
constexpr int OFF_K = 0;                           // [NSTAGE] tiles
constexpr int OFF_V = OFF_K + NSTAGE * TILE;       // [NSTAGE] tiles
constexpr int OFF_BIAS = OFF_V + NSTAGE * TILE;    // [NSTAGE][BK] f32
constexpr int OFF_X = OFF_BIAS + NSTAGE * BK * 4;  // dP, [32][128] f32
constexpr int OFF_DS = OFF_X + 32 * 128 * 4;       // dS fragments, [16][128] u32
constexpr int OFF_DELTA = OFF_DS + 16 * 128 * 4;   // [BQ] f32
constexpr int OFF_BAR = OFF_DELTA + BQ * 4;        // full[NSTAGE], empty[NSTAGE]
constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte a tile, then the list
constexpr int STAGE_TX = 2 * TILE + BK * 4;
constexpr int BAR_DP = 1, BAR_DS = 2;              // named barriers: dP sent, dS sent
int bytes(int ntiles) {
  return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
}
}  // namespace dq

// A 64-row operand of one (batch, head) as the A fragments of 16 k-steps
// of 16 columns, rows row0 + (warp % 4) * 16 + {g, g + 8} (rows past n 0).
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* x, long long sn,
                                       int row0, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + (warp & 3) * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
      a[kk][e] = row < n ? *reinterpret_cast<const uint32_t*>(x + row * sn + c) : 0u;
    }
}

// acc (64 x 64) = A B^T over the 256 columns, A from registers, B a 64-row
// K-major tile (a slab every four k-steps); fenced as score().
__device__ __forceinline__ void score_rs(float (&acc)[32], const uint32_t (&a)[D / 16][4],
                                         uint32_t b_addr) {
  const uint64_t db = desc_k<128>(b_addr, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs<0>(acc, a[kk], db + kstep_off<SLAB>(kk), kk > 0);
}

__global__ void __launch_bounds__(NTHP, 1)
flash_bwd_dq_wide_h_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_bias,
                           const float* __restrict__ key_bias, const bf16* __restrict__ q,
                           const bf16* __restrict__ o, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, float* __restrict__ delta,
                           bf16* __restrict__ dq, int H, int lq, int lk, int lkb, float sm_scale,
                           long long sqb, long long sqh, long long sqn, long long sob,
                           long long soh, long long son, long long sdb, long long sdh,
                           long long sdn, long long sgb, long long sgh, long long sgn) {
  using namespace dq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  float* delta_s = reinterpret_cast<float*>(smem + OFF_DELTA);
  int* nlive_s = reinterpret_cast<int*>(smem + OFF_NLIVE);
  unsigned char* tile_live = smem + OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (lk + BK - 1) / BK;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += (long long)b * lkb;
  q += b * sqb + h * sqh;
  dout += b * sdb + h * sdh;
  dq += b * sgb + h * sgh;

  // Delta = rowsum(dO o O) in fp32, 4 consumer threads a row of 64 columns
  // each
  if (threadIdx.x < NCONS) {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
    float sum = 0.f;
    if (row < lq) {
      const bf16* orow = o + b * sob + h * soh + row * son + part * 64;
      const bf16* drow = dout + row * sdn + part * 64;
#pragma unroll
      for (int c = 0; c < 64; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          sum += of.x * df.x + of.y * df.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      if (row < lq) delta[(long long)bh * lq + row] = sum;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  // the live key tiles (keys past lk are padding at -1e9)
  const int nlive = live_tiles<BK, NTHP>(key_bias, lkb, ntiles, tile_live, live_list, nlive_s);

  if (nlive == 0) {  // an empty slot: zero dQ, no loads
    zero_rows<BQ, D, NTHP>(dq, sgn, q0, lq);
    return;
  }

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nlive, bar_full, bar_empty, STAGE_TX, [&](int i, int s, uint32_t full) {
        const int key0 = live_list[i] * BK;
        load_tile(s_base + OFF_K + s * TILE, &tm_k, full, key0, h, b);
        load_tile(s_base + OFF_V + s * TILE, &tm_v, full, key0, h, b);
        tma_load_2d(s_base + OFF_BIAS + s * BK * 4, &tm_bias, full, key0, b);
      });
    return;
  }

  // ---------------- consumer warpgroups: group 0 S, P, dS; group 1 dP
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  const int wg = warp >> 2, wt = threadIdx.x & 127;
  const int r0 = (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's rows of the tile
  const float scale2 = sm_scale * LOG2E;
  float* xs = reinterpret_cast<float*>(smem + OFF_X);
  uint32_t* dss = reinterpret_cast<uint32_t*>(smem + OFF_DS);
  const float* bias_s = reinterpret_cast<const float*>(smem + OFF_BIAS);

  // Q (group 0) or dO (group 1) as A fragments, for the whole walk
  uint32_t xa[D / 16][4];
  if (wg == 0)
    load_a(xa, q, sqn, q0, lq);
  else
    load_a(xa, dout, sdn, q0, lq);
  float acc[64];  // dQ[:, 128 wg .. 128 wg + 128)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float sc[32];  // S (group 0) or dP (group 1) of the next tile
  uint32_t da[4][4];  // dS as the A operand of four k-steps of 16 keys
  const uint32_t x_tile = wg == 0 ? OFF_K : OFF_V;

  // the first tile's S or dP
  mbar_wait(bar_full, 0);
  score_rs(sc, xa, s_base + x_tile);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(sc);

  if (wg == 0) {
    float nl0 = DEAD, nl1 = DEAD;
    if (q0 + r0 < lq) {
      const float l = lse[(long long)bh * lq + q0 + r0];
      if (l > 0.5f * NEG_INF) nl0 = -l * LOG2E;
    }
    if (q0 + r1 < lq) {
      const float l = lse[(long long)bh * lq + q0 + r1];
      if (l > 0.5f * NEG_INF) nl1 = -l * LOG2E;
    }
    const float dl0 = delta_s[r0], dl1 = delta_s[r1];
    for (int i = 0; i < nlive; ++i) {
      const int s = i % NSTAGE;
      named_sync<NCONS>(BAR_DP);  // dP of tile i
      dq_ds<8>(sc, bias_s + s * BK, xs, live_list[i] * BK, lk, scale2, nl0, nl1, dl0, dl1);
      pack_frags<8>(sc, da);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) dss[(kk * 4 + e) * 128 + wt] = da[kk][e];
      named_arrive<NCONS>(BAR_DS);

      // dQ[:, 0 .. 128) += dS K[:, 0 .. 128), then the next tile's S
      const uint32_t k_addr = s_base + OFF_K + s * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, da[kk], desc_mn_wide(k_addr, kk, SLAB));
      wgmma_commit();
      if (i + 1 < nlive) {
        const int s1 = (i + 1) % NSTAGE;
        mbar_wait(bar_full + 8 * s1, ((i + 1) / NSTAGE) & 1);
        score_rs(sc, xa, s_base + OFF_K + s1 * TILE);
        wgmma_commit();
      }
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(sc);
      fence_regs(da);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
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
        score_rs(sc, xa, s_base + OFF_V + s1 * TILE);
        wgmma_commit();
      }
      named_sync<NCONS>(BAR_DS);  // dS of tile i
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[kk][e] = dss[(kk * 4 + e) * 128 + wt];
      // dQ[:, 128 .. 256) += dS K[:, 128 .. 256)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, da[kk], desc_mn_wide(s_base + OFF_K + s * TILE + 2 * SLAB, kk, SLAB));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(sc);
      fence_regs(da);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
      if (i + 1 < nlive) {  // group 0 has read dP of tile i (it sent dS)
        xchg_put(xs, wt, sc);
        named_arrive<NCONS>(BAR_DP);
      }
    }
  }

  // rows r0, r1 of the tile, columns 128 wg .. : dQ * scale in bf16
  store_acc(dq, sgn, acc, q0 + r0, lq, wg * 128, sm_scale);
}

// ---------------------------------------------------------------- dkv
namespace dkv {
constexpr int NSTAGE = 2;                              // Q / dO ring
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + TILE;
constexpr int OFF_Q = OFF_V + TILE;                    // [NSTAGE] tiles
constexpr int OFF_DO = OFF_Q + NSTAGE * TILE;          // [NSTAGE] tiles
constexpr int OFF_LSE = OFF_DO + NSTAGE * TILE;        // [NSTAGE][BQ] f32
constexpr int OFF_DELTA = OFF_LSE + NSTAGE * BQ * 4;   // [NSTAGE][BQ] f32
constexpr int OFF_P = OFF_DELTA + NSTAGE * BQ * 4;     // P^T, [32][128] f32
constexpr int OFF_BAR = OFF_P + 32 * 128 * 4;          // full[NSTAGE], empty[NSTAGE], k / v
constexpr int SMEM = 1024 + OFF_BAR + (2 * NSTAGE + 1) * 8;
constexpr int STAGE_TX = 2 * TILE + 2 * BQ * 4;
constexpr int BAR_READY = 1, BAR_FREE = 2;             // named barriers: P^T sent, P^T read
}  // namespace dkv

__global__ void __launch_bounds__(NTHP, 1)
flash_bwd_dkv_wide_h_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_lse,
                            const __grid_constant__ CUtensorMap tm_delta,
                            const float* __restrict__ key_bias, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int H, int lq, int lk, float sm_scale,
                            long long skgb, long long skgh, long long skgn, long long svgb,
                            long long svgh, long long svgn) {
  using namespace dkv;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  const uint32_t bar_kv = bar_empty + NSTAGE * 8;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  key_bias += (long long)b * lk;
  dk += b * skgb + h * skgh;
  dv += b * svgb + h * svgh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init(bar_kv, 1);
    mbar_init_fence();
  }
  // every key of the block masked: zero gradients
  if (!keys_live<BK, D, NTHP>(key_bias, key0, lk, dk, skgn, dv, svgn)) return;
  const int nq = (lq + BQ - 1) / BQ;

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * TILE);
      load_tile(s_base + OFF_K, &tm_k, bar_kv, key0, h, b);
      load_tile(s_base + OFF_V, &tm_v, bar_kv, key0, h, b);
      produce<NSTAGE>(nq, bar_full, bar_empty, STAGE_TX, [&](int i, int s, uint32_t full) {
        const int q0 = i * BQ;
        load_tile(s_base + OFF_Q + s * TILE, &tm_q, full, q0, h, b);
        load_tile(s_base + OFF_DO + s * TILE, &tm_do, full, q0, h, b);
        tma_load_2d(s_base + OFF_LSE + s * BQ * 4, &tm_lse, full, q0, bh);
        tma_load_2d(s_base + OFF_DELTA + s * BQ * 4, &tm_delta, full, q0, bh);
      });
    }
  } else {
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

    float acc[128];  // dV (group 0) or dK (group 1)
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1) of query tile i
    const uint32_t a_tile = s_base + (wg == 0 ? OFF_K : OFF_V);
    const uint32_t b_tiles = s_base + (wg == 0 ? OFF_Q : OFF_DO);
    // and the gradient product's B: dO (group 0) or Q (group 1)
    const uint32_t x_tiles = s_base + (wg == 0 ? OFF_DO : OFF_Q);
    float sc[32];  // S^T or dP^T, 64 keys x 64 queries, of the tile in hand
    mbar_wait(bar_kv, 0);
    mbar_wait(bar_full, 0);
    score(sc, a_tile, b_tiles);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    for (int i = 0; i < nq; ++i) {
      const int s = i % NSTAGE;
      const int q0 = i * BQ;

      if (wg == 0)
        dkv_send_p<8, NCONS>(sc, ps, lse_s + s * BQ, i, q0, lq, kb0, kb1, scale2, BAR_READY,
                             BAR_FREE);
      else
        dkv_recv_ds<8, NCONS>(sc, ps, delta_s + s * BQ, i + 1 < nq, BAR_READY, BAR_FREE);
      uint32_t pa[4][4];  // P^T or dS^T as the A operand of four k-steps of 16 queries
      pack_frags<8>(sc, pa);

      // dV += P^T dO (group 0) or dK += dS^T Q (group 1), MN-major over four
      // slabs; with it the next query tile's S^T or dP^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(acc, pa[kk], desc_mn_wide(x_tiles + s * TILE, kk, SLAB));
      wgmma_commit();
      if (i + 1 < nq) {
        const int s1 = (i + 1) % NSTAGE;
        mbar_wait(bar_full + 8 * s1, ((i + 1) / NSTAGE) & 1);
        score(sc, a_tile, b_tiles + s1 * TILE);
        wgmma_commit();
      }
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(sc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    // keys kr0, kr1: dV (group 0) or dK * scale (group 1) in bf16
    if (wg == 0)
      store_acc(dv, svgn, acc, kr0, lk, 0, 1.f);
    else
      store_acc(dk, skgn, acc, kr0, lk, 0, sm_scale);
  }
}

// The kernels' shared-memory limits, raised once a device (the dq
// kernel's again for a key count whose tile list needs more).
int prepare_dq(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = dq::bytes((lk + BK - 1) / BK);
  return raise_smem(flash_bwd_dq_wide_h_kernel, *smem, smem_set);
}

int prepare_dkv() {
  static int smem_set[64] = {};
  return raise_smem(flash_bwd_dkv_wide_h_kernel, dkv::SMEM, smem_set);
}

}  // namespace

// dQ and Delta. q, k, v, o, dout (B, H, N, 256) bf16 with (batch, head,
// row) element strides, each a multiple of 8 and the base 16-byte aligned;
// key_bias (B, lkb) f32 contiguous and 16-byte aligned, lkb >= Lk a
// multiple of 4, columns past Lk at -1e9; lse (B, H, Lq) f32 contiguous;
// delta (B, H, Lq) f32 written; dq by strides. Returns a CUDA error, 1000
// + the CUresult if a tensor map is refused, or 999 when
// cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_bwd_dq_wide_h(const void* q, const void* k, const void* v,
                                        const void* key_bias, const void* o, const void* dout,
                                        const void* lse, void* delta, void* dq, int B, int H,
                                        int lq, int lk, int lkb, float sm_scale, long long sqb,
                                        long long sqh, long long sqn, long long skb,
                                        long long skh, long long skn, long long svb,
                                        long long svh, long long svn, long long sob,
                                        long long soh, long long son, long long sdb,
                                        long long sdh, long long sdn, long long sgb,
                                        long long sgh, long long sgn, void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv, tb;
  CUresult r = map_heads(fn, &tk, k, D, lk, H, B, skb, skh, skn, BK);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, D, lk, H, B, svb, svh, svn, BK);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BK);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  int smem = 0;
  const int err = prepare_dq(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_wide_h_kernel<<<grid, NTHP, smem, static_cast<cudaStream_t>(stream)>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const bf16*>(q),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), H, lq,
      lk, lkb, sm_scale, sqb, sqh, sqn, sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn);
  return static_cast<int>(cudaGetLastError());
}

// dK and dV. q, k, v, dout (B, H, N, 256) bf16 with (batch, head, row)
// element strides, each a multiple of 8 and the base 16-byte aligned;
// key_bias (B, Lk) f32 contiguous; lse and delta (B * H, lqp) f32
// contiguous and 16-byte aligned, lqp >= Lq a multiple of 4; dk, dv by
// strides. Returns as flash_sdpa_bwd_dq_wide_h.
extern "C" int flash_sdpa_bwd_dkv_wide_h(const void* q, const void* k, const void* v,
                                         const void* key_bias, const void* dout, const void* lse,
                                         const void* delta, void* dk, void* dv, int B, int H,
                                         int lq, int lk, int lqp, float sm_scale, long long sqb,
                                         long long sqh, long long sqn, long long skb,
                                         long long skh, long long skn, long long svb,
                                         long long svh, long long svn, long long sdb,
                                         long long sdh, long long sdn, long long skgb,
                                         long long skgh, long long skgn, long long svgb,
                                         long long svgh, long long svgn, void* stream) {
  if (lqp % 4 != 0 || lqp < lq || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 || reinterpret_cast<uintptr_t>(delta) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tq, tdo, tk, tv, tl, td;
  CUresult r = map_heads(fn, &tq, q, D, lq, H, B, sqb, sqh, sqn, BQ);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tdo, dout, D, lq, H, B, sdb, sdh, sdn, BQ);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tk, k, D, lk, H, B, skb, skh, skn, BK);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, D, lk, H, B, svb, svh, svn, BK);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tl, lse, lqp, B * H, BQ);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &td, delta, lqp, B * H, BQ);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const int err = prepare_dkv();
  if (err != 0) return err;
  const dim3 grid((lk + BK - 1) / BK, B * H);
  flash_bwd_dkv_wide_h_kernel<<<grid, NTHP, dkv::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, tl, td, static_cast<const float*>(key_bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, lq, lk, sm_scale, skgb, skgh, skgn, svgb, svgh, svgn);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' resources (wgmma_common.cuh kernel_attrs): out = {registers,
// spilled bytes a thread, shared bytes a block, blocks an SM}; the dq
// kernel's at lk keys.
extern "C" int flash_sdpa_bwd_dq_wide_h_attrs(int lk, int* out) {
  int smem = 0;
  const int err = prepare_dq(lk, &smem);
  return err != 0 ? err : kernel_attrs(flash_bwd_dq_wide_h_kernel, NTHP, smem, out);
}

extern "C" int flash_sdpa_bwd_dkv_wide_h_attrs(int* out) {
  const int err = prepare_dkv();
  return err != 0 ? err : kernel_attrs(flash_bwd_dkv_wide_h_kernel, NTHP, dkv::SMEM, out);
}
