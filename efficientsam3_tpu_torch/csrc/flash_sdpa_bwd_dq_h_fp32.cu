// Flash attention backward, dQ and Delta, at head dims 32, 64 and 80 on fp32
// operands (the default build), for Hopper (sm_90a): split-bf16 wgmma
// products, TMA and a warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`'s
// dQ half (`_bwd_dq_kernel` :930, its pallas_call at :1082) where these run
// it in fp32:
//  - d = 32: Stage-3 training of the default build through the fusion
//    encoder's self-attention, (4, 8, 5184, 32), 6 launches a step;
//  - d = 64: a Stage-1 step of the SAM3 teacher's ViT-H trunk in fp32,
//    (B, 16, 5184, 64), 4 launches a step (1 in chip_smoke.py's 4-block cut);
//  - d = 80: the same for the vit_h SAM1 student, (1, 16, 4900, 80).
// dK and dV are flash_sdpa_bwd_h_fp32.cu's (which reads the Delta written
// here); bf16 is flash_sdpa_bwd_dq_h.cu's (the design this one starts
// from); d = 256 is flash_sdpa_bwd_wide_h_fp32.cu's (whose split pass
// feeds this kernel).
//
// What it computes is the Pallas kernel's function at fp32: P = exp(S *
// scale + key_bias - lse) in fp32, 0 on a row whose lse is masked (<= -5e8:
// every key of the batch row masked); dS = P o (dO V^T - Delta); dQ = scale
// * sum dS K, dS entering the product as fp32 (JAX's cast to the operand
// dtype is a no-op at fp32), the scale applied at the end; Delta =
// rowsum(dO o O) in fp32, written out for the dkv kernel. Key tiles whose
// keys are all masked are skipped (wgmma_common.cuh live_tiles); keys past
// Lk read as zeros (TMA) and score -1e9, queries past Lq get P = 0 and are
// not written; q, o and dO take any (B, H, N) strides with D contiguous (dO
// arrives as a view of the (B, N, H * D) gradient), k and v are read
// through their split copies; dQ is written by strides ((B, N, H, D)
// memory). Deterministic: each block owns its queries' sums, no atomics.
//
// Products. wgmma's tf32 form needs both operands K-major, and the B
// operand of dQ += dS K is MN-major; so every product is three bf16 wgmma
// on split parts (wgmma_common.cuh: hi = bf16(x), lo = bf16(x - hi); a b =
// hi hi + hi lo + lo hi, ~2^-16 of a product), as
// flash_sdpa_bwd_wide_h_fp32.cu does at d = 256.
//
// Rounding. The tensor cores' fp32 accumulation truncates, and a sum over
// the 4900-5184 keys of a row in one accumulator carries that bias (PERF.md,
// the fp32 kernels' findings). So the dQ fragment in registers sums FLUSH key tiles
// (FLUSH * 12 products) and is then added into the block's own fp32 sum in
// shared memory with round-to-nearest adds (each thread its own values);
// the epilogue scales that sum and writes it.
//
// Bound on the H100: the function's 3 products a score (S, dP, dQ) at the
// TF32 rate, 0.3336 ms at (4, 8, 5184, 32) and at (1, 16, 5184, 64), 0.3725
// ms at (1, 16, 4900, 80); three bf16 products each put this design's own
// floor at 1.5x that, beside the exponentials (~0.21 ms at 860 M). What held
// the mma.sync kernel of the former flash_sdpa_bwd.cu back (2.1716, 2.1711 and 2.5813
// ms, 6.5-6.9x the bound): split products from shared memory by mma.sync,
// K / V staged by cp.async with no pipelining, B fragments by
// ldmatrix.trans, products and exponentials in turn on four warps, and at
// d = 80 32-key sub-tiles to stay spill-free.
//
// This kernel: the bf16 dq design of flash_sdpa_bwd_dq_h.cu on split parts.
//  - block: 128 queries held by two consumer warpgroups of 64 each (warps
//    0-7) and a producer warpgroup (warps 8-11, one thread of which issues
//    TMA) at 24 registers by setmaxnreg.dec, the consumers at 240;
//  - Delta in the prologue from O and dO in device memory: each consumer
//    thread sums its two rows over the columns of its A fragments (D / 4),
//    the quad adds the rest;
//  - Q and dO: split from fp32 in device memory in the prologue, the hi
//    parts kept in registers as A fragments (D / 2 registers), the lo
//    parts written to the group's two tiles in shared memory where TMA
//    would put them (Tile::at), read by the _ss form: hi and lo both in
//    registers (D) beside dQ (D / 2), S and dP (64) and the dS parts (32)
//    would come to ~256 at d = 80;
//  - loads: the producer walks the block's live 64-key tiles (a byte a
//    tile from the key-bias row, compacted into a list) through a ring of
//    NSTAGE stages, each K hi, K lo, V hi and V lo (Tile<D, 64>: one slab
//    at the 64- or 128-byte swizzle at d = 32 and 64, five 16-column slabs
//    at the 32-byte swizzle at d = 80) from the split copies of k and v
//    (flash_sdpa_split_parts, every row) and the tile's 64 key-bias values,
//    by cp.async.bulk.tensor against full / empty mbarriers; four stages at
//    d = 32 and 64, three at d = 80;
//  - products (a warpgroup, per key tile), each three on parts:
//      S  = Q K^T   m64n64k16 x D / 16 x 3, Q hi from registers, Q lo from
//                   shared memory, K K-major;
//      dP = dO V^T  m64n64k16 x D / 16 x 3, the same with dO and V;
//      dQ += dS K   m64nDk16 x 4 x 3, dS hi / lo from registers (the
//                   accumulator layout of S is the A-operand layout), K
//                   MN-major;
//  - P = exp2(S * scale * log2(e) + key_bias * log2(e) - lse * log2(e)):
//    lse per row (registers), the key bias per column (the stage); a
//    masked or padded row's -lse * log2(e) is -1e30, so its P is 0;
//  - scheduling: the two warpgroups take turns to issue their S / dP
//    products (named barriers, as the forward's ping-pong), so one group's
//    exponentials and splits overlap the other's products.
// A block whose key row has no live key writes Delta and zeros and exits
// before any load. The grids are 41 x 32 = 1312 blocks at the Stage-3
// shape (9.9 waves of 132), 41 x 16 = 656 (5.0) at ViT-H's and 39 x 16 =
// 624 (4.7) at vit_h's, one block an SM.
//
// As built (ptxas): 168 registers a thread at launch, 240 a consumer
// thread, no spills. Measured on the H100 (80GB HBM3, 700 W;
// bench_vit_attn.py, in turns with the mma.sync kernel it replaced), split
// passes included, ms in a CUDA graph: d = 32 1.1562 / 1.1636 (2.2076 /
// 2.2027), d = 64 0.9588 / 0.9603 (2.1881 / 2.2016), d = 80 1.0419 /
// 1.0505 (2.6290 / 2.6119). Tried and not kept: Q / dO lo parts in
// registers at d = 32 (slower), FLUSH 8 (faster at d = 32, slower at
// d = 64), each tile's dQ product left running while the next tile's S
// and dP issue (faster at d = 64 and 80, slower at d = 32).

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int NWG = 2;            // consumer warpgroups, 64 queries each
constexpr int BM = 64 * NWG;      // queries a block
constexpr int BN = 64;            // keys a tile
constexpr int NCONS = 128 * NWG;
constexpr int NTH = NCONS + 128;  // and the producer warpgroup
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
constexpr int FLUSH = 4;          // key tiles a dQ fragment sums before its round-to-nearest add

// shared memory at head dim D, from a 1024-aligned base
template <int D>
struct Cfg {
  static constexpr int NSTAGE = D == 80 ? 3 : 4;  // K / V ring
  using TK = Tile<D, BN>;  // one part of a K or V tile, or of a group's Q or dO (64 rows)
  static constexpr int TILE = TK::BYTES;
  static constexpr int K_HI = 0, K_LO = TILE, V_HI = 2 * TILE, V_LO = 3 * TILE;  // in a stage
  static constexpr int STAGE = 4 * TILE;
  static constexpr int OFF_S = 0;                                   // [NSTAGE] stages
  static constexpr int OFF_X = OFF_S + NSTAGE * STAGE;              // [NWG] groups' Q lo, dO lo
  static constexpr int OFF_ACC = OFF_X + NWG * 2 * TILE;            // [NWG][D / 2][128] f32
  static constexpr int OFF_BIAS = OFF_ACC + NCONS * (D / 2) * 4;    // [NSTAGE][BN] f32
  static constexpr int OFF_BAR = OFF_BIAS + NSTAGE * BN * 4;        // full[NSTAGE], empty[NSTAGE]
  static constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte a tile, the list
  static constexpr int STAGE_TX = STAGE + BN * 4;
  static int bytes(int ntiles) {
    return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  }
};

template <int D>
__global__ void __launch_bounds__(NTH, 1)
flash_bwd_dq_h_f32_kernel(const __grid_constant__ CUtensorMap tm_k,
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
  using C = Cfg<D>;
  using TK = typename C::TK;
  constexpr int NSTAGE = C::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + C::OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  unsigned char* tile_live = smem + C::OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tr0 = (warp & 3) * 16 + g;            // this thread's rows of its group's 64
  const int r0 = q0 + wg * 64 + tr0, r1 = r0 + 8;  // and the queries they are
  const int ntiles = (lk + BN - 1) / BN;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += (long long)b * lkb;
  q += b * sqb + h * sqh;
  o += b * sob + h * soh;
  dout += b * sdb + h * sdh;
  dq += b * sgb + h * sgh;

  // Delta = rowsum(dO o O) in fp32 for rows r0, r1: this thread's D / 4
  // columns of each (those of its A fragments), the quad the rest
  float dl0 = 0.f, dl1 = 0.f;
  if (threadIdx.x < NCONS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 8 * half + 2 * t;
        if (r0 < lq) {
          const float2 dv = *reinterpret_cast<const float2*>(dout + r0 * sdn + c);
          const float2 ov = *reinterpret_cast<const float2*>(o + r0 * son + c);
          dl0 += dv.x * ov.x + dv.y * ov.y;
        }
        if (r1 < lq) {
          const float2 dv = *reinterpret_cast<const float2*>(dout + r1 * sdn + c);
          const float2 ov = *reinterpret_cast<const float2*>(o + r1 * son + c);
          dl1 += dv.x * ov.x + dv.y * ov.y;
        }
      }
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
    if (t == 0) {
      if (r0 < lq) delta[(long long)bh * lq + r0] = dl0;
      if (r1 < lq) delta[(long long)bh * lq + r1] = dl1;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  // the live key tiles (keys past lk are padding at -1e9); its barriers
  // publish the mbarriers
  const int nlive = live_tiles<BN, NTH>(key_bias, lkb, ntiles, tile_live, live_list,
                                        reinterpret_cast<int*>(smem + C::OFF_NLIVE));
  if (nlive == 0) {  // every key of the batch row masked: zero dQ, no loads
    zero_rows<BM, D, NTH>(dq, sgn, q0, lq);
    return;
  }

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nlive, bar_full, bar_empty, C::STAGE_TX, [&](int i, int s, uint32_t full) {
        const int key0 = live_list[i] * BN;
        const uint32_t st = s_base + C::OFF_S + s * C::STAGE;
        TK::load(st + C::K_HI, &tm_k, full, key0, h, b);  // the split copies: hi at b, lo at b + B
        TK::load(st + C::K_LO, &tm_k, full, key0, h, b + B);
        TK::load(st + C::V_HI, &tm_v, full, key0, h, b);
        TK::load(st + C::V_LO, &tm_v, full, key0, h, b + B);
        tma_load_2d(s_base + C::OFF_BIAS + s * BN * 4, &tm_bias, full, key0, b);
      });
    return;
  }

  // ---------------- consumer warpgroups, 64 queries each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  const int wt = threadIdx.x & 127;
  const float scale2 = sm_scale * LOG2E;
  float nl0 = DEAD, nl1 = DEAD;  // -lse * log2(e) of rows r0, r1
  if (r0 < lq) {
    const float l = lse[(long long)bh * lq + r0];
    if (l > 0.5f * NEG_INF) nl0 = -l * LOG2E;
  }
  if (r1 < lq) {
    const float l = lse[(long long)bh * lq + r1];
    if (l > 0.5f * NEG_INF) nl1 = -l * LOG2E;
  }
  // Q and dO rows r0, r1 split: hi as the A operand of D / 16 k-steps of 16
  // columns ({row g, cols 2t..}, {g + 8, 2t..}, {g, 2t + 8..}, {g + 8, 2t +
  // 8..}), lo at the same places of the group's Q lo and dO lo tiles
  uint32_t qa[D / 16][4], da[D / 16][4];
  unsigned char* x_s = smem + C::OFF_X + wg * 2 * C::TILE;
  const uint32_t xq = s_base + C::OFF_X + wg * 2 * C::TILE, xd = xq + C::TILE;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
      float2 qv = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
      if (row < lq) {
        qv = *reinterpret_cast<const float2*>(q + row * sqn + c);
        dv = *reinterpret_cast<const float2*>(dout + row * sdn + c);
      }
      const uint32_t at = TK::at(tr0 + 8 * (e & 1), c);
      uint32_t lo;
      split_pair(qv.x, qv.y, qa[kk][e], lo);
      *reinterpret_cast<uint32_t*>(x_s + at) = lo;
      split_pair(dv.x, dv.y, da[kk][e], lo);
      *reinterpret_cast<uint32_t*>(x_s + C::TILE + at) = lo;
    }
  // this thread's fp32 sums of dQ (value e at acc_s[e * 128 + wt]) from zero
  float* acc_s = reinterpret_cast<float*>(smem + C::OFF_ACC) + wg * (D / 2) * 128;
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_s[e * 128 + wt] = 0.f;
  fence_proxy_async();
  named_sync<128>(3 + wg);  // the group's lo tiles written before its wgmma reads them

  float frag[D / 2];  // dQ of rows r0, r1 over the tiles since the last add
  const float* bias_s = reinterpret_cast<const float*>(smem + C::OFF_BIAS);

  if (wg == NWG - 1) named_arrive<NCONS>(1);  // group 0 issues first
  for (int i = 0; i < nlive; ++i) {
    const int s = i % NSTAGE;
    const int key0 = live_list[i] * BN;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t st = s_base + C::OFF_S + s * C::STAGE;

    // S = Q K^T and dP = dO V^T, three products on parts each, this
    // group's turn on the tensor cores
    float sc[32], dp[32];
    named_sync<NCONS>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t khd = TK::desc_k(st + C::K_HI, kk);
      wgmma_rs<0>(sc, qa[kk], khd, kk > 0);
      wgmma_rs<0>(sc, qa[kk], TK::desc_k(st + C::K_LO, kk));
      wgmma_m64n64k16_ss(sc, TK::desc_k(xq, kk), khd, 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t vhd = TK::desc_k(st + C::V_HI, kk);
      wgmma_rs<0>(dp, da[kk], vhd, kk > 0);
      wgmma_rs<0>(dp, da[kk], TK::desc_k(st + C::V_LO, kk));
      wgmma_m64n64k16_ss(dp, TK::desc_k(xd, kk), vhd, 1);
    }
    wgmma_commit();
    if (wg < NWG - 1 || i + 1 < nlive) named_arrive<NCONS>(1 + (wg + 1) % NWG);
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P o (dP - Delta) in fp32, split into hi / lo A operands of four
    // k-steps of 16 keys; keys past lk (zero-filled by TMA) masked
    const float* bs = bias_s + s * BN;
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;  // this thread's keys c, c + 1 of the tile
      const float2 bv = *reinterpret_cast<const float2*>(bs + c);
      const float b0 = key0 + c < lk ? bv.x * LOG2E : NEG_INF * LOG2E;
      const float b1 = key0 + c + 1 < lk ? bv.y * LOG2E : NEG_INF * LOG2E;
      const float p00 = ex2(fmaf(sc[4 * j + 0], scale2, b0) + nl0);  // row r0, key c
      const float p01 = ex2(fmaf(sc[4 * j + 1], scale2, b1) + nl0);
      const float p10 = ex2(fmaf(sc[4 * j + 2], scale2, b0) + nl1);  // row r1
      const float p11 = ex2(fmaf(sc[4 * j + 3], scale2, b1) + nl1);
      const int a = j >> 1, e = (j & 1) * 2;
      split_pair(p00 * (dp[4 * j + 0] - dl0), p01 * (dp[4 * j + 1] - dl0), sh[a][e], sl[a][e]);
      split_pair(p10 * (dp[4 * j + 2] - dl1), p11 * (dp[4 * j + 3] - dl1), sh[a][e + 1],
                 sl[a][e + 1]);
    }

    // frag (+)= dS K on parts, K MN-major (N = D); a fresh fragment every
    // FLUSH tiles
    const bool fresh = i % FLUSH == 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t khd = TK::desc_mn(st + C::K_HI, kk);
      wgmma_rs(frag, sh[kk], khd, !(fresh && kk == 0));
      wgmma_rs(frag, sh[kk], TK::desc_mn(st + C::K_LO, kk));
      wgmma_rs(frag, sl[kk], khd);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(frag);
    fence_regs(sh);
    fence_regs(sl);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    if ((i + 1) % FLUSH == 0 || i + 1 == nlive) {   // into the sums, round to nearest
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc_s[e * 128 + wt] += frag[e];
    }
  }

  // rows r0, r1: dQ * scale
#pragma unroll
  for (int e = 0; e < D / 2; ++e) frag[e] = acc_s[e * 128 + wt];
  store_acc(dq, sgn, frag, r0, lq, 0, sm_scale);
}

// The kernel's shared-memory limit at head dim D for lk keys (its tile
// list grows with them), raised once a device and size.
template <int D>
int prepare(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = Cfg<D>::bytes((lk + BN - 1) / BN);
  return raise_smem(flash_bwd_dq_h_f32_kernel<D>, *smem, smem_set);
}

template <int D>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb,
           const void* key_bias, const void* q, const void* o, const void* dout, const void* lse,
           void* delta, void* dq, int B, int H, int lq, int lk, int lkb, float sm_scale,
           long long sqb, long long sqh, long long sqn, long long sob, long long soh,
           long long son, long long sdb, long long sdh, long long sdn, long long sgb,
           long long sgh, long long sgn, cudaStream_t st) {
  int smem = 0;
  const int err = prepare<D>(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + BM - 1) / BM, B * H);
  flash_bwd_dq_h_f32_kernel<D><<<grid, NTH, smem, st>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const float*>(q),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq), B, H,
      lq, lk, lkb, sm_scale, sqb, sqh, sqn, sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dQ and Delta at head dim d = 32, 64 or 80. q, o, dout (B, H, Lq, d) f32
// with (batch, head, row) element strides, each a multiple of 4 and the
// base 16-byte aligned; kp, vp the split copies of k and v
// (flash_sdpa_split_parts at d, every row); key_bias (B, lkb) f32
// contiguous and 16-byte aligned, lkb >= Lk a multiple of 4, columns past
// Lk at -1e9; lse (B, H, Lq) f32 contiguous; delta (B, H, Lq) f32 written;
// dq f32 by strides. Returns a CUDA error, 1000 + the CUresult if a tensor
// map is refused, or 999 when cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_bwd_dq_h_f32(const void* q, const void* kp, const void* vp,
                                       const void* key_bias, const void* o, const void* dout,
                                       const void* lse, void* delta, void* dq, int B, int H,
                                       int lq, int lk, int lkb, int d, float sm_scale,
                                       long long sqb, long long sqh, long long sqn,
                                       long long sob, long long soh, long long son,
                                       long long sdb, long long sdh, long long sdn,
                                       long long sgb, long long sgh, long long sgn,
                                       void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<32>) run = nullptr;
  if (d == 32) run = launch<32>;
  if (d == 64) run = launch<64>;
  if (d == 80) run = launch<80>;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv, tb;
  CUresult r = map_parts(fn, &tk, kp, d, lk, H, B, BN);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, vp, d, lk, H, B, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return run(tk, tv, tb, key_bias, q, o, dout, lse, delta, dq, B, H, lq, lk, lkb, sm_scale, sqb,
             sqh, sqn, sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn,
             static_cast<cudaStream_t>(stream));
}

// The kernel's resources at head dim d and lk keys (wgmma_common.cuh
// kernel_attrs): out = {registers, spilled bytes a thread, shared bytes a
// block, blocks an SM}.
extern "C" int flash_sdpa_bwd_dq_h_f32_attrs(int d, int lk, int* out) {
  int smem = 0, err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 32 && (err = prepare<32>(lk, &smem)) == 0)
    return kernel_attrs(flash_bwd_dq_h_f32_kernel<32>, NTH, smem, out);
  if (d == 64 && (err = prepare<64>(lk, &smem)) == 0)
    return kernel_attrs(flash_bwd_dq_h_f32_kernel<64>, NTH, smem, out);
  if (d == 80 && (err = prepare<80>(lk, &smem)) == 0)
    return kernel_attrs(flash_bwd_dq_h_f32_kernel<80>, NTH, smem, out);
  return err;
}
