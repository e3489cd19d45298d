// Flash attention backward, dK and dV, at head dims 32, 64 and 80 on fp32
// operands (the default build), for Hopper (sm_90a): split-bf16 wgmma
// products, TMA and a warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`'s
// dK / dV half (`_bwd_dkv_kernel` :970, its pallas_call at :1098) where
// these run it in fp32:
//  - d = 32: Stage-3 training of the default build through the fusion
//    encoder's self-attention, (4, 8, 5184, 32), 6 launches a step;
//  - d = 64: a Stage-1 step of the SAM3 teacher's ViT-H trunk in fp32,
//    (B, 16, 5184, 64), 4 launches a step (1 in chip_smoke.py's 4-block cut);
//  - d = 80: the same for the vit_h SAM1 student, (1, 16, 4900, 80).
// dQ and Delta = rowsum(dO o O) come from flash_sdpa_bwd_dq_h_fp32.cu; bf16
// is flash_sdpa_bwd_h.cu's (the design this one starts from), and d = 256
// flash_sdpa_bwd_wide_h_fp32.cu's (whose split pass feeds this kernel too).
//
// What it computes is the Pallas kernel's function at fp32: P = exp(S *
// scale + key_bias - lse) in fp32, 0 on columns whose lse is masked (<=
// -5e8: every key of the batch row masked); dV = sum P^T dO; dS = P o (dO
// V^T - Delta); dK = scale * sum dS^T Q; P and dS enter the gradient
// products as fp32 (JAX's casts to the operand dtype are no-ops at fp32).
// A block whose keys are all masked writes zeros and returns; keys past Lk
// score -1e9 and are not written; queries past Lq read as zeros and
// contribute nothing. k and v take any (B, H, N) strides with D contiguous;
// q and dO are read through their split copies (any strides there); dK and
// dV are written by strides ((B, N, H, D) memory). Deterministic: each
// block owns its keys' sums, no atomics.
//
// Products. wgmma's tf32 form needs both operands K-major, and the B
// operands of dV += P^T dO and dK += dS^T Q are MN-major; so every product
// is three bf16 wgmma on split parts (wgmma_common.cuh: hi = bf16(x), lo =
// bf16(x - hi); a b = hi hi + hi lo + lo hi, ~2^-16 of a product), as
// flash_sdpa_bwd_wide_h_fp32.cu does at d = 256. The sums over Lq (4900 or
// 5184 queries) go straight into the fp32 accumulators, as that kernel's
// dK / dV do within the 1e-4 tolerance.
//
// Bound on the H100: the function's 4 products a score (S, dP, dV, dK) at
// the TF32 rate, 0.4447 ms at (4, 8, 5184, 32) and at (1, 16, 5184, 64),
// 0.4967 ms at (1, 16, 4900, 80); three bf16 products each put this
// design's own floor at 1.5x that, beside the exponentials (~0.21 ms at
// 860 M). What held the mma.sync kernels of the former flash_sdpa_bwd.cu back (3.4833,
// 2.8517 and 4.1935 ms, 6.4-8.4x the bound): split products from shared
// memory by mma.sync, query tiles staged by cp.async with no pipelining
// (16 queries at a time at d = 80, for registers), B fragments by
// ldmatrix.trans, products and exponentials in turn on four warps.
//
// This kernel: the bf16 dkv design of flash_sdpa_bwd_h.cu on split parts.
//  - block: 128 keys held by two consumer warpgroups of 64 keys each
//    (warps 0-7) and a producer warpgroup (warps 8-11, one thread of which
//    issues TMA) at 24 registers by setmaxnreg.dec, the consumers at 240;
//  - K and V: split from fp32 in device memory in the prologue. At d = 32
//    a consumer thread keeps both parts in registers as A fragments (32
//    registers) beside dK and dV (32), S^T and dP^T (64) and the hi / lo
//    fragments of P^T and dS^T (64), ~190 before addressing. At d = 64
//    and 80 that layout needs 256 and 288, so the parts go to shared
//    memory instead (Tile<D, 64> a group and part, written where TMA would
//    put them: Tile::at), and the score products read both operands from
//    there (the _ss form): ~192 and ~208 registers before addressing;
//  - loads: the producer keeps a ring of NSTAGE stages, each a 64-query
//    tile of Q hi, Q lo, dO hi and dO lo (Tile<D, 64>: one slab at the
//    64- or 128-byte swizzle at d = 32 and 64, five 16-column slabs at the
//    32-byte swizzle at d = 80) from the split copies of q and dO
//    (flash_sdpa_split_parts, every row) and the tile's lse and Delta, by
//    cp.async.bulk.tensor against full / empty mbarriers; four stages at
//    d = 32 and 64, three at d = 80 (40 KB a stage beside 80 KB of K and
//    V parts);
//  - products (a warpgroup, per query tile), each three on parts:
//      S^T  = K Q^T    m64n64k16 x D / 16 x 3, Q K-major;
//      dP^T = V dO^T   m64n64k16 x D / 16 x 3, dO K-major;
//      dV  += P^T dO   m64nDk16 x 4 x 3, P^T from registers (split), dO
//                      MN-major;
//      dK  += dS^T Q   m64nDk16 x 4 x 3, dS^T from registers, Q MN-major;
//  - P^T = exp2(S^T * scale * log2(e) + key_bias * log2(e) - lse *
//    log2(e)), the key bias per row (registers), lse per column (the
//    stage); a masked or padded column's -lse * log2(e) is -1e30, so P = 0;
//  - scheduling: the two warpgroups take turns to issue their S^T / dP^T
//    products (named barriers, as the forward's ping-pong), so one group's
//    exponentials and splits overlap the other's products.
// The grids are 41 x 32 = 1312 blocks at the Stage-3 shape (9.9 waves of
// 132), 41 x 16 = 656 (5.0) at ViT-H's and 39 x 16 = 624 (4.7) at vit_h's,
// one block an SM.
//
// As built at d = 32 (ptxas): 168 registers a thread at launch, 240 a
// consumer thread, no spills, 68,672 bytes of shared memory a block.
// Measured on the H100 (80GB HBM3, 700 W; bench_vit_attn.py, in turns with
// the mma.sync kernel it replaced), split passes included: 1.4435 / 1.4315
// ms in a CUDA graph (the mma.sync kernel 3.4717 / 3.5084), 3.2x the TF32
// bound and 2.2x this design's floor. Tried and not kept at d = 32:
// leaving the gradient products running while the next tile's score
// products are issued (the stage freed a tile later), 1.4686 / 1.4645 ms.
// At d = 64 and 80: no spills, 199,744 and 207,408 bytes of shared memory
// a block; 1.0566 / 1.0208 ms and 1.2656 / 1.2331 ms in a CUDA graph, split
// passes included (the mma.sync kernel 2.8670 / 2.8729 and 4.2550 /
// 4.2685; bench_vit_attn.py, as above).

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int NWG = 2;            // consumer warpgroups, 64 keys each
constexpr int BN = 64 * NWG;      // keys a block
constexpr int BQ = 64;            // queries a stage
constexpr int NCONS = 128 * NWG;
constexpr int NTH = NCONS + 128;  // and the producer warpgroup
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");

// the block at head dim D; shared memory from a 1024-aligned base
template <int D>
struct Cfg {
  static constexpr bool KV_REGS = D == 32;  // K and V parts in registers, else shared memory
  static constexpr int NSTAGE = D == 80 ? 3 : 4;  // Q / dO ring
  using TQ = Tile<D, BQ>;  // one part of a 64-row tile: Q or dO (streamed), K or V (resident)
  static constexpr int TILE = TQ::BYTES;
  static constexpr int Q_HI = 0, Q_LO = TILE, DO_HI = 2 * TILE, DO_LO = 3 * TILE;  // in a stage
  static constexpr int K_HI = 0, K_LO = TILE, V_HI = 2 * TILE, V_LO = 3 * TILE;  // in a group's
  static constexpr int STAGE = 4 * TILE;
  static constexpr int OFF_KV = 0;                                  // [NWG] groups' K and V parts
  static constexpr int OFF_S = OFF_KV + (KV_REGS ? 0 : NWG * 4 * TILE);  // [NSTAGE] stages
  static constexpr int OFF_LSE = OFF_S + NSTAGE * STAGE;            // [NSTAGE][BQ] f32
  static constexpr int OFF_DELTA = OFF_LSE + NSTAGE * BQ * 4;       // [NSTAGE][BQ] f32
  static constexpr int OFF_BAR = OFF_DELTA + NSTAGE * BQ * 4;       // full[NSTAGE], empty[NSTAGE]
  static constexpr int SMEM = 1024 + OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int STAGE_TX = STAGE + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NTH, 1)
flash_bwd_dkv_h_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_lse,
                           const __grid_constant__ CUtensorMap tm_delta,
                           const float* __restrict__ key_bias, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ dk,
                           float* __restrict__ dv, int B, int H, int lq, int lk, float sm_scale,
                           long long skb, long long skh, long long skn, long long svb,
                           long long svh, long long svn, long long skgb, long long skgh,
                           long long skgn, long long svgb, long long svgh, long long svgn) {
  using C = Cfg<D>;
  using TQ = typename C::TQ;
  constexpr int NSTAGE = C::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const float* lse_s = reinterpret_cast<const float*>(smem + C::OFF_LSE);
  const float* delta_s = reinterpret_cast<const float*>(smem + C::OFF_DELTA);
  const uint32_t bar_full = s_base + C::OFF_BAR, bar_empty = bar_full + NSTAGE * 8;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  key_bias += (long long)b * lk;
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
  if (!keys_live<BN, D, NTH>(key_bias, key0, lk, dk, skgn, dv, svgn)) return;
  const int nq = (lq + BQ - 1) / BQ;

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nq, bar_full, bar_empty, C::STAGE_TX, [&](int i, int s, uint32_t full) {
        const int q0 = i * BQ;
        const uint32_t st = s_base + C::OFF_S + s * C::STAGE;
        TQ::load(st + C::Q_HI, &tm_q, full, q0, h, b);  // the split copies: hi at b, lo at b + B
        TQ::load(st + C::Q_LO, &tm_q, full, q0, h, b + B);
        TQ::load(st + C::DO_HI, &tm_do, full, q0, h, b);
        TQ::load(st + C::DO_LO, &tm_do, full, q0, h, b + B);
        tma_load_2d(s_base + C::OFF_LSE + s * BQ * 4, &tm_lse, full, q0, bh);
        tma_load_2d(s_base + C::OFF_DELTA + s * BQ * 4, &tm_delta, full, q0, bh);
      });
    return;
  }

  // ---------------- consumer warpgroups, 64 keys each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int tr0 = (warp & 3) * 16 + g;             // this thread's rows of its group's 64 keys
  const int kr0 = key0 + wg * 64 + tr0, kr1 = kr0 + 8;  // and the keys they are
  const float scale2 = sm_scale * LOG2E;
  const float kb0 = kr0 < lk ? key_bias[kr0] * LOG2E : NEG_INF * LOG2E;
  const float kb1 = kr1 < lk ? key_bias[kr1] * LOG2E : NEG_INF * LOG2E;
  // K and V rows kr0, kr1 split into hi and lo at the A fragments' places
  // of D / 16 k-steps of 16 columns: {row g, cols 2t..}, {g + 8, 2t..}, {g,
  // 2t + 8..}, {g + 8, 2t + 8..}; kept in registers (d = 32) or written to
  // this group's tiles (d = 64, 80)
  constexpr int NKR = C::KV_REGS ? D / 16 : 1;
  uint32_t kh[NKR][4], kl[NKR][4], vh[NKR][4], vl[NKR][4];
  unsigned char* kv_s = smem + C::OFF_KV + wg * 4 * C::TILE;
  const uint32_t kv_a = s_base + C::OFF_KV + wg * 4 * C::TILE;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? kr1 : kr0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
      float2 kv = make_float2(0.f, 0.f), vv = make_float2(0.f, 0.f);
      if (row < lk) {
        kv = *reinterpret_cast<const float2*>(k + row * skn + c);
        vv = *reinterpret_cast<const float2*>(v + row * svn + c);
      }
      uint32_t khi, klo, vhi, vlo;
      split_pair(kv.x, kv.y, khi, klo);
      split_pair(vv.x, vv.y, vhi, vlo);
      if constexpr (C::KV_REGS) {
        kh[kk][e] = khi;
        kl[kk][e] = klo;
        vh[kk][e] = vhi;
        vl[kk][e] = vlo;
      } else {
        const uint32_t at = TQ::at(tr0 + 8 * (e & 1), c);
        *reinterpret_cast<uint32_t*>(kv_s + C::K_HI + at) = khi;
        *reinterpret_cast<uint32_t*>(kv_s + C::K_LO + at) = klo;
        *reinterpret_cast<uint32_t*>(kv_s + C::V_HI + at) = vhi;
        *reinterpret_cast<uint32_t*>(kv_s + C::V_LO + at) = vlo;
      }
    }
  if constexpr (!C::KV_REGS) {  // the group's tiles written before its wgmma reads them
    fence_proxy_async();
    named_sync<128>(3 + wg);
  }

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (wg == NWG - 1) named_arrive<NCONS>(1);  // group 0 issues first
  for (int i = 0; i < nq; ++i) {
    const int s = i % NSTAGE;
    const int q0 = i * BQ;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t st = s_base + C::OFF_S + s * C::STAGE;

    // S^T = K Q^T and dP^T = V dO^T, three products on parts each, this
    // group's turn on the tensor cores
    float sc[32], dp[32];
    named_sync<NCONS>(1 + wg);
    wgmma_fence();
    if constexpr (C::KV_REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_rs<0>(sc, kh[kk], TQ::desc_k(st + C::Q_HI, kk), kk > 0);
        wgmma_rs<0>(sc, kh[kk], TQ::desc_k(st + C::Q_LO, kk));
        wgmma_rs<0>(sc, kl[kk], TQ::desc_k(st + C::Q_HI, kk));
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_rs<0>(dp, vh[kk], TQ::desc_k(st + C::DO_HI, kk), kk > 0);
        wgmma_rs<0>(dp, vh[kk], TQ::desc_k(st + C::DO_LO, kk));
        wgmma_rs<0>(dp, vl[kk], TQ::desc_k(st + C::DO_HI, kk));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t khd = TQ::desc_k(kv_a + C::K_HI, kk), qhd = TQ::desc_k(st + C::Q_HI, kk);
        wgmma_m64n64k16_ss(sc, khd, qhd, kk > 0);
        wgmma_m64n64k16_ss(sc, khd, TQ::desc_k(st + C::Q_LO, kk), 1);
        wgmma_m64n64k16_ss(sc, TQ::desc_k(kv_a + C::K_LO, kk), qhd, 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t vhd = TQ::desc_k(kv_a + C::V_HI, kk), dhd = TQ::desc_k(st + C::DO_HI, kk);
        wgmma_m64n64k16_ss(dp, vhd, dhd, kk > 0);
        wgmma_m64n64k16_ss(dp, vhd, TQ::desc_k(st + C::DO_LO, kk), 1);
        wgmma_m64n64k16_ss(dp, TQ::desc_k(kv_a + C::V_LO, kk), dhd, 1);
      }
    }
    wgmma_commit();
    if (wg < NWG - 1 || i + 1 < nq) named_arrive<NCONS>(1 + (wg + 1) % NWG);
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T in fp32, split into hi / lo A operands of four k-steps
    // of 16 queries
    const float* ls = lse_s + s * BQ;
    const float* ds = delta_s + s * BQ;
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;  // this thread's queries c, c + 1 of the tile
      const float2 lv = *reinterpret_cast<const float2*>(ls + c);
      const float2 dlv = *reinterpret_cast<const float2*>(ds + c);
      const float nl0 = q0 + c < lq && lv.x > 0.5f * NEG_INF ? -lv.x * LOG2E : DEAD;
      const float nl1 = q0 + c + 1 < lq && lv.y > 0.5f * NEG_INF ? -lv.y * LOG2E : DEAD;
      const float p00 = ex2(fmaf(sc[4 * j + 0], scale2, kb0) + nl0);  // key kr0, query c
      const float p01 = ex2(fmaf(sc[4 * j + 1], scale2, kb0) + nl1);
      const float p10 = ex2(fmaf(sc[4 * j + 2], scale2, kb1) + nl0);  // key kr1
      const float p11 = ex2(fmaf(sc[4 * j + 3], scale2, kb1) + nl1);
      const int a = j >> 1, e = (j & 1) * 2;
      split_pair(p00, p01, ph[a][e], pl[a][e]);
      split_pair(p10, p11, ph[a][e + 1], pl[a][e + 1]);
      split_pair(p00 * (dp[4 * j + 0] - dlv.x), p01 * (dp[4 * j + 1] - dlv.y), dh[a][e], dl[a][e]);
      split_pair(p10 * (dp[4 * j + 2] - dlv.x), p11 * (dp[4 * j + 3] - dlv.y), dh[a][e + 1],
                 dl[a][e + 1]);
    }

    // dV += P^T dO and dK += dS^T Q on parts, dO and Q MN-major (N = D)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs(dva, ph[kk], TQ::desc_mn(st + C::DO_HI, kk));
      wgmma_rs(dva, ph[kk], TQ::desc_mn(st + C::DO_LO, kk));
      wgmma_rs(dva, pl[kk], TQ::desc_mn(st + C::DO_HI, kk));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs(dka, dh[kk], TQ::desc_mn(st + C::Q_HI, kk));
      wgmma_rs(dka, dh[kk], TQ::desc_mn(st + C::Q_LO, kk));
      wgmma_rs(dka, dl[kk], TQ::desc_mn(st + C::Q_HI, kk));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
  }

  // keys kr0, kr1: dV and dK * scale
  store_acc(dv, svgn, dva, kr0, lk, 0, 1.f);
  store_acc(dk, skgn, dka, kr0, lk, 0, sm_scale);
}

template <int D>
int prepare() {
  static int smem_set[64] = {};
  return raise_smem(flash_bwd_dkv_h_f32_kernel<D>, Cfg<D>::SMEM, smem_set);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tl,
           const CUtensorMap& td, const void* key_bias, const void* k, const void* v, void* dk,
           void* dv, int B, int H, int lq, int lk, float sm_scale, long long skb, long long skh,
           long long skn, long long svb, long long svh, long long svn, long long skgb,
           long long skgh, long long skgn, long long svgb, long long svgh, long long svgn,
           cudaStream_t st) {
  const int err = prepare<D>();
  if (err != 0) return err;
  const dim3 grid((lk + BN - 1) / BN, B * H);
  flash_bwd_dkv_h_f32_kernel<D><<<grid, NTH, Cfg<D>::SMEM, st>>>(
      tq, tdo, tl, td, static_cast<const float*>(key_bias), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(dk), static_cast<float*>(dv), B, H, lq,
      lk, sm_scale, skb, skh, skn, svb, svh, svn, skgb, skgh, skgn, svgb, svgh, svgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dK and dV at head dim d = 32, 64 or 80. qp, dop the split copies of q
// and dout (flash_sdpa_split_parts at d, every row); k, v (B, H, Lk, d) f32
// with (batch, head, row) element strides, each a multiple of 4 and the
// base 16-byte aligned; key_bias (B, Lk) f32 contiguous; lse and delta (B *
// H, lqp) f32 contiguous and 16-byte aligned, lqp >= Lq a multiple of 4;
// dk, dv f32 by strides. Returns a CUDA error, 1000 + the CUresult if a
// tensor map is refused, or 999 when cuTensorMapEncodeTiled cannot be
// found.
extern "C" int flash_sdpa_bwd_dkv_h_f32(const void* qp, const void* dop, const void* k,
                                        const void* v, const void* key_bias, const void* lse,
                                        const void* delta, void* dk, void* dv, int B, int H,
                                        int lq, int lk, int lqp, int d, float sm_scale,
                                        long long skb, long long skh, long long skn,
                                        long long svb, long long svh, long long svn,
                                        long long skgb, long long skgh, long long skgn,
                                        long long svgb, long long svgh, long long svgn,
                                        void* stream) {
  if (lqp % 4 != 0 || lqp < lq || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 || reinterpret_cast<uintptr_t>(delta) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<32>) run = nullptr;
  if (d == 32) run = launch<32>;
  if (d == 64) run = launch<64>;
  if (d == 80) run = launch<80>;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tq, tdo, tl, td;
  CUresult r = map_parts(fn, &tq, qp, d, lq, H, B, BQ);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tdo, dop, d, lq, H, B, BQ);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tl, lse, lqp, B * H, BQ);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &td, delta, lqp, B * H, BQ);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return run(tq, tdo, tl, td, key_bias, k, v, dk, dv, B, H, lq, lk, sm_scale, skb, skh, skn, svb,
             svh, svn, skgb, skgh, skgn, svgb, svgh, svgn, static_cast<cudaStream_t>(stream));
}

// The kernel's resources at head dim d (wgmma_common.cuh kernel_attrs):
// out = {registers, spilled bytes a thread, shared bytes a block, blocks
// an SM}.
extern "C" int flash_sdpa_bwd_dkv_h_f32_attrs(int d, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 32 && (err = prepare<32>()) == 0)
    return kernel_attrs(flash_bwd_dkv_h_f32_kernel<32>, NTH, Cfg<32>::SMEM, out);
  if (d == 64 && (err = prepare<64>()) == 0)
    return kernel_attrs(flash_bwd_dkv_h_f32_kernel<64>, NTH, Cfg<64>::SMEM, out);
  if (d == 80 && (err = prepare<80>()) == 0)
    return kernel_attrs(flash_bwd_dkv_h_f32_kernel<80>, NTH, Cfg<80>::SMEM, out);
  return err;
}
