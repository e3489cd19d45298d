// Flash attention backward, dK and dV, at head dim 32 on fp32 operands (the
// default build), for Hopper (sm_90a): split-bf16 wgmma products, TMA and a
// warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`'s
// dK / dV half (`_bwd_dkv_kernel` :970, its pallas_call at :1098) where
// Stage-3 training of the default build (fp32 compute) runs it through the
// fusion encoder's self-attention, (4, 8, 5184, 32), 6 launches a step.
// dQ and Delta = rowsum(dO o O) come from the fp32 dq kernel of
// flash_sdpa_bwd.cu; bf16 at d = 32 is flash_sdpa_bwd_h.cu's (the design
// this one starts from), fp32 at d = 64 and 80 stays on flash_sdpa_bwd.cu,
// and d = 256 is flash_sdpa_bwd_wide_h_fp32.cu's (whose split pass feeds
// this kernel too).
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
// flash_sdpa_bwd_wide_h_fp32.cu does at d = 256. The sums over Lq (5184
// queries) go straight into the fp32 accumulators, as that kernel's dK / dV
// do within the 1e-4 tolerance.
//
// Bound on the H100 at (4, 8, 5184, 32): the function's 4 products a score
// (S, dP, dV, dK), 55 GFLOP, at the TF32 rate 0.4447 ms; three bf16
// products each put this design's own floor at 1.5x that (0.33 ms of
// products at the bf16 rate, 0.67 ms over the three), beside 860 M
// exponentials (~0.21 ms). What held the mma.sync kernel of
// flash_sdpa_bwd.cu back (3.4833 ms, 7.8x the bound): split products from
// shared memory by mma.sync, 64-query tiles staged in two parts by cp.async
// with no pipelining, B fragments by ldmatrix.trans, products and
// exponentials in turn on four warps.
//
// This kernel: the bf16 d = 32 dkv design of flash_sdpa_bwd_h.cu on split parts.
//  - block: 128 keys held by two consumer warpgroups of 64 keys each
//    (warps 0-7) and a producer warpgroup (warps 8-11, one thread of which
//    issues TMA) at 24 registers by setmaxnreg.dec, the consumers at 240: a
//    consumer thread holds K and V as hi and lo A fragments (32 registers),
//    dK and dV (32), S^T and dP^T (64) and the hi / lo fragments of P^T and
//    dS^T (64), ~190 before addressing, past the 168 of one block of 288
//    threads;
//  - K and V: split from fp32 in device memory in the prologue, both parts
//    kept in registers for the whole walk;
//  - loads: the producer keeps a ring of NSTAGE stages, each a 64-query
//    tile of Q hi, Q lo, dO hi and dO lo (Tile<32, 64>: one slab at the
//    64-byte swizzle, 4 KB a part) from the split copies of q and dO
//    (flash_sdpa_split_parts, every row) and the tile's lse and Delta, by
//    cp.async.bulk.tensor against full / empty mbarriers;
//  - products (a warpgroup, per query tile), each three on parts:
//      S^T  = K Q^T    m64n64k16 x 2 x 3, K from registers, Q K-major;
//      dP^T = V dO^T   m64n64k16 x 2 x 3, V from registers, dO K-major;
//      dV  += P^T dO   m64n32k16 x 4 x 3, P^T from registers (split), dO
//                      MN-major;
//      dK  += dS^T Q   m64n32k16 x 4 x 3, dS^T from registers, Q MN-major;
//  - P^T = exp2(S^T * scale * log2(e) + key_bias * log2(e) - lse *
//    log2(e)), the key bias per row (registers), lse per column (the
//    stage); a masked or padded column's -lse * log2(e) is -1e30, so P = 0;
//  - scheduling: the two warpgroups take turns to issue their S^T / dP^T
//    products (named barriers, as the forward's ping-pong), so one group's
//    exponentials and splits overlap the other's products.
// The grid is 41 x 32 = 1312 blocks at the Stage-3 shape, one block an SM
// (9.9 waves).
//
// As built (ptxas): 168 registers a thread at launch, 240 a consumer
// thread, no spills, 68,672 bytes of shared memory a block. Measured on
// the H100 (80GB HBM3, 700 W; bench_vit_attn.py, in turns with the
// mma.sync kernel it replaces), split passes included: 1.4435 / 1.4315 ms
// in a CUDA graph (the mma.sync kernel 3.4717 / 3.5084), 3.2x the TF32
// bound and 2.2x this design's floor. Tried and not kept: leaving the
// gradient products running while the next tile's score products are
// issued (the stage freed a tile later), 1.4686 / 1.4645 ms.

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int D = 32;
constexpr int NWG = 2;            // consumer warpgroups, 64 keys each
constexpr int BN = 64 * NWG;      // keys a block
constexpr int BQ = 64;            // queries a stage
constexpr int NSTAGE = 4;         // Q / dO ring
constexpr int NCONS = 128 * NWG;
constexpr int NTH = NCONS + 128;  // and the producer warpgroup
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
using TQ = Tile<D, BQ>;           // one part of a Q or dO tile
constexpr int TILE = TQ::BYTES;
constexpr int Q_HI = 0, Q_LO = TILE, DO_HI = 2 * TILE, DO_LO = 3 * TILE;  // within a stage
constexpr int STAGE = 4 * TILE;
// shared memory, from a 1024-aligned base
constexpr int OFF_S = 0;                               // [NSTAGE] stages
constexpr int OFF_LSE = OFF_S + NSTAGE * STAGE;        // [NSTAGE][BQ] f32
constexpr int OFF_DELTA = OFF_LSE + NSTAGE * BQ * 4;   // [NSTAGE][BQ] f32
constexpr int OFF_BAR = OFF_DELTA + NSTAGE * BQ * 4;   // full[NSTAGE], empty[NSTAGE]
constexpr int SMEM = 1024 + OFF_BAR + 2 * NSTAGE * 8;
constexpr int STAGE_TX = STAGE + 2 * BQ * 4;

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
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const float* lse_s = reinterpret_cast<const float*>(smem + OFF_LSE);
  const float* delta_s = reinterpret_cast<const float*>(smem + OFF_DELTA);
  const uint32_t bar_full = s_base + OFF_BAR, bar_empty = bar_full + NSTAGE * 8;

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
      produce<NSTAGE>(nq, bar_full, bar_empty, STAGE_TX, [&](int i, int s, uint32_t full) {
        const int q0 = i * BQ;
        const uint32_t st = s_base + OFF_S + s * STAGE;
        TQ::load(st + Q_HI, &tm_q, full, q0, h, b);  // the split copies: hi at b, lo at b + B
        TQ::load(st + Q_LO, &tm_q, full, q0, h, b + B);
        TQ::load(st + DO_HI, &tm_do, full, q0, h, b);
        TQ::load(st + DO_LO, &tm_do, full, q0, h, b + B);
        tma_load_2d(s_base + OFF_LSE + s * BQ * 4, &tm_lse, full, q0, bh);
        tma_load_2d(s_base + OFF_DELTA + s * BQ * 4, &tm_delta, full, q0, bh);
      });
    return;
  }

  // ---------------- consumer warpgroups, 64 keys each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = key0 + wg * 64 + (warp & 3) * 16 + g, kr1 = kr0 + 8;  // this thread's keys
  const float scale2 = sm_scale * LOG2E;
  const float kb0 = kr0 < lk ? key_bias[kr0] * LOG2E : NEG_INF * LOG2E;
  const float kb1 = kr1 < lk ? key_bias[kr1] * LOG2E : NEG_INF * LOG2E;
  // K and V rows kr0, kr1 split into hi and lo A fragments of two k-steps
  // of 16 columns: {row g, cols 2t..}, {g + 8, 2t..}, {g, 2t + 8..}, {g + 8, 2t + 8..}
  uint32_t kh[D / 16][4], kl[D / 16][4], vh[D / 16][4], vl[D / 16][4];
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
      split_pair(kv.x, kv.y, kh[kk][e], kl[kk][e]);
      split_pair(vv.x, vv.y, vh[kk][e], vl[kk][e]);
    }

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (wg == NWG - 1) named_arrive<NCONS>(1);  // group 0 issues first
  for (int i = 0; i < nq; ++i) {
    const int s = i % NSTAGE;
    const int q0 = i * BQ;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t st = s_base + OFF_S + s * STAGE;

    // S^T = K Q^T and dP^T = V dO^T, three products on parts each, this
    // group's turn on the tensor cores
    float sc[32], dp[32];
    named_sync<NCONS>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_rs<0>(sc, kh[kk], TQ::desc_k(st + Q_HI, kk), kk > 0);
      wgmma_rs<0>(sc, kh[kk], TQ::desc_k(st + Q_LO, kk));
      wgmma_rs<0>(sc, kl[kk], TQ::desc_k(st + Q_HI, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_rs<0>(dp, vh[kk], TQ::desc_k(st + DO_HI, kk), kk > 0);
      wgmma_rs<0>(dp, vh[kk], TQ::desc_k(st + DO_LO, kk));
      wgmma_rs<0>(dp, vl[kk], TQ::desc_k(st + DO_HI, kk));
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

    // dV += P^T dO and dK += dS^T Q on parts, dO and Q MN-major (N = 32)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs(dva, ph[kk], TQ::desc_mn(st + DO_HI, kk));
      wgmma_rs(dva, ph[kk], TQ::desc_mn(st + DO_LO, kk));
      wgmma_rs(dva, pl[kk], TQ::desc_mn(st + DO_HI, kk));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs(dka, dh[kk], TQ::desc_mn(st + Q_HI, kk));
      wgmma_rs(dka, dh[kk], TQ::desc_mn(st + Q_LO, kk));
      wgmma_rs(dka, dl[kk], TQ::desc_mn(st + Q_HI, kk));
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

int prepare() {
  static int smem_set[64] = {};
  return raise_smem(flash_bwd_dkv_h_f32_kernel, SMEM, smem_set);
}

// A (2 B, H, n, 32) bf16 split copy (hi, then lo), contiguous, as a map of
// 64-row boxes.
CUresult map_parts(EncodeTiled fn, CUtensorMap* m, const void* parts, int n, int H, int B) {
  const long long sn = D, sh = static_cast<long long>(n) * D, sb = H * sh;
  return map_heads(fn, m, parts, D, n, H, 2 * B, sb, sh, sn, BQ);
}

}  // namespace

// dK and dV. qp, dop the split copies of q and dout (flash_sdpa_split_parts
// at d = 32, every row); k, v (B, H, Lk, 32) f32 with (batch, head, row)
// element strides, each a multiple of 4 and the base 16-byte aligned;
// key_bias (B, Lk) f32 contiguous; lse and delta (B * H, lqp) f32
// contiguous and 16-byte aligned, lqp >= Lq a multiple of 4; dk, dv f32 by
// strides. Returns a CUDA error, 1000 + the CUresult if a tensor map is
// refused, or 999 when cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_bwd_dkv_h_f32(const void* qp, const void* dop, const void* k,
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
  CUresult r = map_parts(fn, &tq, qp, lq, H, B);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tdo, dop, lq, H, B);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tl, lse, lqp, B * H, BQ);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &td, delta, lqp, B * H, BQ);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const int err = prepare();
  if (err != 0) return err;
  const dim3 grid((lk + BN - 1) / BN, B * H);
  flash_bwd_dkv_h_f32_kernel<<<grid, NTH, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tl, td, static_cast<const float*>(key_bias), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(dk), static_cast<float*>(dv), B, H, lq,
      lk, sm_scale, skb, skh, skn, svb, svh, svn, skgb, skgh, skgn, svgb, svgh, svgn);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources (wgmma_common.cuh kernel_attrs): out = {registers,
// spilled bytes a thread, shared bytes a block, blocks an SM}.
extern "C" int flash_sdpa_bwd_dkv_h_f32_attrs(int* out) {
  const int err = prepare();
  return err != 0 ? err : kernel_attrs(flash_bwd_dkv_h_f32_kernel, NTH, SMEM, out);
}
