// Flash scaled-dot-product attention forward at head dims 32, 64, 80 and
// 256 on fp32 operands (the default build), for Hopper (sm_90a):
// split-bf16 wgmma products, TMA and a warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py
// `_flash_fwd_packed` (`_packed_kernel` :182, its pallas_call at :304) at
// d = 32 and `_flash_fwd` (`_kernel` :57, its pallas_call at :144) at d = 64,
// 80 and 256 where the default build runs them in fp32:
//  - d = 32: the fusion encoder's self-attention, (1, 8, 5184, 32) a
//    `ground` and (4, 8, 5184, 32) a Stage-3 step, 6 launches each;
//  - d = 64: the SAM3 teacher's ViTDet global blocks, (1, 16, 5184, 64), 4
//    launches a `set_image`;
//  - d = 80: the vit_h SAM1 student's, (1, 16, 4900, 80), 4 launches a
//    `set_image`;
//  - d = 256 (one head): the tracker's memory attention, self-attention
//    q/k/v (8, 1, 5184, 256) with 3 of 8 object slots live, 4 launches an
//    fp32 tracked frame, and a training clip's plain cross-attention over
//    k/v (8, 1, 36352, 256) (the d = 256 backward reads its LSE); its own
//    kernel, below the others (see "d = 256").
// bf16 is flash_sdpa_h.cu's (the design this one starts from).
//
// What it computes is flash_sdpa_h.cu's function at fp32: softmax(Q K^T *
// scale + key_bias) V with an fp32 online softmax, P kept fp32 for the P V
// product (JAX casts P to the value dtype, a no-op at fp32), a (B, Lk) fp32
// additive key bias (-1e9 masks), key tiles whose keys are all masked
// skipped, the natural-log LSE (the backward reads it), 0 and lse -1e9 for
// a row whose keys are all masked, ragged Lq and Lk masked in the kernel,
// any (B, H, N) strides on q, the output in (B, N, H, D) memory.
//
// Products. wgmma's tf32 form needs both operands K-major, and V in P V is
// not; so every product is three bf16 wgmma on split parts
// (wgmma_common.cuh: hi = bf16(x), lo = bf16(x - hi); a b = hi hi + hi lo +
// lo hi, ~2^-16 of a product), as the fp32 backward kernels do.
//
// Bound on the H100: the function's two products a score at the TF32 rate,
// 0.0556 ms at (1, 8, 5184, 32), 0.2224 at (1, 16, 5184, 64) and 0.2483 at
// (1, 16, 4900, 80); three bf16 products each put this design's own floor
// at 1.5x that, beside the exponentials (~0.05 ms at 215 M, d = 32). What
// held the mma.sync register kernel of flash_sdpa.cu back (0.6848, 2.5726
// and 2.8842 ms, 11.6-12.3x the bound): split products by mma.sync, which
// reaches a third of the tensor peak from shared memory, K and V staged by
// synchronous loads with no pipelining and V transposed by 2-byte stores,
// products and exponentials in turn on four warps.
//
// This kernel: flash_sdpa_h.cu's design on split parts.
//  - block: consumer warpgroups of 64 queries each and a producer
//    warpgroup (one thread of which issues TMA) at 24 registers by
//    setmaxnreg.dec. A consumer holds O (D / 2), a fresh P V fragment
//    (D / 2), S (32), the P parts (32) and Q hi (D / 4), ~164 registers at
//    d = 80 before addresses: two consumer groups at 240 at d = 64 and 80
//    (128 queries a block), three at 160 at d = 32 (192 queries; what holds
//    d = 32 is each score's exponential and splits, not its short
//    products, and a third group overlaps them: 0.2780 / 0.9628 ms against
//    0.3192 / 1.0668 with two at the `ground` / Stage-3 shapes,
//    bench_vit_attn.py, H100 80GB HBM3, 700 W);
//  - Q: split from fp32 in device memory in the prologue, the hi part kept
//    in registers as A fragments, the lo part written to the group's tile
//    in shared memory where TMA would put it (Tile::at), read by the _ss
//    form;
//  - loads: the producer walks the block's live 64-key tiles (a byte a
//    tile from the key-bias row, compacted into a list) through a ring of
//    NSTAGE stages, each K hi, K lo, V hi and V lo (Tile<D, 64>: one slab
//    at the 64- or 128-byte swizzle at d = 32 and 64, five 16-column slabs
//    at the 32-byte swizzle at d = 80) from the split copies of k and v
//    (flash_sdpa_split_parts, every row) and the tile's 64 key-bias values,
//    by cp.async.bulk.tensor against full / empty mbarriers; four stages at
//    d = 32 and 64, three at d = 80 (a stage of four 64 x 80 parts is 40
//    KB);
//  - products (a warpgroup, per key tile), each three on parts:
//      S  = Q K^T  m64n64k16 x D / 16 x 3, Q hi from registers, Q lo from
//                  shared memory, K K-major;
//      F  = P V    m64nDk16 x 4 x 3, P hi / lo from registers (the
//                  accumulator layout of S is the A-operand layout), V
//                  MN-major;
//  - rounding: the tensor cores' fp32 accumulation truncates, and an O
//    summed over the 4900-5184 keys of a row in one accumulator would carry
//    that bias (PERF.md, the fp32 kernels' findings). So each tile's P V
//    starts a fresh fragment F (12 products), and O = O * corr + F by one
//    round-to-nearest FMA an element: the instruction the bf16 kernel
//    spends on O *= corr;
//  - softmax: exp2 with scale * log2(e) and the bias folded into one FMA,
//    the denominator summed in fp32 from the unsplit P;
//  - scheduling: the warpgroups take turns, in a ring, to issue their
//    Q K^T (named barriers, FA3's ping-pong), so one group's exponentials
//    and splits overlap the others' products.
// A block whose key row has no live key writes zeros (lse -1e9) and exits
// before any load. The grids, one block an SM: 27 x 8 = 216 blocks at the
// `ground` shape (1.6 waves of 132), 27 x 32 = 864 (6.5) at the Stage-3
// step's, 41 x 16 = 656 (5.0) at ViT-H's and 39 x 16 = 624 (4.7) at
// vit_h's.
//
// d = 256 (the mma.sync kernel of the former flash_qsmem.cuh before it: 2.2385 ms at
// the self shape against a bound of 0.1668, and at the clip's 36352 keys
// 1.43e-4 of O's largest magnitude off its plain version: it summed O in
// the tensor cores). The design above does not fit at D = 256:
//  - registers: a consumer would hold O (128), the fresh fragment (128),
//    S (32), the P parts (32) and Q hi (64), more than 255;
//  - shared memory: a 64-key stage of K hi / lo and V hi / lo is 128 KB.
// Chosen: the 256 output columns split between the block's two consumer
// warpgroups, which share the block's 64 queries (candidate (a) in one
// block). Each group holds 128 columns of O (64 registers) and a 64
// register fragment; the stages hold 32 keys (64 KB, two of them); both
// groups need all of S, and each computes half of its 16 k-steps (Q hi's
// half in 32 registers, Q lo's in shared memory), hands its fp32 partial
// sums to the other through shared memory (xchg_put, double-buffered by
// tile) and adds the other's: a + b = b + a in fp32, so both hold the
// same S and compute the same P, maxima and sums. P V from the fresh
// fragment into O by round-to-nearest FMAs, as above. 198,448 bytes a
// block at 5184 keys, 168 registers at launch and 240 a consumer, no
// spills; 81 x 3 = 243 live blocks at the self shape, 1.84 waves.
// Measured (bench_vit_attn.py --tracker, NVIDIA H100 80GB HBM3, 700 W, in
// turns, two split passes included): 0.6287 / 0.6193 ms at the self shape
// and 4.2614 / 4.2930 at the clip's (bound 1.1683), against 0.7470 /
// 0.7434 and 5.1456 / 5.1269 for the same block with each group computing
// all of S with Q hi and lo from shared memory (every S product _ss: ~190
// bytes of shared memory a tensor-core cycle against the SM's 128).
// Tried and not kept: each tile's P V issued on the tensor cores just
// before the next tile's S, waited for while S runs (FA3's
// intra-warpgroup overlap): 0.8128 / 0.8061 ms against 0.6244 / 0.6223,
// ptxas serialising the wgmma (C7518). Not tried: candidate (b) (one
// group computes S and P for two P V groups).

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int BN = 64;            // keys a tile
constexpr int PROD_REGS = 24;     // a producer thread's registers (setmaxnreg.dec)

// The block at head dim D: NWG consumer warpgroups of 64 queries each (3 at
// d = 32, whose registers allow 160 a consumer thread; 2 at d = 64 and 80,
// at 240) and a producer warpgroup; shared memory from a 1024-aligned base.
template <int D>
struct Cfg {
  static constexpr int NWG = D == 32 ? 3 : 2;
  static constexpr int BM = 64 * NWG;        // queries a block
  static constexpr int NCONS = 128 * NWG;
  static constexpr int NTH = NCONS + 128;    // and the producer warpgroup
  static constexpr int CONS_REGS = NWG == 2 ? 240 : 160;
  static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
  static constexpr int NSTAGE = D == 80 ? 3 : 4;  // K / V ring
  using TK = Tile<D, BN>;  // one part of a K or V tile, or a group's Q lo (64 rows)
  static constexpr int TILE = TK::BYTES;
  static constexpr int K_HI = 0, K_LO = TILE, V_HI = 2 * TILE, V_LO = 3 * TILE;  // in a stage
  static constexpr int STAGE = 4 * TILE;
  static constexpr int OFF_S = 0;                                  // [NSTAGE] stages
  static constexpr int OFF_QLO = OFF_S + NSTAGE * STAGE;           // [NWG] groups' Q lo
  static constexpr int OFF_BIAS = OFF_QLO + NWG * TILE;            // [NSTAGE][BN] f32
  static constexpr int OFF_BAR = OFF_BIAS + NSTAGE * BN * 4;       // full[NSTAGE], empty[NSTAGE]
  static constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte a tile, the list
  static constexpr int STAGE_TX = STAGE + BN * 4;
  static int bytes(int ntiles) {
    return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  }
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTH, 1)
flash_sdpa_h_f32_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_bias,
                        const float* __restrict__ key_bias, const float* __restrict__ q,
                        float* __restrict__ o, float* __restrict__ lse, int B, int H, int lq,
                        int lk, int lkb, float sm_scale, long long sqb, long long sqh,
                        long long sqn, long long sob, long long soh, long long son) {
  using C = Cfg<D>;
  using TK = typename C::TK;
  constexpr int NSTAGE = C::NSTAGE, NWG = C::NWG, BM = C::BM, NCONS = C::NCONS, NTH = C::NTH;
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
  if (lse != nullptr) lse += (long long)bh * lq;

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
  if (nlive == 0) {  // every key of the batch row masked: zeros, no loads
    dead_rows<BM, D, NTH>(o, son, lse, q0, lq);
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONS_REGS) : "memory");
  // Q rows r0, r1 split: hi as the A operand of D / 16 k-steps of 16
  // columns ({row g, cols 2t..}, {g + 8, 2t..}, {g, 2t + 8..}, {g + 8, 2t +
  // 8..}), lo at the same places of the group's Q lo tile
  uint32_t qa[D / 16][4];
  unsigned char* ql_s = smem + C::OFF_QLO + wg * C::TILE;
  const uint32_t ql = s_base + C::OFF_QLO + wg * C::TILE;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
      float2 qv = make_float2(0.f, 0.f);
      if (row < lq) qv = *reinterpret_cast<const float2*>(q + row * sqn + c);
      uint32_t lo;
      split_pair(qv.x, qv.y, qa[kk][e], lo);
      *reinterpret_cast<uint32_t*>(ql_s + TK::at(tr0 + 8 * (e & 1), c)) = lo;
    }
  fence_proxy_async();
  named_sync<128>(1 + NWG + wg);  // the group's Q lo tile written before its wgmma reads it

  const float scale2 = sm_scale * LOG2E;
  const float* bias_s = reinterpret_cast<const float*>(smem + C::OFF_BIAS);
  float acc[D / 2], frag[D / 2];  // O of rows r0, r1; this tile's P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E, l0 = 0.f, l1 = 0.f;

  // the groups take turns to issue Q K^T, in order: group g waits at
  // barrier 1 + g for the previous group's arrival (256 threads: the two)
  if (wg == NWG - 1) named_arrive<256>(1);  // group 0 issues first
  for (int i = 0; i < nlive; ++i) {
    const int s = i % NSTAGE;
    const int key0 = live_list[i] * BN;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t st = s_base + C::OFF_S + s * C::STAGE;

    // S = Q K^T on parts, this group's turn on the tensor cores
    float sc[32];
    named_sync<256>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t khd = TK::desc_k(st + C::K_HI, kk);
      wgmma_rs<0>(sc, qa[kk], khd, kk > 0);
      wgmma_rs<0>(sc, qa[kk], TK::desc_k(st + C::K_LO, kk));
      wgmma_m64n64k16_ss(sc, TK::desc_k(ql, kk), khd, 1);
    }
    wgmma_commit();
    if (wg < NWG - 1 || i + 1 < nlive) named_arrive<256>(1 + (wg + 1) % NWG);
    wgmma_wait0();
    fence_regs(sc);

    // the online softmax (keys past lk, zero-filled by TMA, masked); P hi /
    // lo as the A operand of four k-steps of 16 keys
    float corr0, corr1;
    uint32_t ph[4][4], pl[4][4];
    softmax_split<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1,
                          ph, pl);

    // F = P V on parts, from a fresh fragment; V MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t vhd = TK::desc_mn(st + C::V_HI, kk);
      wgmma_rs(frag, ph[kk], vhd, kk > 0);
      wgmma_rs(frag, ph[kk], TK::desc_mn(st + C::V_LO, kk));
      wgmma_rs(frag, pl[kk], vhd);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(frag);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    // O = O * corr + F, rounded to nearest
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n + 0] = fmaf(acc[4 * n + 0], corr0, frag[4 * n + 0]);
      acc[4 * n + 1] = fmaf(acc[4 * n + 1], corr0, frag[4 * n + 1]);
      acc[4 * n + 2] = fmaf(acc[4 * n + 2], corr1, frag[4 * n + 2]);
      acc[4 * n + 3] = fmaf(acc[4 * n + 3], corr1, frag[4 * n + 3]);
    }
  }

  finish_rows(o, son, lse, acc, r0, lq, 0, m0, m1, l0, l1);
}

// The kernel's shared-memory limit at head dim D for lk keys (its tile
// list grows with them), raised once a device and size.
template <int D>
int prepare(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = Cfg<D>::bytes((lk + BN - 1) / BN);
  return raise_smem(flash_sdpa_h_f32_kernel<D>, *smem, smem_set);
}

template <int D>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb,
           const void* key_bias, const void* q, void* o, void* lse, int B, int H, int lq, int lk,
           int lkb, float sm_scale, long long sqb, long long sqh, long long sqn, long long sob,
           long long soh, long long son, cudaStream_t st) {
  int smem = 0;
  const int err = prepare<D>(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + Cfg<D>::BM - 1) / Cfg<D>::BM, B * H);
  flash_sdpa_h_f32_kernel<D><<<grid, Cfg<D>::NTH, smem, st>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const float*>(q),
      static_cast<float*>(o), static_cast<float*>(lse), B, H, lq, lk, lkb, sm_scale, sqb, sqh,
      sqn, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- d = 256
// The d = 256 design (see the header): a block owns 64 queries; consumer
// warpgroup c computes S's k-steps 8 c .. 8 c + 7 for them, with its half
// of Q hi in registers and of Q lo in shared memory, takes the other
// group's partial sums, and computes the output columns 128 c .. 128 c +
// 127; 32-key stages of K hi, K lo, V hi and V lo.
namespace wide {
constexpr int D = 256, BM = 64, BN = 32, NSTAGE = 2;
constexpr int NCONS = 256, NTH = NCONS + 128, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
using TQ = Tile<D, BM>;  // Q lo
using TS = Tile<D, BN>;  // one part of a K or V tile
constexpr int K_HI = 0, K_LO = TS::BYTES, V_HI = 2 * TS::BYTES, V_LO = 3 * TS::BYTES;
constexpr int STAGE = 4 * TS::BYTES;                      // 64 KB
constexpr int XCHG = 16 * 128 * 4;                        // a group's partial S (xchg_put)
constexpr int Q_LO = 0;
constexpr int OFF_X = Q_LO + TQ::BYTES;                   // [2 tiles][2 groups] partial S
constexpr int OFF_S = OFF_X + 4 * XCHG;                   // [NSTAGE] stages
constexpr int OFF_BIAS = OFF_S + NSTAGE * STAGE;          // [NSTAGE][BN] f32
constexpr int OFF_BAR = OFF_BIAS + NSTAGE * BN * 4;       // full[NSTAGE], empty[NSTAGE]
constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte a tile, the list
constexpr int STAGE_TX = STAGE + BN * 4;
int bytes(int ntiles) {
  return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
}
}  // namespace wide

__global__ void __launch_bounds__(wide::NTH, 1)
flash_sdpa_h_f32_wide_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_bias,
                             const float* __restrict__ key_bias, const float* __restrict__ q,
                             float* __restrict__ o, float* __restrict__ lse, int B, int H,
                             int lq, int lk, int lkb, float sm_scale, long long sqb,
                             long long sqh, long long sqn, long long sob, long long soh,
                             long long son) {
  using wide::TQ;
  using wide::TS;
  constexpr int D = wide::D, BM = wide::BM, BN = wide::BN, NSTAGE = wide::NSTAGE;
  constexpr int NCONS = wide::NCONS, NTH = wide::NTH, STAGE = wide::STAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + wide::OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  unsigned char* tile_live = smem + wide::OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int r0 = q0 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
  const int ntiles = (lk + BN - 1) / BN;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += (long long)b * lkb;
  q += b * sqb + h * sqh;
  o += b * sob + h * soh;
  if (lse != nullptr) lse += (long long)bh * lq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  const int nlive = live_tiles<BN, NTH>(key_bias, lkb, ntiles, tile_live, live_list,
                                        reinterpret_cast<int*>(smem + wide::OFF_NLIVE));
  if (nlive == 0) {  // every key of the batch row masked: zeros, no loads
    dead_rows<BM, D, NTH>(o, son, lse, q0, lq);
    return;
  }

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nlive, bar_full, bar_empty, wide::STAGE_TX,
                      [&](int i, int s, uint32_t full) {
        const int key0 = live_list[i] * BN;
        const uint32_t st = s_base + wide::OFF_S + s * STAGE;
        // the split copies: hi at batch b, lo at b + B
        TS::load(st + wide::K_HI, &tm_k, full, key0, h, b);
        TS::load(st + wide::K_LO, &tm_k, full, key0, h, b + B);
        TS::load(st + wide::V_HI, &tm_v, full, key0, h, b);
        TS::load(st + wide::V_LO, &tm_v, full, key0, h, b + B);
        tma_load_2d(s_base + wide::OFF_BIAS + s * BN * 4, &tm_bias, full, key0, b);
      });
    return;
  }

  // ---------------- two consumer warpgroups on the same 64 queries
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wide::CONS_REGS) : "memory");
  // this group's half of Q (columns 128 wg ..) split: the hi part of rows
  // r0, r0 + 8 as the A operand of its 8 k-steps, the lo part where TMA
  // would put it in the Q lo tile
  const int tr0 = r0 - q0, wt = threadIdx.x & 127;
  uint32_t qa[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), c = 128 * wg + 16 * j + 8 * (e >> 1) + 2 * (lane & 3);
      float2 qv = make_float2(0.f, 0.f);
      if (row < lq) qv = *reinterpret_cast<const float2*>(q + row * sqn + c);
      uint32_t lo;
      split_pair(qv.x, qv.y, qa[j][e], lo);
      *reinterpret_cast<uint32_t*>(smem + wide::Q_LO + TQ::at(tr0 + 8 * (e & 1), c)) = lo;
    }
  fence_proxy_async();
  named_sync<128>(2 + wg);  // the group's half of Q lo written before its wgmma reads it

  const float scale2 = sm_scale * LOG2E;
  const float* bias_s = reinterpret_cast<const float*>(smem + wide::OFF_BIAS);
  const uint32_t qlo = s_base + wide::Q_LO;
  float acc[64], frag[64];  // this group's 128 columns of O; this tile's P V
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < nlive; ++i) {
    const int s = i % NSTAGE;
    const int key0 = live_list[i] * BN;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t st = s_base + wide::OFF_S + s * STAGE;

    // this group's half of S = Q K^T on parts: Q hi from registers, Q lo
    // from shared memory, K K-major
    float sc[16];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = 8 * wg + j;
      const uint64_t khd = TS::desc_k(st + wide::K_HI, kk);
      wgmma_rs<0>(sc, qa[j], khd, j > 0);
      wgmma_rs<0>(sc, qa[j], TS::desc_k(st + wide::K_LO, kk));
      wgmma_m64n32k16_ss(sc, TQ::desc_k(qlo, kk), khd, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    // S = own + other's half (fp32 addition commutes: both groups hold the
    // same S, so the same P, maxima and sums); the buffers alternate by
    // tile, and a group reads the other's before the next tile's barrier
    float* xb = reinterpret_cast<float*>(smem + wide::OFF_X) + (i & 1) * 2 * (wide::XCHG / 4);
    xchg_put(xb + wg * (wide::XCHG / 4), wt, sc);
    named_sync<NCONS>(1);
    {
      float other[16];
      xchg_get(other, xb + (1 - wg) * (wide::XCHG / 4), wt);
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] += other[e];
    }

    float corr0, corr1;
    uint32_t ph[BN / 16][4], pl[BN / 16][4];
    softmax_split<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1,
                          ph, pl);

    // F = P V[:, 128 wg ..) on parts from a fresh fragment (V MN-major, N =
    // 128 over two slabs), then O = O * corr + F rounded to nearest
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t vhd = TS::desc_mn(st + wide::V_HI + 2 * wg * TS::SLAB, kk);
      wgmma_rs(frag, ph[kk], vhd, kk > 0);
      wgmma_rs(frag, ph[kk], TS::desc_mn(st + wide::V_LO + 2 * wg * TS::SLAB, kk));
      wgmma_rs(frag, pl[kk], vhd);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(frag);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[4 * n + 0] = fmaf(acc[4 * n + 0], corr0, frag[4 * n + 0]);
      acc[4 * n + 1] = fmaf(acc[4 * n + 1], corr0, frag[4 * n + 1]);
      acc[4 * n + 2] = fmaf(acc[4 * n + 2], corr1, frag[4 * n + 2]);
      acc[4 * n + 3] = fmaf(acc[4 * n + 3], corr1, frag[4 * n + 3]);
    }
  }
  // both groups hold the same row sums; group 0 writes the LSE
  finish_rows(o, son, wg == 0 ? lse : nullptr, acc, r0, lq, 128 * wg, m0, m1, l0, l1);
}

int prepare_wide(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = wide::bytes((lk + wide::BN - 1) / wide::BN);
  return raise_smem(flash_sdpa_h_f32_wide_kernel, *smem, smem_set);
}

int launch_wide(const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb,
                const void* key_bias, const void* q, void* o, void* lse, int B, int H, int lq,
                int lk, int lkb, float sm_scale, long long sqb, long long sqh, long long sqn,
                long long sob, long long soh, long long son, cudaStream_t st) {
  int smem = 0;
  const int err = prepare_wide(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + wide::BM - 1) / wide::BM, B * H);
  flash_sdpa_h_f32_wide_kernel<<<grid, wide::NTH, smem, st>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const float*>(q),
      static_cast<float*>(o), static_cast<float*>(lse), B, H, lq, lk, lkb, sm_scale, sqb, sqh,
      sqn, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Lq, d) f32, d = 32, 64, 80 or 256, with (batch, head, row)
// element strides, each a multiple of 4 and the base 16-byte aligned; kp,
// vp the split copies of k and v (flash_sdpa_split_parts at d: every row,
// at d = 256 the rows of the live 32-key tiles, the key tile there: (2 B,
// H, Lk, d) bf16); key_bias (B, lkb) f32 contiguous and 16-byte aligned,
// lkb >= Lk a multiple of 4, columns past Lk at -1e9; o f32 by strides; lse
// (B, H, Lq) f32 or null. Returns a CUDA error, 1000 + the CUresult if a
// tensor map is refused, or 999 when cuTensorMapEncodeTiled cannot be
// found.
extern "C" int flash_sdpa_h_f32_fwd(const void* q, const void* kp, const void* vp,
                                    const void* key_bias, void* o, void* lse, int B, int H,
                                    int lq, int lk, int lkb, int d, float sm_scale,
                                    long long sqb, long long sqh, long long sqn, long long sob,
                                    long long soh, long long son, void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<32>) run = nullptr;
  if (d == 32) run = launch<32>;
  if (d == 64) run = launch<64>;
  if (d == 80) run = launch<80>;
  if (d == 256) run = launch_wide;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  const int rows = d == 256 ? wide::BN : BN;  // a key tile
  CUtensorMap tk, tv, tb;
  CUresult r = map_parts(fn, &tk, kp, d, lk, H, B, rows);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, vp, d, lk, H, B, rows);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, rows);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return run(tk, tv, tb, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb, sqh, sqn, sob,
             soh, son, static_cast<cudaStream_t>(stream));
}

// The kernels' resources at head dim d and lk keys (wgmma_common.cuh
// kernel_attrs): out = {registers, spilled bytes a thread, shared bytes a
// block, blocks an SM}.
extern "C" int flash_sdpa_h_f32_attrs(int d, int lk, int* out) {
  int smem = 0, err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 32 && (err = prepare<32>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_f32_kernel<32>, Cfg<32>::NTH, smem, out);
  if (d == 64 && (err = prepare<64>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_f32_kernel<64>, Cfg<64>::NTH, smem, out);
  if (d == 80 && (err = prepare<80>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_f32_kernel<80>, Cfg<80>::NTH, smem, out);
  if (d == 256 && (err = prepare_wide(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_f32_wide_kernel, wide::NTH, smem, out);
  return err;
}
