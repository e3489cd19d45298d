// Flash attention backward, dQ and Delta, at head dims 32, 64 and 80, bf16,
// for Hopper (sm_90a): wgmma, TMA and a warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`'s
// dQ half (`_bwd_dq_kernel` :930, its pallas_call at :1082) where bf16
// training runs it:
//  - d = 32: Stage-3 training through the fusion encoder's self-attention,
//    (4, 8, 5184, 32), 6 launches a step;
//  - d = 64: Stage 1 of the SAM3 teacher's ViT-H at 1008^2 through its
//    global blocks, (2, 16, 5184, 64), 4 launches a step;
//  - d = 80: Stage 1 of the vit_h SAM1 student at 1120^2, (1, 16, 4900,
//    80), 4 launches a step.
// dK and dV are flash_sdpa_bwd_h.cu's (which reads the Delta written
// here); fp32 is flash_sdpa_bwd_dq_h_fp32.cu's; d = 256 is
// flash_sdpa_bwd_wide_h.cu's (bf16) and flash_sdpa_bwd_wide_h_fp32.cu's.
//
// What it computes is the Pallas kernel's: P rebuilt from the forward's
// saved natural-log LSE, P = exp(S * scale + key_bias - lse) in fp32, 0 on
// a row whose lse is masked (<= -5e8: every key of the batch row masked);
// dS = P o (dO V^T - Delta) rounded to bf16; dQ = scale * sum bf16(dS) K
// with fp32 accumulation, the scale applied at the end; Delta =
// rowsum(dO o O) in fp32, written out for the dkv kernel. Key tiles whose
// keys are all masked are skipped (wgmma_common.cuh live_tiles); keys past
// Lk read as zeros (TMA) and score -1e9, queries past Lq get P = 0 and are
// not written; q, k, v, o and dO take any (B, H, N) strides with D
// contiguous (dO arrives as a view of the (B, N, H * D) gradient); dQ is
// written by strides ((B, N, H, D) memory). Deterministic: each block owns
// its queries' sums, no atomics.
//
// Bound on the H100: 3 products a score (S, dP, dQ), at the teacher's
// shape 2 x 16 x 5184^2 x 64 x 6 = 330 GFLOP (0.334 ms at the bf16 peak)
// beside 860 M exponentials (~0.21 ms on the special-function units): the
// products bound it; at vit_h's 184 GFLOP (0.186 ms). At d = 32 the
// products are short (4 x 8 x 5184^2 x 32 x 6 = 165 GFLOP, 0.167 ms) and
// the same 860 M exponentials bound it (0.2056 ms). What held the mma.sync
// dq kernel of the former flash_sdpa_bwd.cu back (2.1374 ms at d = 64,
// 1.1381 at d = 80, 6.4x and 6.1x; 1.0595 ms at d = 32, 5.2x): products
// from shared memory by mma.sync (a third of the peak), K / V staged by
// cp.async with no pipelining, dQ's B fragments by ldmatrix.trans, products
// and exponentials in turn on four warps.
//
// This kernel (one template over D, the mirror of flash_sdpa_bwd_h.cu with
// queries and keys swapped):
//  - block: 128 queries held by two consumer warpgroups of 64 each (warps
//    0-7) and a producer warpgroup (warps 8-11, one thread of which issues
//    TMA) that drops to 24 registers by setmaxnreg.dec while the consumers
//    rise to 240: a consumer thread holds Q and dO (D / 4 registers each),
//    dQ (D / 2), S and dP (64) and the dS fragments (16), ~150-170 before
//    addressing, past the 168 that ptxas gives 288 threads at one block an
//    SM. At d = 32 a consumer thread needs ~100 (Q and dO 8 each, dQ 16), and
//    the exponentials, not the products, bind: there the block is 192
//    queries, three consumer warpgroups at 160 registers, so that
//    two groups' exponentials run while the third issues its products (as
//    the fp32 d = 32 forward, flash_sdpa_h_fp32.cu);
//  - Delta in the prologue from O and dO in device memory (two threads a
//    row), into shared memory and out; each consumer thread then loads its
//    two rows of Q and dO as A fragments once and keeps them;
//  - loads: the producer walks the block's live 64-key tiles (a byte a
//    tile from the key-bias row, compacted into a list) through a ring of
//    NSTAGE stages, each a K tile, a V tile (Tile of wgmma_common.cuh: one
//    swizzled slab at d = 32 (64-byte swizzle) and 64 (128-byte), five
//    16-column slabs at the 32-byte swizzle at d = 80) and the tile's 64 key-bias values, by cp.async.bulk.tensor
//    against full / empty mbarriers;
//  - products (a warpgroup, per key tile; wgmma_common.cuh layouts):
//      S  = Q K^T   m64n64k16 x D / 16, Q from registers, K K-major;
//      dP = dO V^T  m64n64k16 x D / 16, dO from registers, V K-major;
//      dQ += dS K   m64nDk16 x 4, dS from registers (the accumulator
//                   layout of S is the A-operand layout), K MN-major;
//    so no operand is transposed in memory and nothing is exchanged
//    between the groups;
//  - P = exp2(S * scale * log2(e) + key_bias * log2(e) - lse * log2(e)):
//    lse per row (this thread's two queries, in registers for the whole
//    walk), the key bias per column (read from the stage), one FMA, one add
//    and one ex2 an element; a masked or padded row's -lse * log2(e) is
//    taken as -1e30, so its P is 0;
//  - scheduling: the warpgroups take turns, in a ring, to issue their S /
//    dP products (named barriers, as the forward's ping-pong), so one
//    group's exponentials overlap the others' products.
// A block whose key row has no live key writes Delta and zeros and exits
// before any load. The grids are 41 x 32 = 1312 blocks (9.9 waves of 132)
// at the teacher's shape, 39 x 16 = 624 (4.7) at vit_h's and 27 x 32 = 864
// (6.5) at the Stage-3 shape.
//
// As built (ptxas): 168 registers a thread at launch, 240 a consumer
// thread, no spills, one block an SM. Measured on the H100 (80GB HBM3,
// 700 W; bench_vit_attn.py, in turns with the mma.sync kernel it
// replaces): d = 64 0.8058 / 0.8390 ms in a CUDA graph (2.1375 / 2.1755),
// 2.4-2.5x the bound; d = 80 0.4525 / 0.4509 ms (1.1550 / 1.1400), 2.4x.
// Tried and not kept: leaving each tile's dQ product running while the
// next tile's S and dP are issued (the stage freed a tile later), as the
// d = 256 dq kernel does: 0.8200 / 0.8322 and 0.4528 / 0.4545 ms.
// At d = 32 (bench_vit_attn.py --q8, the same card, in turns with the
// variant or the mma.sync kernel it replaced, ms in a CUDA graph): 128
// registers a thread at launch, 160 a consumer, no spills; three groups
// 0.6136 / 0.6180 against the mma.sync kernel's 1.0560 / 1.0558 (bound
// 0.2056); that overlap kept at d = 32 (0.6005 / 0.6016 against 0.6170 /
// 0.6149). Tried and not kept: two groups (0.6632 / 0.6629 against 0.6132
// / 0.6134), the groups issuing in any order (0.6253 / 0.6141 against
// 0.6166 / 0.6170), eight stages (0.6231 / 0.6186 against 0.6169 /
// 0.6165), each block starting its walk at its own share of the tile list
// (0.6240 / 0.6269 against 0.6002 / 0.5993: the blocks of a (batch, head)
// reading the same tile at a time share it in the L2), and four groups,
// which cannot run: 640 threads get 96
// registers each at launch, and setmaxnreg cannot raise 512 of them to 120
// past the block's pool. What holds it at ~2.9x the exponentials' bound is
// not measured (no per-pipe counters on this card's machine).

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int BN = 64;            // keys a tile
constexpr int NSTAGE = 4;         // K / V ring
constexpr int PROD_REGS = 24;

// The block and shared memory at head dim D: NWG consumer warpgroups of 64
// queries each and a producer warpgroup; shared memory from a 1024-aligned
// base.
template <int D>
struct Cfg {
  static constexpr int NWG = D == 32 ? 3 : 2;
  static constexpr int BM = 64 * NWG;      // queries a block
  static constexpr int NCONS = 128 * NWG;
  static constexpr int NTH = NCONS + 128;  // and the producer warpgroup
  static constexpr int CONS_REGS = NWG == 2 ? 240 : 160;
  static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");
  using TK = Tile<D, BN>;  // a K or V tile
  static constexpr int TILE = TK::BYTES;
  static constexpr int OFF_K = 0;                               // [NSTAGE] tiles
  static constexpr int OFF_V = OFF_K + NSTAGE * TILE;           // [NSTAGE] tiles
  static constexpr int OFF_BIAS = OFF_V + NSTAGE * TILE;        // [NSTAGE][BN] f32
  static constexpr int OFF_DELTA = OFF_BIAS + NSTAGE * BN * 4;  // [BM] f32
  static constexpr int OFF_BAR = OFF_DELTA + BM * 4;            // full[NSTAGE], empty[NSTAGE]
  static constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte a tile, the list
  static constexpr int STAGE_TX = 2 * TILE + BN * 4;
  static int bytes(int ntiles) {
    return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  }
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTH, 1)
flash_bwd_dq_h_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_bias,
                      const float* __restrict__ key_bias, const bf16* __restrict__ q,
                      const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      bf16* __restrict__ dq, int H, int lq, int lk, int lkb, float sm_scale,
                      long long sqb, long long sqh, long long sqn, long long sob, long long soh,
                      long long son, long long sdb, long long sdh, long long sdn, long long sgb,
                      long long sgh, long long sgn) {
  using C = Cfg<D>;
  using TK = typename C::TK;
  constexpr int NWG = C::NWG, BM = C::BM, NCONS = C::NCONS, NTH = C::NTH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + C::OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  float* delta_s = reinterpret_cast<float*>(smem + C::OFF_DELTA);
  unsigned char* tile_live = smem + C::OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (lk + BN - 1) / BN;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += (long long)b * lkb;
  q += b * sqb + h * sqh;
  o += b * sob + h * soh;
  dout += b * sdb + h * sdh;
  dq += b * sgb + h * sgh;

  // Delta = rowsum(dO o O) in fp32, two consumer threads a row of D / 2
  // columns each (16-byte loads: D / 2 columns are 32, 64 or 80 bytes)
  if (threadIdx.x < NCONS) {
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1, row = q0 + r;
    float sum = 0.f;
    if (row < lq) {
      const bf16* orow = o + row * son + part * (D / 2);
      const bf16* drow = dout + row * sdn + part * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
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
  // the live key tiles (keys past lk are padding at -1e9); its barriers
  // publish Delta and the mbarriers
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
        TK::load(s_base + C::OFF_K + s * C::TILE, &tm_k, full, key0, h, b);
        TK::load(s_base + C::OFF_V + s * C::TILE, &tm_v, full, key0, h, b);
        tma_load_2d(s_base + C::OFF_BIAS + s * BN * 4, &tm_bias, full, key0, b);
      });
    return;
  }

  // ---------------- consumer warpgroups, 64 queries each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONS_REGS) : "memory");
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows of the block
  const int r0 = q0 + rl0, r1 = r0 + 8;
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
  const float dl0 = delta_s[rl0], dl1 = delta_s[rl0 + 8];
  // Q and dO rows r0, r1 as the A operand of D / 16 k-steps of 16 columns:
  // {row g, cols 2t..}, {row g + 8, cols 2t..}, {g, 2t + 8..}, {g + 8, 2t + 8..}
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
      qa[kk][e] = row < lq ? *reinterpret_cast<const uint32_t*>(q + row * sqn + c) : 0u;
      da[kk][e] = row < lq ? *reinterpret_cast<const uint32_t*>(dout + row * sdn + c) : 0u;
    }

  float acc[D / 2];  // dQ of rows r0, r1
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float* bias_s = reinterpret_cast<const float*>(smem + C::OFF_BIAS);

  // at d = 32 each tile's dQ product is left running under the next tile's
  // S and dP, and its stage is released once those are in
  constexpr bool overlap = D == 32;
  if (wg == NWG - 1) named_arrive<256>(1);  // group 0 issues first
  uint32_t dsa[4][4];  // dS as the A operand of four k-steps of 16 keys
  for (int i = 0; i < nlive; ++i) {
    const int s = i % NSTAGE;
    const int key0 = live_list[i] * BN;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t k_addr = s_base + C::OFF_K + s * C::TILE;
    const uint32_t v_addr = s_base + C::OFF_V + s * C::TILE;

    // S = Q K^T and dP = dO V^T, this group's turn on the tensor cores
    float sc[32], dp[32];
    named_sync<256>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_rs<0>(sc, qa[kk], TK::desc_k(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_rs<0>(dp, da[kk], TK::desc_k(v_addr, kk), kk > 0);
    wgmma_commit();
    if (wg < NWG - 1 || i + 1 < nlive) named_arrive<256>(1 + (wg + 1) % NWG);
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    if constexpr (overlap) {  // the previous tile's dQ product is done too
      fence_regs(acc);
      fence_regs(dsa);
      if (i > 0 && lane == 0) mbar_arrive(bar_empty + 8 * ((i - 1) % NSTAGE));
    }

    // dS = P o (dP - Delta); keys past lk (zero-filled by TMA) masked
    const float* bs = bias_s + s * BN;
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
      dsa[j >> 1][(j & 1) * 2 + 0] =
          pack_bf16(p00 * (dp[4 * j + 0] - dl0), p01 * (dp[4 * j + 1] - dl0));
      dsa[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(p10 * (dp[4 * j + 2] - dl1), p11 * (dp[4 * j + 3] - dl1));
    }

    // dQ += dS K, K MN-major (N = D)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, dsa[kk], TK::desc_mn(k_addr, kk));
    wgmma_commit();
    if constexpr (!overlap) {
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }
  }
  if constexpr (overlap) {
    wgmma_wait0();
    fence_regs(acc);
  }

  // rows r0, r1: dQ * scale in bf16
  store_acc(dq, sgn, acc, r0, lq, 0, sm_scale);
}

// The kernel's shared-memory limit at head dim D for lk keys (its tile
// list grows with them), raised once a device and size.
template <int D>
int prepare(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = Cfg<D>::bytes((lk + BN - 1) / BN);
  return raise_smem(flash_bwd_dq_h_kernel<D>, *smem, smem_set);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, int B, int H, int lq,
           int lk, int lkb, float sm_scale, long long sqb, long long sqh, long long sqn,
           long long skb, long long skh, long long skn, long long svb, long long svh,
           long long svn, long long sob, long long soh, long long son, long long sdb,
           long long sdh, long long sdn, long long sgb, long long sgh, long long sgn,
           cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv, tb;
  CUresult r = map_heads(fn, &tk, k, D, lk, H, B, skb, skh, skn, BN);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, D, lk, H, B, svb, svh, svn, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  int smem = 0;
  const int err = prepare<D>(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + Cfg<D>::BM - 1) / Cfg<D>::BM, B * H);
  flash_bwd_dq_h_kernel<D><<<grid, Cfg<D>::NTH, smem, st>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const bf16*>(q),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), H, lq, lk, lkb, sm_scale, sqb, sqh, sqn,
      sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dQ and Delta. q, k, v, o, dout (B, H, N, d) bf16, d = 32, 64 or 80, with
// (batch, head, row) element strides, each a multiple of 8 and the base
// 16-byte aligned; key_bias (B, lkb) f32 contiguous and 16-byte aligned,
// lkb >= Lk a multiple of 4, columns past Lk at -1e9; lse (B, H, Lq) f32
// contiguous; delta (B, H, Lq) f32 written; dq by strides. Returns a CUDA
// error, 1000 + the CUresult if a tensor map is refused, or 999 when
// cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_bwd_dq_h(const void* q, const void* k, const void* v,
                                   const void* key_bias, const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq, int B, int H, int lq,
                                   int lk, int lkb, int d, float sm_scale, long long sqb,
                                   long long sqh, long long sqn, long long skb, long long skh,
                                   long long skn, long long svb, long long svh, long long svn,
                                   long long sob, long long soh, long long son, long long sdb,
                                   long long sdh, long long sdn, long long sgb, long long sgh,
                                   long long sgn, void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<64>) run = nullptr;
  if (d == 32) run = launch<32>;
  if (d == 64) run = launch<64>;
  if (d == 80) run = launch<80>;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, key_bias, o, dout, lse, delta, dq, B, H, lq, lk, lkb, sm_scale, sqb, sqh,
             sqn, skb, skh, skn, svb, svh, svn, sob, soh, son, sdb, sdh, sdn, sgb, sgh, sgn,
             static_cast<cudaStream_t>(stream));
}

// The kernel's resources at head dim d and lk keys (wgmma_common.cuh
// kernel_attrs): out = {registers, spilled bytes a thread, shared bytes a
// block, blocks an SM}.
extern "C" int flash_sdpa_bwd_dq_h_attrs(int d, int lk, int* out) {
  int smem = 0, err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 32 && (err = prepare<32>(lk, &smem)) == 0)
    return kernel_attrs(flash_bwd_dq_h_kernel<32>, Cfg<32>::NTH, smem, out);
  if (d == 64 && (err = prepare<64>(lk, &smem)) == 0)
    return kernel_attrs(flash_bwd_dq_h_kernel<64>, Cfg<64>::NTH, smem, out);
  if (d == 80 && (err = prepare<80>(lk, &smem)) == 0)
    return kernel_attrs(flash_bwd_dq_h_kernel<80>, Cfg<80>::NTH, smem, out);
  return err;
}
