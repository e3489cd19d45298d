// Flash attention backward, dK and dV, at head dims 32, 64 and 80, bf16,
// for Hopper (sm_90a): wgmma, TMA and a warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `_flash_bwd`'s
// dK / dV half (`_bwd_dkv_kernel` :970, its pallas_call at :1098) where
// training runs it:
//  - d = 32: Stage 3, the fusion encoder's self-attention, (4, 8, 5184, 32),
//    6 launches a step;
//  - d = 64: Stage 1 of the SAM3 teacher's ViT-H trunk, its global blocks
//    at (2, 16, 5184, 64), 4 launches a step;
//  - d = 80: Stage 1 of the vit_h student's trunk, (1, 16, 4900, 80), 4
//    launches a step.
// dQ and Delta = rowsum(dO o O) come from the dq kernel of
// flash_sdpa_bwd_dq_h.cu at d = 32, 64 and 80; fp32 operands are
// flash_sdpa_bwd_h_fp32.cu's and flash_sdpa_bwd_dq_h_fp32.cu's, and head
// dim 256 is flash_sdpa_bwd_wide_h.cu's (bf16) and
// flash_sdpa_bwd_wide_h_fp32.cu's (fp32).
//
// What it computes is the Pallas kernel's: P rebuilt from the forward's
// saved natural-log LSE, P = exp(S * scale + key_bias - lse), 0 on columns
// whose lse is masked (<= -5e8: every key of the batch row masked);
// dV = sum bf16(P)^T dO; dS = P o (dO V^T - Delta), rounded to bf16;
// dK = scale * sum bf16(dS)^T Q; fp32 accumulation throughout. A block
// whose keys are all masked writes zeros and returns; keys past Lk score
// -1e9 and are not written; queries past Lq read as zeros and contribute
// nothing. Strides over (B, H, N) are taken for q, k, v and dO (dO arrives
// as a view of the (B, N, H * D) gradient and TMA reads it in place), and
// dK, dV are written by strides ((B, N, H, D) memory). Deterministic: each
// block owns its keys' sums, no atomics.
//
// Bound on the H100 at (4, 8, 5184, 32): 4 products of 5184 x 5184 x 32 a
// (batch, head) (S, dP, dV, dK), 55 GFLOP over the 32 pairs (0.2226 ms at
// the bf16 peak), 860 M exponentials (~0.21 ms on the special-function
// units) and ~13 MB of operands: bound by the products; at d = 64 and 80
// the products a score grow with D (0.4452 ms at the teacher's shape,
// 0.2486 ms at vit_h's). What held the mma.sync kernel of
// the former flash_sdpa_bwd.cu back (d = 32: 2.2586 ms, 10.1x the bound; d = 64:
// 2.6797 ms, d = 80: 1.6984 ms, 6.0x and 6.8x): products from shared
// memory by mma.sync (a third of the peak), 64-row tiles staged by
// cp.async with no pipelining, B fragments read by ldmatrix.trans,
// products and exponentials in turn on four warps; at d = 64 and 80 also
// 32- or 64-query tiles chosen so that 254 or fewer registers would do.
//
// This kernel (one template over D):
//  - block: 128 keys held by two consumer warpgroups of 64 keys each
//    (warps 0-7) and a producer (warp 8, TMA only, 24 registers);
//  - K and V: each consumer thread loads its A-operand fragments of its
//    warpgroup's 64 keys (D / 4 registers for the two) from device memory
//    once and keeps them for the whole walk;
//  - loads: the producer keeps a ring of NSTAGE stages, each a 64-query Q
//    tile and dO tile (Tile of wgmma_common.cuh: one slab swizzled at the
//    row's 64 or 128 bytes at d = 32 and 64, five 16-column slabs at the
//    32-byte swizzle at d = 80) and the tile's 64 lse and Delta values, by
//    cp.async.bulk.tensor against full / empty mbarriers, as
//    flash_sdpa_h.cu; every query tile is walked;
//  - products (a warpgroup, per query tile; wgmma_common.cuh layouts):
//      S^T  = K Q^T    m64n64k16 x D / 16, K from registers, Q K-major;
//      dP^T = V dO^T   m64n64k16 x D / 16, V from registers, dO K-major;
//      dV  += P^T dO   m64nDk16 x 4, P^T from registers (the accumulator
//                      layout of S^T is the A-operand layout), dO MN-major;
//      dK  += dS^T Q   m64nDk16 x 4, dS^T from registers, Q MN-major;
//    so no operand is transposed in memory, and the tensor cores read only
//    the Q and dO tiles from shared memory (K and V staged there as well, a
//    build of this kernel ran slower on the H100 at d = 32);
//  - P^T = exp2(S^T * scale * log2(e) + key_bias * log2(e) - lse * log2(e)):
//    the key bias is per row (this thread's two keys, in registers for the
//    whole walk), lse per column (read from the stage), so each element is
//    one FMA, one add and one ex2; a masked or padded column's -lse * log2(e)
//    is taken as -1e30, so its P is 0;
//  - scheduling: the two warpgroups take turns to issue their S^T / dP^T
//    products (named barriers, as the forward's ping-pong), so one group's
//    exponentials overlap the other's products.
// Occupancy at d = 32: 168 registers a thread with no spills and 35,904
// bytes of shared memory a block (ptxas and the runtime, printed by
// chip_smoke.py): one block an SM, so the 41 x 32 = 1312 blocks of the
// Stage-3 shape run in ~10 waves. Tried on the H100 and not kept: three
// consumer warpgroups (faster, but spilling at the 128-register limit of
// 416 threads), 32-query stages at 2 blocks an SM and overlapping P^T with
// the dP^T product (each within a few percent of this kernel with K and V
// in shared memory, which K and V in registers beat by more).
//
// d = 64 and 80: a consumer thread holds K and V (32 or 40 registers), dK
// and dV (64 or 80), S^T and dP^T (64) and the P^T / dS^T fragments (32):
// ~190 or ~215 before addressing, past the 168 a thread that ptxas gives
// 288 threads at one block an SM. So the producer is a whole warpgroup (warps 8-11) that drops
// to 24 registers by setmaxnreg.dec, and the consumers rise to 240 by
// setmaxnreg.inc, as the d = 256 kernels do: 168 registers at launch, no
// spills; 68,672 and 85,056 bytes of shared memory (four 8 or 10 KB Q and
// dO stages); one block an SM. The grids are 41 x 32 = 1312 blocks (9.9
// waves) at the teacher's shape and 39 x 16 = 624 (4.7) at vit_h's. At
// d = 80 the layout question is the forward's (flash_sdpa_h.cu): two
// 64-column slabs with a zero-filled tail took 0.5018 / 0.5045 ms against
// these slabs' 0.5080-0.5133 (bench_vit_attn.py), at 134,208 bytes a
// block; kept as the forward. Measured (chip_smoke.py, H100 80GB HBM3, 700 W): d = 64 0.9566
// ms in a CUDA graph (2.1x the bound; the mma.sync kernel's 2.6797), d = 80
// 0.5064 ms (2.0x; 1.6984).

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int NWG = 2;            // consumer warpgroups, 64 keys each
constexpr int BN = 64 * NWG;      // keys a block
constexpr int BQ = 64;            // queries a stage
constexpr int NSTAGE = 4;         // Q / dO ring
constexpr int NCONS = 128 * NWG;
constexpr int PROD_REGS = 24, CONS_REGS = 240;  // d = 64 and 80 (setmaxnreg)

// The block at head dim D: at d = 32 one producer warp beside the consumers
// (the consumers keep the launch's registers); at d = 64 and 80 a producer
// warpgroup, whose registers go to the consumers by setmaxnreg.
template <int D>
struct Cfg {
  static constexpr bool WIDE = D > 32;
  static constexpr int NTH = NCONS + (WIDE ? 128 : 32);
  using TQ = Tile<D, BQ>;  // a Q or dO tile
  // shared memory, from a 1024-aligned base
  static constexpr int TILE = TQ::BYTES;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_DO = OFF_Q + NSTAGE * TILE;
  static constexpr int OFF_LSE = OFF_DO + NSTAGE * TILE;       // [NSTAGE][BQ] f32
  static constexpr int OFF_DELTA = OFF_LSE + NSTAGE * BQ * 4;  // [NSTAGE][BQ] f32
  static constexpr int OFF_BAR = OFF_DELTA + NSTAGE * BQ * 4;  // full[NSTAGE], empty[NSTAGE]
  static constexpr int SMEM = 1024 + OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int STAGE_TX = 2 * TILE + 2 * BQ * 4;
};
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTH, 1)
flash_bwd_dkv_h_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_lse,
                       const __grid_constant__ CUtensorMap tm_delta,
                       const bf16* __restrict__ k, const bf16* __restrict__ v,
                       long long skb, long long skh, long long skn, long long svb,
                       long long svh, long long svn, const float* __restrict__ key_bias, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int lq, int lk, float sm_scale,
                       long long skgb, long long skgh, long long skgn, long long svgb,
                       long long svgh, long long svgn) {
  using C = Cfg<D>;
  using TQ = typename C::TQ;
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

  int live = 0;
  if (threadIdx.x < BN) {
    const int key = key0 + threadIdx.x;
    live = key < lk && key_bias[key] > 0.5f * NEG_INF;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  if (!__syncthreads_or(live)) {  // every key of the block masked: zero gradients
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = threadIdx.x; i < BN * D / 2; i += C::NTH) {
      const int row = key0 + i / (D / 2), c = 2 * (i % (D / 2));
      if (row < lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row * skgn + c) = zero;
        *reinterpret_cast<__nv_bfloat162*>(dv + row * svgn + c) = zero;
      }
    }
    return;
  }
  const int nq = (lq + BQ - 1) / BQ;

  if (warp >= NCONS / 32) {
    // ---------------- producer warp(s): one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0) {
      for (int i = 0; i < nq; ++i) {
        const int s = i % NSTAGE;
        mbar_wait(bar_empty + 8 * s, ((i / NSTAGE) & 1) ^ 1);  // the first round passes
        const int q0 = i * BQ;
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, C::STAGE_TX);
        TQ::load(s_base + C::OFF_Q + s * C::TILE, &tm_q, full, q0, h, b);
        TQ::load(s_base + C::OFF_DO + s * C::TILE, &tm_do, full, q0, h, b);
        tma_load_2d(s_base + C::OFF_LSE + s * BQ * 4, &tm_lse, full, q0, bh);
        tma_load_2d(s_base + C::OFF_DELTA + s * BQ * 4, &tm_delta, full, q0, bh);
      }
    }
  } else {
    // ---------------- consumer warpgroups, 64 keys each
    if constexpr (C::WIDE)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int kr0 = key0 + wg * 64 + (warp & 3) * 16 + g, kr1 = kr0 + 8;  // this thread's keys
    const float scale2 = sm_scale * LOG2E;
    const float kb0 = kr0 < lk ? key_bias[kr0] * LOG2E : NEG_INF * LOG2E;
    const float kb1 = kr1 < lk ? key_bias[kr1] * LOG2E : NEG_INF * LOG2E;
    // K and V rows kr0, kr1 as the A operand of D / 16 k-steps of 16 columns:
    // {row g, cols 2t..}, {row g + 8, cols 2t..}, {g, 2t + 8..}, {g + 8, 2t + 8..}
    uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? kr1 : kr0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
        ka[kk][e] = row < lk ? *reinterpret_cast<const uint32_t*>(k + row * skn + c) : 0u;
        va[kk][e] = row < lk ? *reinterpret_cast<const uint32_t*>(v + row * svn + c) : 0u;
      }

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    if (wg == NWG - 1) named_arrive<2 * 128>(1);  // group 0 issues first
    for (int i = 0; i < nq; ++i) {
      const int s = i % NSTAGE;
      const int q0 = i * BQ;
      mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
      const uint32_t q_addr = s_base + C::OFF_Q + s * C::TILE;
      const uint32_t do_addr = s_base + C::OFF_DO + s * C::TILE;

      // S^T = K Q^T and dP^T = V dO^T, this group's turn on the tensor cores
      float st[32], dp[32];
      named_sync<2 * 128>(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_rs<0>(st, ka[kk], TQ::desc_k(q_addr, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_rs<0>(dp, va[kk], TQ::desc_k(do_addr, kk), kk > 0);
      wgmma_commit();
      if (wg < NWG - 1 || i + 1 < nq) named_arrive<2 * 128>(1 + (wg + 1) % NWG);
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dp);

      // P^T and dS^T as the A operands of four k-steps of 16 queries
      const float* ls = lse_s + s * BQ;
      const float* ds = delta_s + s * BQ;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + 2 * t;  // this thread's columns c, c + 1
        const float2 lv = *reinterpret_cast<const float2*>(ls + c);
        const float2 dl = *reinterpret_cast<const float2*>(ds + c);
        const float nl0 = q0 + c < lq && lv.x > 0.5f * NEG_INF ? -lv.x * LOG2E : DEAD;
        const float nl1 = q0 + c + 1 < lq && lv.y > 0.5f * NEG_INF ? -lv.y * LOG2E : DEAD;
        const float p00 = ex2(fmaf(st[4 * j + 0], scale2, kb0) + nl0);  // key g, query c
        const float p01 = ex2(fmaf(st[4 * j + 1], scale2, kb0) + nl1);
        const float p10 = ex2(fmaf(st[4 * j + 2], scale2, kb1) + nl0);  // key g + 8
        const float p11 = ex2(fmaf(st[4 * j + 3], scale2, kb1) + nl1);
        pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p00, p01);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p10, p11);
        da[j >> 1][(j & 1) * 2 + 0] =
            pack_bf16(p00 * (dp[4 * j + 0] - dl.x), p01 * (dp[4 * j + 1] - dl.y));
        da[j >> 1][(j & 1) * 2 + 1] =
            pack_bf16(p10 * (dp[4 * j + 2] - dl.x), p11 * (dp[4 * j + 3] - dl.y));
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major (N = D)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dva, pa[kk], TQ::desc_mn(do_addr, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dka, da[kk], TQ::desc_mn(q_addr, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    // keys g and g + 8 of this warp's 16: dK * scale and dV in bf16
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (kr0 < lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + kr0 * skgn + c) =
            __floats2bfloat162_rn(dka[4 * n + 0] * sm_scale, dka[4 * n + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + kr0 * svgn + c) =
            __floats2bfloat162_rn(dva[4 * n + 0], dva[4 * n + 1]);
      }
      if (kr1 < lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + kr1 * skgn + c) =
            __floats2bfloat162_rn(dka[4 * n + 2] * sm_scale, dka[4 * n + 3] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + kr1 * svgn + c) =
            __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

// The kernel's shared-memory limit at head dim D, raised once a device.
template <int D>
int prepare() {
  static int smem_set[64] = {};
  return raise_smem(flash_bwd_dkv_h_kernel<D>, Cfg<D>::SMEM, smem_set);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B, int H, int lq, int lk,
           int lqp, float sm_scale, long long sqb, long long sqh, long long sqn, long long skb,
           long long skh, long long skn, long long svb, long long svh, long long svn,
           long long sdb, long long sdh, long long sdn, long long skgb, long long skgh,
           long long skgn, long long svgb, long long svgh, long long svgn, cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tq, tdo, tl, td;
  CUresult r = map_heads(fn, &tq, q, D, lq, H, B, sqb, sqh, sqn, BQ);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tdo, dout, D, lq, H, B, sdb, sdh, sdn, BQ);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tl, lse, lqp, B * H, BQ);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &td, delta, lqp, B * H, BQ);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const int err = prepare<D>();
  if (err != 0) return err;
  const dim3 grid((lk + BN - 1) / BN, B * H);
  flash_bwd_dkv_h_kernel<D><<<grid, Cfg<D>::NTH, Cfg<D>::SMEM, st>>>(
      tq, tdo, tl, td, static_cast<const bf16*>(k), static_cast<const bf16*>(v), skb, skh, skn,
      svb, svh, svn, static_cast<const float*>(key_bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, lq, lk, sm_scale, skgb, skgh, skgn, svgb, svgh, svgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout (B, H, N, d) bf16, d = 32, 64 or 80, with (batch, head,
// row) element strides, each a multiple of 8 and the base 16-byte aligned;
// key_bias (B, Lk) f32 contiguous; lse and delta (B * H, lqp) f32
// contiguous and 16-byte aligned, lqp >= Lq a multiple of 4; dk, dv by
// strides. Returns a CUDA error, 1000 + the CUresult if a tensor map is
// refused, or 999 when cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_bwd_dkv_h(const void* q, const void* k, const void* v,
                                    const void* key_bias, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int B, int H, int lq,
                                    int lk, int lqp, int d, float sm_scale, long long sqb,
                                    long long sqh, long long sqn, long long skb, long long skh,
                                    long long skn, long long svb, long long svh, long long svn,
                                    long long sdb, long long sdh, long long sdn,
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
  return run(q, k, v, key_bias, dout, lse, delta, dk, dv, B, H, lq, lk, lqp, sm_scale, sqb, sqh,
             sqn, skb, skh, skn, svb, svh, svn, sdb, sdh, sdn, skgb, skgh, skgn, svgb, svgh, svgn,
             static_cast<cudaStream_t>(stream));
}

// The kernel's resources at head dim d (wgmma_common.cuh kernel_attrs):
// out = {registers, spilled bytes a thread, shared bytes a block, blocks
// an SM}.
extern "C" int flash_sdpa_bwd_dkv_h_attrs(int d, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 32 && (err = prepare<32>()) == 0)
    return kernel_attrs(flash_bwd_dkv_h_kernel<32>, Cfg<32>::NTH, Cfg<32>::SMEM, out);
  if (d == 64 && (err = prepare<64>()) == 0)
    return kernel_attrs(flash_bwd_dkv_h_kernel<64>, Cfg<64>::NTH, Cfg<64>::SMEM, out);
  if (d == 80 && (err = prepare<80>()) == 0)
    return kernel_attrs(flash_bwd_dkv_h_kernel<80>, Cfg<80>::NTH, Cfg<80>::SMEM, out);
  return err;
}
