// Flash cross-attention with the decoder's decomposed boxRPB bias, for
// Hopper (sm_90a): wgmma, TMA, and the key splits of a query tile merged
// inside a thread-block cluster. Forward only (inference).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `flash_xattn_rpb`
// (:898, body `_xattn_rpb_kernel` :776): softmax(Q K^T * scale + bias) V
// where bias[q, y * w + x] = ey[q, y] + ex[q, x]. The (NQ, h * w) bias is
// rebuilt per tile from the f32 ey/ex rows held in shared memory and never
// stored whole. The bias is exact f32, as on the einsum path
// (common.py:580-582), not the TPU kernel's one-hot matmuls at the input
// dtype. Keys past h * w score -1e9, as the TPU kernel's sentinel lane did.
// P is rounded to v's dtype for P V (a no-op at fp32). Shapes: the
// decoder's q (B, 8, 201, 32) and k/v (B, 8, 5184, 32), ey/ex (B, 8, 201,
// 72) f32, 6 launches a `ground` and a PCS frame; any map under 128 x 128.
//
// Bound on the H100 at the decoder shape: ~1.1 GFLOP of products and 8.3 M
// exponentials, 2.8 MB of operands: a few microseconds. What held the
// mma.sync kernel before it back (0.0716 ms in a CUDA graph in bf16, 0.0870
// in fp32; PERF.md): mma.sync from shared memory, each 64-key K / V tile
// staged by plain loads between two __syncthreads with no load in flight
// under a product, and the key axis split over 9 blocks whose unnormalised
// fp32 partials (1.85 MB) went through device memory to a second launch
// that merged them. The call is latency, not work.
//
// This kernel, one launch a call:
//  - grid: (splits, query tiles of 64, B * H); the `splits` blocks of one
//    (batch, head, query tile) are one cluster along x, each taking the key
//    tiles [s nt / S, (s + 1) nt / S) of the nt 64-key tiles. The wrapper's
//    `xattn_cluster` picks the most splits, up to 8 (the portable cluster
//    size), that keep the grid one wave: within two blocks an SM, and every
//    cluster resident at once by the runtime's count (clusters stay inside
//    a GPC, so they reach only ~124 of 132 SMs). At the decoder's shape
//    that is 7 (224 blocks); 8 would leave 2 of its 32 clusters of 8 for a
//    second wave (30 resident): the first version, at 8, took 0.0559 ms in
//    a graph (bench_decoder_kernels.py, H100 80GB HBM3, 700 W);
//  - block: one consumer warpgroup (the tile's 64 queries) and one producer
//    warp, 160 threads, two blocks an SM (__launch_bounds__). Tried and not
//    kept (no faster at any split count): three blocks an SM, where some
//    SMs held three blocks of the clusters and others one; a second
//    consumer warpgroup taking every other tile of the split (its
//    288-thread blocks spilled at two an SM);
//  - loads: the producer keeps a ring of K / V tile stages (bf16: 8 KB, the
//    whole split's tiles in flight at the decoder's shape; fp32: four 4 KB
//    parts a tile) filled by TMA, one mbarrier a stage, refilled as the
//    consumer warps free a stage; the stages are what fits under half the
//    SM's shared memory beside the ey / ex tables;
//  - products: S = Q K^T by wgmma m64n64k16 with Q in registers (the A
//    fragments, loaded once) and K K-major from shared memory at the
//    64-byte swizzle (wgmma_common.cuh Tile<32, 64>); O += P V by wgmma
//    m64n32k16 with P the register A operand and V read MN-major;
//  - bias, computed while S runs: ex and the split's rows of ey in log2
//    units in shared memory, each thread's two rows side by side; ex by row
//    pair with two adjacent x in one 16-byte unit, so that on an even-width
//    map at least a tile wide (the decoder's 72: a tile's keys on at most
//    two image rows) a thread's key pair costs one 16-byte load, a wrap test
//    and four adds for both rows, and a quarter-warp's loads hit 8 distinct
//    16-byte units; each warp stages and reads only its own 16 rows. The
//    bias was the largest part of a tile's time (copies of the kernel with
//    one part left out each: without the bias it gained most, without the
//    exponentials next), so a key pair costs one load where a key at a
//    time cost two loads and ~12 instructions a key. A narrower or
//    odd-width map takes (y, x) a key from a float reciprocal of w (exact
//    for keys under 2^14) and one 8-byte load;
//  - merge: each block leaves its unnormalised O (64 x 32 fp32), row max
//    and row sum in its own shared memory; after a cluster barrier, block s
//    merges rows [64 s / S, 64 (s + 1) / S) by reading every partner's
//    partials through distributed shared memory (all reads issued before
//    the sums) in split order 0 .. S - 1 (the same bits every run), and
//    writes O in q's dtype; a second cluster barrier keeps each block's
//    shared memory alive until its partners have read it. No partial
//    reaches device memory.
// fp32 operands (the default build): every product three bf16 wgmma on
// split parts (wgmma_common.cuh: hi hi + hi lo + lo hi), Q split in the
// prologue into hi and lo A fragments, K and V read from the split copies
// of flash_sdpa_split_parts; each tile's P V goes into a fresh fragment
// that round-to-nearest FMAs add into O (the tensor cores' truncating sums
// would bias O over thousands of keys).

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int D = 32;                // head dim
constexpr int BM = 64;               // queries a block (one consumer warpgroup)
constexpr int BN = 64;               // keys a tile
constexpr int NCONS = 128;
constexpr int NTH = NCONS + 32;      // and the producer warp
constexpr int MAX_SPLITS = 8;        // the portable cluster size
constexpr int XS = 68;               // row stride, floats, of the transposed ey table

// The ex table's row length in float4 (a row pair's two values at x and
// x + 1): the pairs' rows start 4 mod 8 16-byte units apart, so that a
// quarter-warp's loads (2 row pairs x 4 key pairs) hit 8 distinct units.
__host__ __device__ constexpr int ex_width(int wx) {
  return (wx + 1) / 2 + (12 - (wx + 1) / 2 % 8) % 8;
}
constexpr int BLOCKS_PER_SM = 2;
// shared memory a block may take so that two stay resident (the SM's
// 233,472 bytes, 1 KB reserved a block)
constexpr int SMEM_BUDGET = 233472 / BLOCKS_PER_SM - 1024;
constexpr int PART = BM * D * 4 + BM * 8;  // the merge's partial O and (m, l) rows

using TK = Tile<D, BN>;              // one part of a K or V tile, 4 KB

template <typename T>
struct Cfg {
  static constexpr int NP = sizeof(T) == 4 ? 2 : 1;  // bf16 parts an operand
  static constexpr int STAGE = 2 * NP * TK::BYTES;   // K parts, then V parts
  static_assert(2 * STAGE >= PART, "two stages hold the merge's partials");
};

// The block's shared memory from a 1024-aligned base: stages, ex^T, ey^T
// (ny rows), full / empty barriers; the partials of the merge reuse the
// stages.
struct Layout {
  int stage, nstage, ny, off_ex, off_ey, off_bar, bytes;
  __host__ __device__ Layout(int stage_bytes, int ns, int wx, int ny_)
      : stage(stage_bytes), nstage(ns), ny(ny_) {
    off_ex = ns * stage_bytes;
    off_ey = off_ex + 32 * ex_width(wx) * 16;
    off_bar = off_ey + ny * XS * 4;
    bytes = 1024 + off_bar + 16 * ns;
  }
};

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

template <typename T>
__global__ void __launch_bounds__(NTH, BLOCKS_PER_SM)
flash_xattn_rpb_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const T* __restrict__ q,
                       const float* __restrict__ ey, const float* __restrict__ ex,
                       T* __restrict__ o, int B, int H, int lq, int lk, int hy, int wx, int ny,
                       int nstage, float sm_scale, long long sqb, long long sqh, long long sqn,
                       long long sob, long long soh, long long son) {
  constexpr int NP = Cfg<T>::NP;
  const Layout L(Cfg<T>::STAGE, nstage, wx, ny);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  float* ex_t = reinterpret_cast<float*>(smem + L.off_ex);  // [32 row pairs][ex_width][4]
  float* ey_t = reinterpret_cast<float*>(smem + L.off_ey);  // [ny][XS], rows y0 ..
  const uint32_t bar_full = s_base + L.off_bar, bar_empty = bar_full + 8 * nstage;

  const int split = static_cast<int>(cluster_rank()), nsplit = gridDim.x;
  const int q0 = blockIdx.y * BM, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (lk + BN - 1) / BN;
  const int kt0 = split * ntiles / nsplit, kt1 = (split + 1) * ntiles / nsplit;
  const int n = kt1 - kt0;
  const int y0 = kt0 * BN / wx;  // the first image row of the split's keys

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCONS / 32) {
    // ---------------- producer warp: every tile of the split by TMA, through
    // the ring when there are more than the stages
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % nstage;
        mbar_wait(bar_empty + 8 * s, ((i / nstage) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar_full + 8 * s, Cfg<T>::STAGE);
        const int key0 = (kt0 + i) * BN;
        const uint32_t st = s_base + s * L.stage;
#pragma unroll
        for (int p = 0; p < NP; ++p) {  // the split copies: hi at b, lo at b + B
          TK::load(st + p * TK::BYTES, &tm_k, bar_full + 8 * s, key0, h, b + p * B);
          TK::load(st + (NP + p) * TK::BYTES, &tm_v, bar_full + 8 * s, key0, h, b + p * B);
        }
      }
    }
    __syncwarp();
  } else {
    // ---------------- the consumer warpgroup, 64 queries
    const int g = lane >> 2, t = lane & 3;
    const int tr0 = warp * 16 + g;  // this thread's rows tr0, tr0 + 8 of the tile
    const int r0 = q0 + tr0, r1 = r0 + 8;
    const int nrow = min(BM, lq - q0);

    // Q rows r0, r1 as the A operand of two k-steps of 16 columns ({row g,
    // cols 2t..}, {g + 8, 2t..}, {g, 2t + 8..}, {g + 8, 2t + 8..}); fp32
    // split into hi and lo fragments
    uint32_t qa[NP][D / 16][4];
    const T* qb = q + b * sqb + h * sqh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r1 : r0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
        if constexpr (NP == 1) {
          qa[0][kk][e] = row < lq ? *reinterpret_cast<const uint32_t*>(qb + row * sqn + c) : 0u;
        } else {
          float2 qv = make_float2(0.f, 0.f);
          if (row < lq) qv = *reinterpret_cast<const float2*>(qb + row * sqn + c);
          split_pair(qv.x, qv.y, qa[0][kk][e], qa[NP - 1][kk][e]);
        }
      }

    // this warp's 16 rows of ex and of the split's ey rows, in log2 units
    // (rows past lq 0), each thread's rows tr0, tr0 + 8 side by side: ex by
    // row pair p = 8 warp + r % 8 and x, the float4 (x >> 1) of pair p
    // holding (ex[r][x], ex[r + 8][x], ex[r][x + 1], ex[r + 8][x + 1]) for
    // even x; ey transposed, ey_t[y - y0][16 warp + 2 (r % 8) + r / 8]. A
    // warp reads only its own rows, so a warp barrier publishes them.
    const int ny_blk = min(hy, (kt1 * BN - 1) / wx + 1) - y0;
    const int wrow = warp * 16, wrows = min(16, nrow - wrow);  // rows of the warp below lq
    const float* exw = ex + ((long long)bh * lq + q0 + wrow) * wx;
    const float* eyw = ey + ((long long)bh * lq + q0 + wrow) * hy + y0;
    const float inv_w = 1.f / static_cast<float>(wx), inv_ny = 1.f / static_cast<float>(ny_blk);
#pragma unroll 6
    for (int i = lane; i < 16 * wx; i += 32) {  // rows are contiguous: coalesced reads
      const int r = static_cast<int>((static_cast<float>(i) + 0.5f) * inv_w), x = i - r * wx;
      ex_t[((warp * 8 + (r & 7)) * ex_width(wx) + (x >> 1)) * 4 + (x & 1) * 2 + (r >> 3)] =
          r < wrows ? exw[i] * LOG2E : 0.f;
    }
#pragma unroll 2
    for (int i = lane; i < 16 * ny_blk; i += 32) {
      const int r = static_cast<int>((static_cast<float>(i) + 0.5f) * inv_ny), y = i - r * ny_blk;
      ey_t[y * XS + wrow + 2 * (r & 7) + (r >> 3)] =
          r < wrows ? eyw[(long long)r * hy + y] * LOG2E : 0.f;
    }
    __syncwarp();
    // this thread's row pair in the tables (ey: XS / 2 pairs a table row)
    const float* ex_r = ex_t + (warp * 8 + g) * ex_width(wx) * 4;
    const float2* ey_p = reinterpret_cast<const float2*>(ey_t) + warp * 8 + g;
    constexpr int XP = XS / 2;

    const float scale2 = sm_scale * LOG2E;
    float acc[D / 2];  // O of rows r0, r1 (unnormalised)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E, l0 = 0.f, l1 = 0.f;

    for (int i = 0; i < n; ++i) {
      const int s = i % nstage;
      const int key0 = (kt0 + i) * BN;
      mbar_wait(bar_full + 8 * s, (i / nstage) & 1);
      const uint32_t st = s_base + s * L.stage;

      // S = Q K^T (on parts: hi hi + hi lo + lo hi)
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t khd = TK::desc_k(st, kk);
        wgmma_rs<0>(sc, qa[0][kk], khd, kk > 0);
        if constexpr (NP == 2) {
          wgmma_rs<0>(sc, qa[0][kk], TK::desc_k(st + TK::BYTES, kk));
          wgmma_rs<0>(sc, qa[1][kk], khd);
        }
      }
      wgmma_commit();

      // the bias of this thread's 16 keys (rows r0, r1). On an even-width
      // map at least a tile wide (the decoder's 72) a tile's keys lie on at
      // most two image rows ya, ya + 1, and each thread's key pair 2t, 2t +
      // 1 on one: ey from two pairs, ex of both keys and rows one 16-byte
      // load. Else (y, x) a key from a float reciprocal of w (exact for
      // keys under 2^14), ex one 8-byte load.
      float bias[32];  // in log2 units, while S runs
      if (wx >= BN && wx % 2 == 0) {
        const int ya = key0 / wx, xa = key0 - ya * wx;
        const float2 eya = ey_p[(ya - y0) * XP];
        const float2 eyb = ey_p[min(ya + 1 - y0, ny_blk - 1) * XP];
        const float4* ex4 = reinterpret_cast<const float4*>(ex_r);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          int x = xa + 8 * j + 2 * t;
          const bool wrap = x >= wx;
          x = wrap ? x - wx : x;
          const float4 exv = ex4[x >> 1];
          const float2 eyv = wrap ? eyb : eya;
          bias[4 * j + 0] = eyv.x + exv.x;
          bias[4 * j + 1] = eyv.x + exv.z;
          bias[4 * j + 2] = eyv.y + exv.y;
          bias[4 * j + 3] = eyv.y + exv.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + 8 * j + 2 * t + e;
            float2 b = make_float2(0.f, 0.f);  // keys past lk: masked below
            if (key < lk) {
              const int y = static_cast<int>((static_cast<float>(key) + 0.5f) * inv_w);
              const int x = key - y * wx;
              const float2 exv =
                  *reinterpret_cast<const float2*>(ex_r + (x >> 1) * 4 + (x & 1) * 2);
              const float2 eyv = ey_p[(y - y0) * XP];
              b = make_float2(eyv.x + exv.x, eyv.y + exv.y);
            }
            bias[4 * j + e] = b.x;
            bias[4 * j + 2 + e] = b.y;
          }
      }
      wgmma_wait0();
      fence_regs(sc);
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = fmaf(sc[e], scale2, bias[e]);
      if (key0 + BN > lk) {  // the last tile: keys past lk
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key0 + 8 * j + 2 * t + e >= lk) sc[4 * j + e] = sc[4 * j + 2 + e] = NEG_INF * LOG2E;
      }

      float corr0, corr1;
      const uint32_t v_hi = st + NP * TK::BYTES;
      if constexpr (NP == 1) {
        // P rounded to bf16; O = O corr + P V in the tensor cores
        uint32_t pa[BN / 16][4];
        softmax_logits<BN / 8>(sc, m0, m1, l0, l1, corr0, corr1, pack_emit<BN / 8>(pa));
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c + 0] *= corr0;
          acc[4 * c + 1] *= corr0;
          acc[4 * c + 2] *= corr1;
          acc[4 * c + 3] *= corr1;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, pa[kk], TK::desc_mn(v_hi, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        fence_regs(pa);
      } else {
        // P hi / lo; F = P V from a fresh fragment, O = O corr + F rounded
        uint32_t ph[BN / 16][4], pl[BN / 16][4];
        softmax_logits<BN / 8>(sc, m0, m1, l0, l1, corr0, corr1, split_emit<BN / 8>(ph, pl));
        float frag[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint64_t vhd = TK::desc_mn(v_hi, kk);
          wgmma_rs(frag, ph[kk], vhd, kk > 0);
          wgmma_rs(frag, ph[kk], TK::desc_mn(v_hi + TK::BYTES, kk));
          wgmma_rs(frag, pl[kk], vhd);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(frag);
        fence_regs(ph);
        fence_regs(pl);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c + 0] = fmaf(acc[4 * c + 0], corr0, frag[4 * c + 0]);
          acc[4 * c + 1] = fmaf(acc[4 * c + 1], corr0, frag[4 * c + 1]);
          acc[4 * c + 2] = fmaf(acc[4 * c + 2], corr1, frag[4 * c + 2]);
          acc[4 * c + 3] = fmaf(acc[4 * c + 3], corr1, frag[4 * c + 3]);
        }
      }
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    // this split's partials over the stages, once every warp is done with
    // them: part[r][c] the unnormalised O, ml[r] = (m, l)
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    named_sync<NCONS>(1);
    float* part = reinterpret_cast<float*>(smem);
    float2* ml = reinterpret_cast<float2*>(smem + BM * D * 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t;
      *reinterpret_cast<float2*>(part + tr0 * D + col) = make_float2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<float2*>(part + (tr0 + 8) * D + col) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
    if (t == 0) {
      ml[tr0] = make_float2(m0, l0);
      ml[tr0 + 8] = make_float2(m1, l1);
    }
  }

  // ---------------- the merge: block `split` writes rows [64 s / S, 64 (s +
  // 1) / S) of the tile from every block's partials, in split order
  cluster_sync();
  if (threadIdx.x < NCONS) {
    const int ra = split * BM / nsplit, rb = (split + 1) * BM / nsplit;
    T* ob = o + b * sob + h * soh;
    for (int item = threadIdx.x; item < (rb - ra) * (D / 4); item += NCONS) {
      const int r = ra + item / (D / 4), c = 4 * (item % (D / 4));
      if (q0 + r >= lq) continue;
      const uint32_t p_addr = s_base + (r * D + c) * 4, ml_addr = s_base + BM * D * 4 + r * 8;
      // every split's (m, l) and O first, so that the remote reads overlap
      float2 mls[MAX_SPLITS];
      float4 ps[MAX_SPLITS];
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (s < nsplit) {
          mls[s] = ld_cluster_f2(cluster_addr(ml_addr, s));
          ps[s] = ld_cluster_f4(cluster_addr(p_addr, s));
        }
      float mx = NEG_INF * LOG2E;
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (s < nsplit) mx = fmaxf(mx, mls[s].x);
      float den = 0.f;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (s < nsplit) {
          const float w = ex2(mls[s].x - mx);
          den = fmaf(mls[s].y, w, den);
          num.x = fmaf(ps[s].x, w, num.x);
          num.y = fmaf(ps[s].y, w, num.y);
          num.z = fmaf(ps[s].z, w, num.z);
          num.w = fmaf(ps[s].w, w, num.w);
        }
      const float inv = 1.f / fmaxf(den, 1e-30f);
      store4(ob + (q0 + r) * son + c,
             make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
    }
  }
  cluster_sync();  // partners' reads of this block's partials are done
}

// The block's layout for a call: the stages that fit under SMEM_BUDGET
// beside the tables (every tile of a split when they fit), at least 2.
template <typename T>
Layout layout_for(int lk, int hy, int wx, int nsplit) {
  const int ntiles = (lk + BN - 1) / BN;
  const int per = (ntiles + nsplit - 1) / nsplit;  // the most tiles a split takes
  const int ny = min(hy, (per * BN - 1) / wx + 2);
  const Layout fixed(Cfg<T>::STAGE, 0, wx, ny);
  int ns = (SMEM_BUDGET - fixed.bytes) / (Cfg<T>::STAGE + 16);
  return Layout(Cfg<T>::STAGE, max(2, min(per, ns)), wx, ny);
}

template <typename T>
int prepare(int bytes) {
  static int smem_set[64] = {};
  return raise_smem(flash_xattn_rpb_kernel<T>, bytes, smem_set);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ey, const void* ex, void* o,
           int B, int H, int lq, int lk, int hy, int wx, int nsplit, float sm_scale,
           long long sqb, long long sqh, long long sqn, long long skb, long long skh,
           long long skn, long long svb, long long svh, long long svn, long long sob,
           long long soh, long long son, cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv;
  CUresult r;
  if (sizeof(T) == 2) {
    r = map_heads(fn, &tk, k, D, lk, H, B, skb, skh, skn, BN);
    if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, D, lk, H, B, svb, svh, svn, BN);
  } else {  // k and v are split copies (2 B, H, lk, 32) bf16
    r = map_parts(fn, &tk, k, D, lk, H, B, BN);
    if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, v, D, lk, H, B, BN);
  }
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const Layout L = layout_for<T>(lk, hy, wx, nsplit);
  int err = prepare<T>(L.bytes);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, (lq + BM - 1) / BM, B * H);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_xattn_rpb_kernel<T>, tk, tv, static_cast<const T*>(q),
      static_cast<const float*>(ey), static_cast<const float*>(ex), static_cast<T*>(o), B, H, lq,
      lk, hy, wx, L.ny, L.nstage, sm_scale, sqb, sqh, sqn, sob, soh, son);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs(int lk, int hy, int wx, int nsplit, int* out) {
  const Layout L = layout_for<T>(lk, hy, wx, nsplit);
  int err = prepare<T>(L.bytes);
  if (err != 0) return err;
  err = kernel_attrs(flash_xattn_rpb_kernel<T>, NTH, L.bytes, out);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, 4, 8);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = L.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, flash_xattn_rpb_kernel<T>, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[4] = clusters;
  out[5] = L.nstage;
  return 0;
}

}  // namespace

// q (B, H, lq, 32) and o by (batch, head, row) element strides, each a
// multiple of 8 and the bases 16-byte aligned; bf16 (fp32 == 0): k and v
// (B, H, lk, 32) by strides; fp32: k and v the split copies (2 B, H, lk, 32)
// bf16 of flash_sdpa_split_parts. ey (B * H, lq, hy) and ex (B * H, lq, wx)
// f32 contiguous, lk == hy * wx, hy and wx under 128; 1 <= nsplit <= 8 and
// nsplit <= the key tiles. Returns a CUDA error, 1000 + the CUresult if a
// tensor map is refused, or 999 when cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_xattn_rpb_fwd(const void* q, const void* k, const void* v, const void* ey,
                                   const void* ex, void* o, int B, int H, int lq, int lk, int d,
                                   int fp32, int hy, int wx, int nsplit, float sm_scale,
                                   long long sqb, long long sqh, long long sqn, long long skb,
                                   long long skh, long long skn, long long svb, long long svh,
                                   long long svn, long long sob, long long soh, long long son,
                                   void* stream) {
  if (d != D || lq <= 0 || lk != hy * wx || hy <= 0 || wx <= 0 || hy >= 128 || wx >= 128 ||
      nsplit < 1 || nsplit > MAX_SPLITS || nsplit > (lk + BN - 1) / BN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = fp32 ? launch<float> : launch<bf16>;
  return run(q, k, v, ey, ex, o, B, H, lq, lk, hy, wx, nsplit, sm_scale, sqb, sqh, sqn, skb, skh,
             skn, svb, svh, svn, sob, soh, son, static_cast<cudaStream_t>(stream));
}

// The kernel's resources for an hy x wx map in nsplit splits (wgmma_common.cuh
// kernel_attrs): out = {registers, spilled bytes a thread, shared bytes a
// block, blocks an SM, clusters of nsplit blocks resident at once on the
// device, K / V stages a block}.
extern "C" int flash_xattn_rpb_attrs(int fp32, int hy, int wx, int nsplit, int* out) {
  const int lk = hy * wx;
  if (hy <= 0 || wx <= 0 || hy >= 128 || wx >= 128 || nsplit < 1 || nsplit > MAX_SPLITS ||
      nsplit > (lk + BN - 1) / BN)
    return static_cast<int>(cudaErrorInvalidValue);
  return fp32 ? attrs<float>(lk, hy, wx, nsplit, out) : attrs<bf16>(lk, hy, wx, nsplit, out);
}
