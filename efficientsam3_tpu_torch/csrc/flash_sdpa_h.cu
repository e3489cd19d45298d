// Flash scaled-dot-product attention forward at head dims 32, 64, 80 and
// 256, bf16, for Hopper (sm_90a): wgmma, TMA and a warp-specialised
// pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py
// `_flash_fwd_packed` (`_packed_kernel` :182, its pallas_call at :304),
// which `flash_sdpa` (:1181) picks for head dims under 128, and `_flash_fwd`
// (`_kernel` :57, its pallas_call at :144) where the ViT students run it:
//  - d = 32: the fusion encoder's self-attention, q/k/v (1, 8, 5184, 32) a
//    `ground` and (4, 8, 5184, 32) a Stage-3 step, 6 launches each;
//  - d = 64: the SAM3 teacher's ViTDet global blocks, (1, 16, 5184, 64), 4
//    launches a `set_image`, q/k/v strided views of one packed qkv tensor;
//  - d = 80: the vit_h SAM1 student's global blocks, (1, 16, 4900, 80) at
//    1120^2, 4 launches a `set_image` and 8 a Stage-1 step (the
//    checkpointed blocks run their forward again), views of a packed qkv;
//  - d = 256 (`_kernel` alone: one head): the tracker's memory attention,
//    self-attention q/k/v (8, 1, 5184, 256) with 3 of 8 object slots live
//    and the plain path's cross-attention over k/v (8, 1, 36352, 256), 4
//    launches a tracked frame (8 on the plain path) and 56 an 8-frame
//    training clip (the d = 256 backward reads its LSE).
// What it computes: softmax(Q K^T * scale + key_bias) V with an fp32
// online softmax, P rounded to bf16 for the PV product, a (B, Lk) fp32
// additive key bias (-1e9 masks), key tiles whose keys are all masked
// skipped, the natural-log LSE (the backward reads it), 0 and lse -1e9 for
// a row whose keys are all masked, ragged Lq and Lk masked in the kernel,
// any (B, H, N) strides on q, k and v, the output in (B, N, H, D) memory.
// fp32 operands run flash_sdpa_h_fp32.cu (this design on split bf16 parts:
// wgmma's tf32 form needs both operands K-major, and V is not).
//
// What held the mma.sync kernel before it back (d = 32: 0.2679 ms at
// the `ground` shape against 0.1645 ms for one F.scaled_dot_product_attention
// call, bound 0.0514 ms; d = 64: 1.3815 ms against SDPA's 0.2783, bound
// 0.1113 ms): at d = 32 the work is 27.5 GFLOP of products (0.028 ms at the
// bf16 peak), 215 M exponentials (0.0514 ms on the special-function units)
// and about six FMA-pipe operations an element (~0.04 ms); d = 64 doubles
// the scores and the products a score, so its bound is the products
// (110 GFLOP, 0.111 ms). Its four warps issue mma.sync, which reaches a
// third of the tensor peak from shared memory (ops/mma_probe.py), and run
// products, softmax and exp in turn; each 64-key tile costs two
// __syncthreads and a __syncthreads_or; K and V are loaded synchronously
// with no pipelining, and V is transposed by 2-byte shared stores.
//
// This kernel (one template over D):
//  - block: 128 query rows held by two consumer warpgroups of 64 rows each
//    (warps 0-7), plus one producer warp (warp 8) that only issues TMA and
//    drops to 24 registers (setmaxnreg.dec); the consumers keep the launch's
//    count (a setmaxnreg.inc waits for registers the pool may not hold);
//  - loads: the producer keeps a ring of NSTAGE = 3 stages (2 at d = 256,
//    below), each a 64-key K tile, V tile (64 x D bf16: 4 KB at d = 32, 8
//    KB at d = 64) and the tiles' 64 key biases, filled by
//    cp.async.bulk.tensor against an mbarrier (full) and handed back by the
//    eight consumer warps (empty). q/k/v are described as 4-D (D, N, H, B)
//    tensor maps in boxes of the row's width swizzled at that width (64
//    bytes at d = 32, 128 bytes at d = 64), at d = 80 five 16-column boxes
//    a tile swizzled at 32 bytes, the layouts the wgmma shared memory
//    descriptors read (wgmma_common.cuh, Tile); the maps are encoded on the
//    host through cudaGetDriverEntryPoint (no -lcuda) and
//    passed as __grid_constant__ parameters. The Q tile comes the same way,
//    once;
//  - products: S = Q K^T by wgmma m64n64k16 from shared memory (both
//    operands K-major, D / 16 k-steps); P stays in registers, where the S
//    accumulator layout is the A-operand layout, and O += P V runs as wgmma
//    m64nDk16 with A from registers and V read as an MN-major B operand
//    (transpose bit): no transposed copy of V;
//  - softmax: exp2 (ex2.approx), with scale * log2(e) and the bias folded
//    into one FMA; the LSE goes back to the natural log at the end;
//  - scheduling: the two consumer warpgroups take turns to issue their
//    QK^T (two named barriers, as FA3's ping-pong), so that one group's
//    softmax overlaps the other's products;
//  - masked tiles: the block reads its key-bias row once into a byte per
//    tile and compacts the live tiles into a list (wgmma_common.cuh
//    live_tiles); a dead tile is never loaded nor computed, and a block
//    with none (an empty object slot) writes zeros and exits before any
//    load.
// Occupancy at d = 32: ~35 KB of shared memory a block (6 would fit), but
// registers allow 2 blocks of 288 threads an SM (96 registers a thread):
// 264 slots for `ground`'s 41 x 8 = 328 blocks, the last 64 as a second
// wave. Held to 72 registers for 3 blocks an SM (one wave), the kernel took
// 0.2822 ms at `ground`'s shape against 0.1684 ms at 2 (chip_smoke.py, H100
// 80GB HBM3, 700 W), so it stays at 2.
// At d = 64 the O accumulator doubles (32 registers a thread) and a block
// takes 67,664 bytes of shared memory (Q 16 KB, three 16 KB K / V stages;
// 34,896 at d = 32); both instantiations use 96 registers with no spills,
// 2 blocks an SM (ptxas and the runtime, printed by chip_smoke.py). The
// teacher's 41 x 16 = 656 blocks are 2.5 waves of 264; blocks are
// independent and equal in work (every key tile live), so the tail is the
// half wave, ~17% of the launch at worst. Tried on the H100 and not kept,
// each slower at d = 64: FA3's intra-warpgroup overlap (the next tile's
// Q K^T issued before this tile's P V completes) and Q held in registers
// as the A operand (both spill at the 96-register limit of 2 blocks an SM),
// three consumer warpgroups at one block an SM, and no ping-pong (level).
//
// d = 80 (the mma.sync register kernel before it took 1.7898 ms
// at vit_h's shape, 14.4x its bound of 0.1243 ms, 5.1x SDPA's 0.3500):
//  - layout: a 160-byte row has no swizzle of its own; five 16-column
//    slabs at the 32-byte swizzle (wgmma_common.cuh's Layouts note) keep a
//    tile at 160 bytes a row (K / V tiles 10 KB, Q 20 KB, 84,016 bytes a
//    block) and make P V's B operand N = 80 five whole swizzle atoms. Two
//    64-column slabs at the 128-byte swizzle, the second one's columns
//    80-127 zero-filled by TMA (a partial atom for N = 80), computed the
//    same results in the same time (bench_vit_attn.py: 0.4507 / 0.4498 ms
//    against 0.4487-0.4532) at 133,168 bytes a block, which would leave
//    no room for a second block an SM;
//  - occupancy: the O accumulator is 40 registers a thread. At 2 blocks an
//    SM ptxas caps a thread at 96 registers (as at d = 32 and 64), where
//    this instantiation spilled 144 bytes and took 0.6433 / 0.6498 ms
//    (bench_vit_attn.py). So one block
//    an SM (168 registers, no spills): the 39 x 16 = 624 blocks are 4.7 waves
//    of 132, the last one 73% full.
//  - Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.4530 ms in a CUDA
//    graph, 3.6x the bound and 1.30x SDPA's 0.3493. Tried and not kept:
//    FA3's intra-warpgroup overlap with 4 stages (ptxas serialised its
//    wgmma, C7513, and it was no faster). Not tried: a block without the
//    producer warp (8 warps: 128 registers at 2 blocks an SM), one TMA
//    issuer among the consumers.
//
// d = 256 (the mma.sync kernel before it took 3.5083 ms
// at the cross shape, 6.3x its bound of 0.5569 ms, and 0.4206 ms at the
// self shape against 0.0835: Q from shared memory by ldmatrix, K and V by
// cp.async with no pipelining, mma.sync at a third of the tensor peak):
//  - work: a 64 x 64 score tile and its P V product are 2.1 MFLOP each a
//    warpgroup, one exponential per 256 multiply-adds: bound by the tensor
//    cores at both shapes (123 live blocks, a wave of 132 SMs);
//  - layout: a 512-byte row is four 64-column slabs at the 128-byte
//    swizzle (Tile, as flash_sdpa_bwd_wide_h.cu); Q K^T moves to the next
//    slab every four k-steps, and P V reads V MN-major with N = 256 across
//    the slabs through the descriptor's leading byte offset;
//  - registers: the 64 x 256 O accumulator is 128 fp32 registers a
//    thread, beside the 32 of S and 16 of P. The block is the two consumer
//    warpgroups and a producer warpgroup (384 threads, ptxas allocates by
//    whole warpgroups: 168 a thread at launch), and setmaxnreg moves them:
//    24 for the producers, 240 for the consumers;
//  - shared memory: Q 64 KB (128 rows) and two stages of K + V (64 KB
//    each), 199,696 bytes a block at 36352 keys: one block an SM.

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int BM = 128;           // query rows a block
constexpr int BN = 64;            // keys a tile
constexpr int NCONS = 256;        // two consumer warpgroups
// and the producer: one warp, whose launch keeps the consumers' registers
// (a setmaxnreg.inc waits for registers the pool may not hold); at d = 256
// a warpgroup, so that setmaxnreg can move the pool to the consumers
constexpr int PROD_REGS = 24, WIDE_REGS = 240;
static_assert(NCONS * WIDE_REGS + 128 * PROD_REGS <= 65536, "register pool");

template <int D>
__host__ __device__ constexpr int nthreads() {
  return NCONS + (D == 256 ? 128 : 32);
}

// K / V ring: 3 stages, 2 of the 64 KB ones at d = 256
template <int D>
__host__ __device__ constexpr int nstage() {
  return D == 256 ? 2 : 3;
}

// shared memory, from a 1024-aligned base, each tile in the slabs of
// wgmma_common.cuh's Tile (the swizzle repeats every 8 rows of a slab: 512
// bytes at d = 32, 1024 at d = 64, 256 at d = 80; TMA and the wgmma
// descriptors see the same pattern)
template <int D>
struct Smem {
  static constexpr int NSTAGE = nstage<D>();
  using TQ = Tile<D, BM>;                // the block's Q tile
  using TK = Tile<D, BN>;                // a K or V tile
  static constexpr int TILE = TK::BYTES;  // one K or V tile
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + TQ::BYTES;
  static constexpr int OFF_V = OFF_K + NSTAGE * TILE;
  static constexpr int OFF_BIAS = OFF_V + NSTAGE * TILE;
  static constexpr int OFF_BAR = OFF_BIAS + NSTAGE * BN * 4;  // full[NSTAGE], empty[NSTAGE], q
  static constexpr int OFF_NLIVE = OFF_BAR + (2 * NSTAGE + 1) * 8;
  static constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte per tile, the list
  static constexpr int STAGE_TX = 2 * TILE + BN * 4;
  static int bytes(int ntiles) {
    return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  }
};

// blocks an SM: 2 at d = 32 and 64 (96 registers a thread), 1 at d = 80,
// whose 40-register O accumulator spills at the 96 of 2 blocks, and at
// d = 256
template <int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return D == 80 || D == 256 ? 1 : 2;
}

template <int D>
__global__ void __launch_bounds__(nthreads<D>(), blocks_per_sm<D>())
flash_sdpa_h_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_bias,
                    const float* __restrict__ key_bias, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int lq, int lk, int lkb, float sm_scale,
                    long long sob, long long soh, long long son) {
  using L = Smem<D>;
  constexpr int NSTAGE = L::NSTAGE, NTH = nthreads<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + L::OFF_BIAS);  // [NSTAGE][BN]
  const uint32_t bar_full = s_base + L::OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  const uint32_t bar_q = bar_empty + NSTAGE * 8;
  unsigned char* tile_live = smem + L::OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (lk + BN - 1) / BN;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += (long long)b * lkb;
  o += b * sob + h * soh;
  if (lse != nullptr) lse += (long long)bh * lq;

  // thread 0 sets up the barriers; the live key tiles (keys past lk are
  // padding at -1e9), whose block barriers publish them
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init(bar_q, 1);
    mbar_init_fence();
  }
  const int nlive = live_tiles<BN, NTH>(key_bias, lkb, ntiles, tile_live, live_list,
                                        reinterpret_cast<int*>(smem + L::OFF_NLIVE));
  if (nlive == 0) {  // every key of the batch row masked (an empty slot): no loads
    dead_rows<BM, D, NTH>(o, son, lse, q0, lq);
    return;
  }

  if (warp >= NCONS / 32) {
    // ---------------- producer warp (warpgroup at d = 256): TMA only
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0) {
      mbar_expect_tx(bar_q, L::TQ::BYTES);
      L::TQ::load(s_base + L::OFF_Q, &tm_q, bar_q, q0, h, b);
      for (int i = 0; i < nlive; ++i) {
        const int s = i % NSTAGE;
        mbar_wait(bar_empty + 8 * s, ((i / NSTAGE) & 1) ^ 1);  // the first round passes
        const int key0 = live_list[i] * BN;
        mbar_expect_tx(bar_full + 8 * s, L::STAGE_TX);
        L::TK::load(s_base + L::OFF_K + s * L::TILE, &tm_k, bar_full + 8 * s, key0, h, b);
        L::TK::load(s_base + L::OFF_V + s * L::TILE, &tm_v, bar_full + 8 * s, key0, h, b);
        tma_load_2d(s_base + L::OFF_BIAS + s * BN * 4, &tm_bias, bar_full + 8 * s, key0, b);
      }
    }
  } else {
    // ---------------- two consumer warpgroups, 64 rows each
    if constexpr (D == 256)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WIDE_REGS) : "memory");
    const int wg = warp >> 2;
    const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const float scale2 = sm_scale * LOG2E;
    // Q (64 rows of this group) and K K-major; V MN-major (wgmma_common.cuh)
    const uint32_t q_addr = s_base + L::OFF_Q + wg * 64 * L::TQ::ROW;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    if (wg == 1) named_arrive<NCONS>(1);  // group 0 issues first
    for (int i = 0; i < nlive; ++i) {
      const int s = i % NSTAGE;
      const int key0 = live_list[i] * BN;
      mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
      const uint32_t k_addr = s_base + L::OFF_K + s * L::TILE;
      const uint32_t v_addr = s_base + L::OFF_V + s * L::TILE;

      // S = Q K^T, this group's turn on the tensor cores
      float sc[32];
      named_sync<NCONS>(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(sc, L::TQ::desc_k(q_addr, kk), L::TK::desc_k(k_addr, kk), kk > 0);
      wgmma_commit();
      if (wg == 0 || i + 1 < nlive) named_arrive<NCONS>(2 - wg);  // the other group's turn
      wgmma_wait0();
      fence_regs(sc);

      // the online softmax (keys past lk, zero-filled by TMA, masked); P
      // rounded to bf16 as the A operand of four k-steps of 16 keys
      float corr0, corr1;
      uint32_t pa[4][4];
      softmax_pack<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1,
                           pa);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 0] *= corr0;
        acc[4 * n + 1] *= corr0;
        acc[4 * n + 2] *= corr1;
        acc[4 * n + 3] *= corr1;
      }

      // O += P V, P from registers, V an MN-major operand
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, pa[kk], L::TK::desc_mn(v_addr, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    finish_rows(o, son, lse, acc, r0, lq, 0, m0, m1, l0, l1);
  }
}

// The block's dynamic shared memory at lk keys, and the kernel's limit
// raised to it: once a device, and again only for a key count whose tile
// list needs more than the limit already set.
template <int D>
int prepare(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = Smem<D>::bytes((lk + BN - 1) / BN);
  return raise_smem(flash_sdpa_h_kernel<D>, *smem, smem_set);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias, void* o, void* lse,
           int B, int H, int lq, int lk, int lkb, float sm_scale, long long sqb, long long sqh,
           long long sqn, long long skb, long long skh, long long skn, long long svb,
           long long svh, long long svn, long long sob, long long soh, long long son,
           cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tq, tk, tv, tb;
  CUresult r = map_heads(fn, &tq, q, D, lq, H, B, sqb, sqh, sqn, BM);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tk, k, D, lk, H, B, skb, skh, skn, BN);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, D, lk, H, B, svb, svh, svn, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  // the tensor maps hold the tensors' addresses, so each call encodes its own
  int smem = 0;
  const int err = prepare<D>(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + BM - 1) / BM, B * H);
  flash_sdpa_h_kernel<D><<<grid, nthreads<D>(), smem, st>>>(
      tq, tk, tv, tb, static_cast<const float*>(key_bias), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, lq, lk, lkb, sm_scale, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (B, H, N, d) bf16, d = 32, 64, 80 or 256, with (batch, head, row) element
// strides, each a multiple of 8 and the base 16-byte aligned; key_bias
// (B, lkb) f32 contiguous and 16-byte aligned, lkb >= Lk a multiple of 4,
// columns past Lk at -1e9; o by strides; lse (B, H, Lq) f32 or null.
// Returns a CUDA error, 1000 + the CUresult if a tensor map is refused,
// or 999 when cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_sdpa_h_fwd(const void* q, const void* k, const void* v,
                                const void* key_bias, void* o, void* lse, int B, int H, int lq,
                                int lk, int lkb, int d, float sm_scale, long long sqb,
                                long long sqh, long long sqn, long long skb, long long skh,
                                long long skn, long long svb, long long svh, long long svn,
                                long long sob, long long soh, long long son, void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<32>) run = nullptr;
  if (d == 32) run = launch<32>;
  if (d == 64) run = launch<64>;
  if (d == 80) run = launch<80>;
  if (d == 256) run = launch<256>;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, key_bias, o, lse, B, H, lq, lk, lkb, sm_scale, sqb, sqh, sqn, skb, skh,
             skn, svb, svh, svn, sob, soh, son, static_cast<cudaStream_t>(stream));
}

// The kernel's resources at head dim d and lk keys (wgmma_common.cuh
// kernel_attrs): out = {registers, spilled bytes a thread, shared bytes a
// block, blocks an SM}.
extern "C" int flash_sdpa_h_attrs(int d, int lk, int* out) {
  int smem = 0, err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 32 && (err = prepare<32>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_kernel<32>, nthreads<32>(), smem, out);
  if (d == 64 && (err = prepare<64>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_kernel<64>, nthreads<64>(), smem, out);
  if (d == 80 && (err = prepare<80>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_kernel<80>, nthreads<80>(), smem, out);
  if (d == 256 && (err = prepare<256>(lk, &smem)) == 0)
    return kernel_attrs(flash_sdpa_h_kernel<256>, nthreads<256>(), smem, out);
  return err;
}
