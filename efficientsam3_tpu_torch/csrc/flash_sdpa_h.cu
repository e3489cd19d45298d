// Flash scaled-dot-product attention forward at head dim 32, bf16, for
// Hopper (sm_90a): wgmma, TMA and a warp-specialised pipeline.
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py
// `_flash_fwd_packed` (`_packed_kernel` :182, its pallas_call at :304),
// which `flash_sdpa` (:1181) picks for head dims under 128: the fusion
// encoder's self-attention, q/k/v (1, 8, 5184, 32) a `ground` and
// (4, 8, 5184, 32) a Stage-3 step, 6 launches each. What it computes is
// that of flash_sdpa.cu: softmax(Q K^T * scale + key_bias) V with an fp32
// online softmax, P rounded to bf16 for the PV product, a (B, Lk) fp32
// additive key bias (-1e9 masks), key tiles whose keys are all masked
// skipped, the natural-log LSE (the backward reads it), 0 and lse -1e9 for
// a row whose keys are all masked, ragged Lq and Lk masked in the kernel,
// any (B, H, N) strides on q, k and v, the output in (B, N, H, D) memory.
// fp32 operands run flash_sdpa.cu (wgmma's tf32 form needs both operands
// K-major, and V is not).
//
// What held the mma.sync kernel of flash_sdpa.cu back (0.2679 ms at the
// `ground` shape against 0.1645 ms for one F.scaled_dot_product_attention
// call; bound 0.0514 ms): the work is 27.5 GFLOP of products (0.028 ms at
// the bf16 peak), 215 M exponentials (0.0514 ms on the special-function
// units) and about six FMA-pipe operations an element (~0.04 ms); its four
// warps issue mma.sync, which reaches a third of the tensor peak from
// shared memory (ops/mma_probe.py), and run products, softmax and exp in
// turn; each 64-key tile costs two __syncthreads and a __syncthreads_or; K
// and V are loaded synchronously with no pipelining, and V is transposed
// by eight 2-byte shared stores a 16-byte chunk; `ground` launches only 648
// blocks of 128 threads.
//
// This kernel:
//  - block: 128 query rows held by two consumer warpgroups of 64 rows each
//    (warps 0-7), plus one producer warp (warp 8) that only issues TMA and
//    drops to 24 registers (setmaxnreg.dec); the consumers keep the launch's
//    count (a setmaxnreg.inc waits for registers the pool may not hold);
//  - loads: the producer keeps a ring of NSTAGE = 3 stages, each a 64-key K
//    tile, V tile (64 x 32 bf16, 4 KB each) and the tiles' 64 key biases,
//    filled by cp.async.bulk.tensor against an mbarrier (full) and handed
//    back by the eight consumer warps (empty). q/k/v are described as 4-D
//    (D, N, H, B) tensor maps with the 64-byte swizzle the wgmma shared
//    memory descriptors read; the maps are encoded on the host through
//    cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__
//    parameters. The Q tile comes the same way, once;
//  - products: S = Q K^T by wgmma m64n64k16 from shared memory (both
//    operands K-major, two k-steps over d = 32); P stays in registers,
//    where the S accumulator layout is the A-operand layout, and O += P V
//    runs as wgmma m64n32k16 with A from registers and V read as an
//    MN-major B operand (transpose bit): no transposed copy of V;
//  - softmax: exp2 (ex2.approx), with scale * log2(e) and the bias folded
//    into one FMA; the LSE goes back to the natural log at the end;
//  - scheduling: the two consumer warpgroups take turns to issue their
//    QK^T (two named barriers, as FA3's ping-pong), so that one group's
//    softmax overlaps the other's products;
//  - masked tiles: the block reads its key-bias row once into a byte per
//    tile and compacts the live tiles into a list; a dead tile is never
//    loaded nor computed.
// Occupancy: ~35 KB of shared memory a block (6 would fit), but registers
// allow 2 blocks of 288 threads an SM (96 registers a thread): 264 slots
// for `ground`'s 41 x 8 = 328 blocks, the last 64 as a second wave. Held to
// 72 registers for 3 blocks an SM (one wave), the kernel took 0.2822 ms at
// `ground`'s shape against 0.1684 ms at 2 (chip_smoke.py, H100 80GB HBM3,
// 700 W), so it stays at 2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 32;
constexpr int BM = 128;           // query rows a block
constexpr int BN = 64;            // keys a tile
constexpr int NSTAGE = 3;         // K / V ring
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int NTH = NCONS + 32;   // and the producer warp
constexpr float NEG_INF = -1e9f;  // the JAX kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory, from a 1024-aligned base (the 64-byte swizzle repeats
// every 512 bytes; TMA and the wgmma descriptors see the same pattern)
constexpr int TILE_BYTES = BN * D * 2;  // one K or V tile, 64-byte rows
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + BM * D * 2;
constexpr int OFF_V = OFF_K + NSTAGE * TILE_BYTES;
constexpr int OFF_BIAS = OFF_V + NSTAGE * TILE_BYTES;
constexpr int OFF_BAR = OFF_BIAS + NSTAGE * BN * 4;  // full[NSTAGE], empty[NSTAGE], q
constexpr int OFF_NLIVE = OFF_BAR + (2 * NSTAGE + 1) * 8;
constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;  // a byte per tile, then the list
constexpr int STAGE_TX = 2 * TILE_BYTES + BN * 4;

int smem_bytes(int ntiles) {
  return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor with the 64-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 2 (B64).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler must not move reads or writes of registers that an async
// wgmma owns across its wait: these make each register look rewritten here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}

__global__ void __launch_bounds__(NTH, 2)
flash_sdpa_h_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_bias,
                    const float* __restrict__ key_bias, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int lq, int lk, int lkb, float sm_scale,
                    long long sob, long long soh, long long son) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + OFF_BIAS);  // [NSTAGE][BN]
  const uint32_t bar_full = s_base + OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  const uint32_t bar_q = bar_empty + NSTAGE * 8;
  int* nlive_s = reinterpret_cast<int*>(smem + OFF_NLIVE);
  unsigned char* tile_live = smem + OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (lk + BN - 1) / BN;
  unsigned short* live_list =
      reinterpret_cast<unsigned short*>(tile_live + (ntiles + 15) / 16 * 16);
  key_bias += (long long)b * lkb;

  // which key tiles hold a live key (stores of 1 may race: same value),
  // then warp 0 compacts them into a list; thread 0 sets up the barriers
  for (int i = threadIdx.x; i < ntiles; i += NTH) tile_live[i] = 0;
  __syncthreads();
  // 4 keys a 16-byte load (the host checks the rows' alignment); keys past
  // lk are padding at -1e9
  const float4* kb4 = reinterpret_cast<const float4*>(key_bias);
  for (int i = threadIdx.x; i < lkb / 4; i += NTH) {
    const float4 bv = kb4[i];
    if (fmaxf(fmaxf(bv.x, bv.y), fmaxf(bv.z, bv.w)) > 0.5f * NEG_INF) tile_live[4 * i / BN] = 1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONS / 32);  // one arrival a consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool lv = i < ntiles && tile_live[i];
      const unsigned mask = __ballot_sync(0xffffffffu, lv);
      if (lv) live_list[n + __popc(mask & ((1u << lane) - 1u))] = static_cast<unsigned short>(i);
      n += __popc(mask);
    }
    if (lane == 0) *nlive_s = n;
  }
  __syncthreads();
  const int nlive = *nlive_s;

  if (warp == NCONS / 32) {
    // ---------------- producer warp: TMA only
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (lane == 0) {
      mbar_expect_tx(bar_q, BM * D * 2);
      tma_load_4d(s_base + OFF_Q, &tm_q, bar_q, 0, q0, h, b);
      for (int i = 0; i < nlive; ++i) {
        const int s = i % NSTAGE;
        mbar_wait(bar_empty + 8 * s, ((i / NSTAGE) & 1) ^ 1);  // the first round passes
        const int key0 = live_list[i] * BN;
        mbar_expect_tx(bar_full + 8 * s, STAGE_TX);
        tma_load_4d(s_base + OFF_K + s * TILE_BYTES, &tm_k, bar_full + 8 * s, 0, key0, h, b);
        tma_load_4d(s_base + OFF_V + s * TILE_BYTES, &tm_v, bar_full + 8 * s, 0, key0, h, b);
        tma_load_2d(s_base + OFF_BIAS + s * BN * 4, &tm_bias, bar_full + 8 * s, key0, b);
      }
    }
  } else {
    // ---------------- two consumer warpgroups, 64 rows each
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;  // this thread's rows
    const float scale2 = sm_scale * LOG2E;

    // Q (64 rows of this group) and K: K-major, 64-byte rows, 8-row groups
    // 512 bytes apart; a k-step of 16 columns is 32 bytes along the row.
    // V: MN-major (d contiguous), keys 64 bytes apart, a k-step of 16 keys
    // 1024 bytes.
    const uint32_t q_addr = s_base + OFF_Q + wg * 64 * D * 2;
    const uint64_t qd0 = make_desc(q_addr, 16, 512), qd1 = make_desc(q_addr + 32, 16, 512);

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    if (wg == 1 && nlive > 0) named_arrive(1);  // group 0 issues first
    for (int i = 0; i < nlive; ++i) {
      const int s = i % NSTAGE;
      const int key0 = live_list[i] * BN;
      mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
      const uint32_t k_addr = s_base + OFF_K + s * TILE_BYTES;
      const uint32_t v_addr = s_base + OFF_V + s * TILE_BYTES;

      // S = Q K^T, this group's turn on the tensor cores
      float sc[32];
      named_sync(1 + wg);
      wgmma_fence();
      wgmma_m64n64k16_ss(sc, qd0, make_desc(k_addr, 16, 512), 0);
      wgmma_m64n64k16_ss(sc, qd1, make_desc(k_addr + 32, 16, 512), 1);
      wgmma_commit();
      if (wg == 0 || i + 1 < nlive) named_arrive(2 - wg);  // the other group's turn
      wgmma_wait0();
      fence_regs(sc);

      // logits in log2 units: s * scale * log2(e) + bias * log2(e); keys
      // past lk (zero-filled by TMA) masked
      const float* bs = bias_s + s * BN;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + 2 * t;
        const float2 bv = *reinterpret_cast<const float2*>(bs + c);
        const float b0 = key0 + c < lk ? bv.x * LOG2E : NEG_INF * LOG2E;
        const float b1 = key0 + c + 1 < lk ? bv.y * LOG2E : NEG_INF * LOG2E;
        sc[4 * j + 0] = fmaf(sc[4 * j + 0], scale2, b0);
        sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, b1);
        sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, b0);
        sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, b1);
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = ex2(m0 - mx0), corr1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[4][4];  // P as the A operand of four k-steps of 16 keys
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(sc[4 * j + 0] - mx0), p1 = ex2(sc[4 * j + 1] - mx0);
        const float p2 = ex2(sc[4 * j + 2] - mx1), p3 = ex2(sc[4 * j + 3] - mx1);
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);  // row g, keys 16kk + 8(j&1) + 2t
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[4 * n + 0] *= corr0;
        acc[4 * n + 1] *= corr0;
        acc[4 * n + 2] *= corr1;
        acc[4 * n + 3] *= corr1;
      }

      // O += P V, P from registers, V an MN-major operand
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32k16_rs(acc, pa[kk], make_desc(v_addr + kk * 1024, 1024, 512));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    // rows g and g + 8: the quad's partial sums, then out = acc / l
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    o += b * sob + h * soh;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < lq)
        *reinterpret_cast<__nv_bfloat162*>(o + r0 * son + c) =
            __floats2bfloat162_rn(acc[4 * n + 0] * i0, acc[4 * n + 1] * i0);
      if (r1 < lq)
        *reinterpret_cast<__nv_bfloat162*>(o + r1 * son + c) =
            __floats2bfloat162_rn(acc[4 * n + 2] * i1, acc[4 * n + 3] * i1);
    }
    if (lse != nullptr && t == 0) {
      lse += (long long)bh * lq;
      const float valid = 0.5f * NEG_INF * LOG2E;
      if (r0 < lq) lse[r0] = m0 > valid ? (m0 + __log2f(fmaxf(l0, 1e-30f))) * LN2 : NEG_INF;
      if (r1 < lq) lse[r1] = m1 > valid ? (m1 + __log2f(fmaxf(l1, 1e-30f))) * LN2 : NEG_INF;
    }
  }
}

// ---- host: tensor maps through the driver entry point (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, H, N, 32) bf16 view with element strides (sb, sh, sn) as a 4-D
// (32, N, H, B) map, boxes of `rows` rows of one (batch, head), 64-byte
// swizzle; rows past N read as zeros.
CUresult map_heads(EncodeTiled fn, CUtensorMap* m, const void* base, int n, int H, int B,
                   long long sb, long long sh, long long sn, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// q, k, v (B, H, N, 32) bf16 with (batch, head, row) element strides, each
// a multiple of 8 and the base 16-byte aligned; key_bias (B, lkb) f32
// contiguous and 16-byte aligned, lkb >= Lk a multiple of 4, columns past
// Lk at -1e9; o by strides; lse (B, H, Lq) f32 or null. Returns a CUDA error, 1000 + the driver's code if a tensor map is
// refused, or 999 without the driver entry point.
extern "C" int flash_sdpa_h_fwd(const void* q, const void* k, const void* v,
                                const void* key_bias, void* o, void* lse, int B, int H, int lq,
                                int lk, int lkb, float sm_scale, long long sqb, long long sqh,
                                long long sqn, long long skb, long long skh, long long skn,
                                long long svb, long long svh, long long svn, long long sob,
                                long long soh, long long son, void* stream) {
  if (lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
      reinterpret_cast<uintptr_t>(key_bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tq, tk, tv, tb;
  CUresult r = map_heads(fn, &tq, q, lq, H, B, sqb, sqh, sqn, BM);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tk, k, lk, H, B, skb, skh, skn, BN);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, lk, H, B, svb, svh, svn, BN);
  if (r == CUDA_SUCCESS) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(lkb), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(lkb) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(BN), 1};
    const cuuint32_t estr[2] = {1, 1};
    r = fn(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(key_bias), dims, strides,
           box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  // the shared-memory limit is raised once a device, and again only for
  // a key count whose tile list needs more than the limit already set;
  // the tensor maps hold the tensors' addresses, so each call encodes its own
  const int smem = smem_bytes((lk + BN - 1) / BN);
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_sdpa_h_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  const dim3 grid((lq + BM - 1) / BM, B * H);
  flash_sdpa_h_kernel<<<grid, NTH, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tb, static_cast<const float*>(key_bias), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, lq, lk, lkb, sm_scale, sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}
