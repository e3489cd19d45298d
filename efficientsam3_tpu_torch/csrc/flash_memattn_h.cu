// Flash cross-attention over the tracker's cached memory bank, raw values
// narrower than the keys, for Hopper (sm_90a): wgmma, TMA and a
// warp-specialised pipeline, bf16 operands and fp32 operands on split bf16
// parts (one template over the parts).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `flash_memattn`
// (`_memattn_kernel` :358 and `_memattn_kernel_lse` :425, their
// pallas_calls at :559 and :536): the cached tracker's memory attention,
// 4 launches a tracked frame, q (8, 1, 5184, 256) against the bank's keys
// k (8, 1, 36864, 256) and raw memory tokens v (8, 1, 36864, 64) (v_proj is
// applied after the attention, exact because softmax rows sum to 1), 8
// object slots of which the live ones hold up to 7 valid entries of 5184
// keys each.
//
// What it computes: softmax(Q K^T * scale + key_bias) V_raw with dk = 256
// and dv = 64, an fp32 online softmax, P rounded to the value dtype for the
// P V product (bf16; at fp32 kept fp32 on split parts), the denominator
// summed in fp32 from the unrounded P (the einsum path's choice: the TPU
// kernel's ones row summed the rounded P, ~2^-9 apart), a (B, Lk) fp32
// additive key bias (-1e9 masks), the optional natural-log LSE (the merge
// with the object-pointer segment reads it), 0 with lse -1e9 for a row
// whose keys are all masked, ragged Lq and Lk, and any (B, H, N) strides
// on q, k and v with the last dim contiguous, so the per-layer bank views
// k_adj[:, None] and v_bank[:, None] enter without a copy. The TPU kernel
// ran transposed (S^T = K Q^T, O^T = [V^T; 1] P^T) only to keep the MXU's
// 128 lanes busy at dv = 64; none of that carries over.
//
// Bound on the H100 at the tracker shape, per live slot and bank entry:
// 2 x 5184 x 5184 x 320 = 17.2 GFLOP of products (0.0174 ms at the bf16
// peak), 26.9 M exponentials, 2.7 MB of keys and values: bound by the
// tensor cores. Each of the 41 query blocks of a slot streams that slot's
// keys and values (18.9 + 4.7 MB at 7 entries, more than a third of the 50
// MB L2), so the grid runs the query blocks of one slot next to each other
// (blockIdx.x fastest): the slot's 41 blocks stream its bank nearly in
// step and read it from L2. What held the mma.sync kernel before it
// (flash_qsmem.cuh, 1.9945 ms at 3 live slots against a bound of 0.3652):
// Q's fragments re-read from shared memory by every warp at every key
// tile, K and V copied by cp.async and waited on with no pipelining,
// mma.sync at a third of the tensor peak, and at fp32 each operand split
// on its way in through registers with 150 KB of shared memory.
//
// This kernel:
//  - block: 128 queries, two consumer warpgroups of 64 and a producer
//    warpgroup (one thread of which issues TMA) at 24 registers by
//    setmaxnreg, the consumers at 240; one block an SM. The grid at 3 live
//    slots is 41 x 3 = 123 live blocks, one wave of 132 SMs (328 at 8
//    slots, 2.5 waves); a slot with no live key (an empty object slot)
//    writes zeros and lse -1e9 and exits before any load;
//  - Q in registers: at dv = 64 the O accumulator is 32 registers a
//    thread, which leaves room for the group's 64 x 256 Q tile as the A
//    operand of all 16 k-steps of Q K^T (64 registers a thread, read from
//    device memory once in the prologue); shared memory is all K / V
//    stages;
//  - loads: the producer walks the block's live key tiles (a byte a tile
//    from the key-bias row, compacted into a list: invalid bank entries
//    and the pad tail are neither loaded nor computed) through a ring of
//    NSTAGE stages, each a K tile (four 64-column slabs at the 128-byte
//    swizzle), a V tile (one 64-column slab) and the tile's key biases, by
//    cp.async.bulk.tensor against full / empty mbarriers;
//  - products: S = Q K^T by wgmma with A from registers and K K-major;
//    P stays in registers (the accumulator layout of S is the A-operand
//    layout) and O += P V reads V MN-major (the transpose bit); the two
//    groups take turns to issue their Q K^T (named barriers, FA3's
//    ping-pong), so one group's softmax overlaps the other's products;
//  - softmax: exp2 with scale * log2(e) and the bias folded into one FMA
//    (wgmma_common.cuh softmax_pack / softmax_split).
// bf16: 64-key tiles (K 32 KB, V 8 KB a stage), five stages, 208,928
// bytes a block at the bank's 36864 keys. Measured (bench_vit_attn.py
// --tracker, NVIDIA H100 80GB HBM3, 700 W, in turns with four stages,
// 167,696 bytes): 0.7148 / 0.7162 ms at 3 live slots x 7 entries against
// 0.7793 / 0.7736, 2.1986 / 2.2128 at 8 slots against 2.3264 / 2.2644
// (bound 0.3652 and 0.9739). A slot's 41 query blocks make one wave at up
// to 3 live slots (1 slot takes as long as 3: 0.7096 ms), two at 4 to 6
// and three at 7 and 8; each block streams the whole bank of its slot.
// fp32 (the default build): every product is three bf16 wgmma on split
// parts (hi hi + hi lo + lo hi, wgmma_common.cuh), as flash_sdpa_h_fp32.cu:
// K and V come from split copies that the wrapper makes first
// (flash_sdpa_split_parts with 32-key tile skipping: only the rows of live
// tiles, which are all this kernel reads), Q is split in the prologue (hi
// in registers, lo in shared memory in TMA's swizzle, read by the _ss
// form), P is split in registers, and each tile's P V fills a fresh
// fragment that is added into O by round-to-nearest FMAs (the tensor
// cores' truncating sums over the bank's 36288 keys would bias O). A stage
// of 64 keys in parts would be 80 KB, two of which beside Q lo's 64 KB
// leave no room for the tile list; so 32-key tiles (K hi / lo 32 KB, V hi
// / lo 8 KB), three stages, 193,344 bytes a block at 36864 keys.

#include <type_traits>

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int DK = 256, DV = 64;
constexpr int BM = 128;                 // queries a block
constexpr int NCONS = 256, NTH = NCONS + 128;  // two consumer warpgroups and a producer one
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");

// NP parts an operand: 1 for bf16, 2 for fp32 (split hi / lo); shared
// memory from a 1024-aligned base
template <int NP>
struct Cfg {
  using T = std::conditional_t<NP == 1, bf16, float>;
  static constexpr int BN = NP == 1 ? 64 : 32;  // keys a tile
  static constexpr int NSTAGE = NP == 1 ? 5 : 3;
  using TK = Tile<DK, BN>;  // one part of a K tile
  using TV = Tile<DV, BN>;  // one part of a V tile
  using TQ = Tile<DK, 64>;  // a group's Q lo (fp32)
  static constexpr int K_HI = 0, K_LO = TK::BYTES;  // within a stage: K parts, then V parts
  static constexpr int V_HI = NP * TK::BYTES, V_LO = V_HI + TV::BYTES;
  static constexpr int STAGE = NP * (TK::BYTES + TV::BYTES);
  static constexpr int OFF_S = 0;                                       // [NSTAGE] stages
  static constexpr int OFF_QLO = OFF_S + NSTAGE * STAGE;                // [2] groups' Q lo
  static constexpr int OFF_BIAS = OFF_QLO + (NP - 1) * 2 * TQ::BYTES;   // [NSTAGE][BN] f32
  static constexpr int OFF_BAR = OFF_BIAS + NSTAGE * BN * 4;            // full[], empty[]
  static constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;      // a byte a tile, the list
  static constexpr int STAGE_TX = STAGE + BN * 4;
  static int bytes(int ntiles) {
    return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  }
};

template <int NP>
__global__ void __launch_bounds__(NTH, 1)
flash_memattn_h_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_bias,
                       const float* __restrict__ key_bias,
                       const typename Cfg<NP>::T* __restrict__ q,
                       typename Cfg<NP>::T* __restrict__ o, float* __restrict__ lse, int B,
                       int H, int lq, int lk, int lkb, float sm_scale, long long sqb,
                       long long sqh, long long sqn, long long sob, long long soh,
                       long long son) {
  using C = Cfg<NP>;
  using TK = typename C::TK;
  using TV = typename C::TV;
  using TQ = typename C::TQ;
  constexpr int BN = C::BN, NSTAGE = C::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + C::OFF_BAR, bar_empty = bar_full + NSTAGE * 8;
  unsigned char* tile_live = smem + C::OFF_LIVE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, t = lane & 3;
  const int tr0 = (warp & 3) * 16 + (lane >> 2);  // this thread's rows of its group's 64
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
  if (nlive == 0) {  // every key of the slot masked (an empty object slot): no loads
    dead_rows<BM, DV, NTH>(o, son, lse, q0, lq);
    return;
  }

  if (warp >= NCONS / 32) {
    // ---------------- producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (warp == NCONS / 32 && lane == 0)
      produce<NSTAGE>(nlive, bar_full, bar_empty, C::STAGE_TX, [&](int i, int s, uint32_t full) {
        const int key0 = live_list[i] * BN;
        const uint32_t st = s_base + C::OFF_S + s * C::STAGE;
        TK::load(st + C::K_HI, &tm_k, full, key0, h, b);
        TV::load(st + C::V_HI, &tm_v, full, key0, h, b);
        if constexpr (NP == 2) {  // the split copies: hi at batch b, lo at b + B
          TK::load(st + C::K_LO, &tm_k, full, key0, h, b + B);
          TV::load(st + C::V_LO, &tm_v, full, key0, h, b + B);
        }
        tma_load_2d(s_base + C::OFF_BIAS + s * BN * 4, &tm_bias, full, key0, b);
      });
    return;
  }

  // ---------------- two consumer warpgroups, 64 queries each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  // Q rows r0, r1 as the A operand of 16 k-steps of 16 columns ({row g,
  // cols 2t..}, {g + 8, 2t..}, {g, 2t + 8..}, {g + 8, 2t + 8..}); at fp32
  // the hi part, the lo part at the same places of the group's Q lo tile
  uint32_t qa[DK / 16][4];
  const uint32_t ql = s_base + C::OFF_QLO + wg * TQ::BYTES;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0, c = 16 * kk + 8 * (e >> 1) + 2 * t;
      if constexpr (NP == 1) {
        qa[kk][e] = row < lq ? *reinterpret_cast<const uint32_t*>(q + row * sqn + c) : 0u;
      } else {
        float2 qv = make_float2(0.f, 0.f);
        if (row < lq) qv = *reinterpret_cast<const float2*>(q + row * sqn + c);
        uint32_t lo;
        split_pair(qv.x, qv.y, qa[kk][e], lo);
        *reinterpret_cast<uint32_t*>(smem + C::OFF_QLO + wg * TQ::BYTES +
                                     TQ::at(tr0 + 8 * (e & 1), c)) = lo;
      }
    }
  if constexpr (NP == 2) {
    fence_proxy_async();
    named_sync<128>(3 + wg);  // the group's Q lo tile written before its wgmma reads it
  }

  const float scale2 = sm_scale * LOG2E;
  const float* bias_s = reinterpret_cast<const float*>(smem + C::OFF_BIAS);
  float acc[DV / 2];  // O of rows r0, r1
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E, l0 = 0.f, l1 = 0.f;

  if (wg == 1) named_arrive<NCONS>(1);  // group 0 issues first
  for (int i = 0; i < nlive; ++i) {
    const int s = i % NSTAGE;
    const int key0 = live_list[i] * BN;
    mbar_wait(bar_full + 8 * s, (i / NSTAGE) & 1);
    const uint32_t st = s_base + C::OFF_S + s * C::STAGE;

    // S = Q K^T (at fp32 on parts), this group's turn on the tensor cores
    float sc[BN / 2];
    named_sync<NCONS>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint64_t khd = TK::desc_k(st + C::K_HI, kk);
      wgmma_rs<0>(sc, qa[kk], khd, kk > 0);
      if constexpr (NP == 2) {
        wgmma_rs<0>(sc, qa[kk], TK::desc_k(st + C::K_LO, kk));
        wgmma_m64n32k16_ss(sc, TQ::desc_k(ql, kk), khd, 1);
      }
    }
    wgmma_commit();
    if (wg == 0 || i + 1 < nlive) named_arrive<NCONS>(2 - wg);  // the other group's turn
    wgmma_wait0();
    fence_regs(sc);

    float corr0, corr1;
    if constexpr (NP == 1) {
      // O = O * corr + bf16(P) V, P from registers, V an MN-major operand
      uint32_t pa[BN / 16][4];
      softmax_pack<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1,
                           pa);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        acc[4 * n + 0] *= corr0;
        acc[4 * n + 1] *= corr0;
        acc[4 * n + 2] *= corr1;
        acc[4 * n + 3] *= corr1;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, pa[kk], TV::desc_mn(st + C::V_HI, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    } else {
      // F = P V on parts from a fresh fragment, then O = O * corr + F
      // rounded to nearest
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
      softmax_split<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1,
                            ph, pl);
      float frag[DV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t vhd = TV::desc_mn(st + C::V_HI, kk);
        wgmma_rs(frag, ph[kk], vhd, kk > 0);
        wgmma_rs(frag, ph[kk], TV::desc_mn(st + C::V_LO, kk));
        wgmma_rs(frag, pl[kk], vhd);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(frag);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        acc[4 * n + 0] = fmaf(acc[4 * n + 0], corr0, frag[4 * n + 0]);
        acc[4 * n + 1] = fmaf(acc[4 * n + 1], corr0, frag[4 * n + 1]);
        acc[4 * n + 2] = fmaf(acc[4 * n + 2], corr1, frag[4 * n + 2]);
        acc[4 * n + 3] = fmaf(acc[4 * n + 3], corr1, frag[4 * n + 3]);
      }
    }
  }
  finish_rows(o, son, lse, acc, r0, lq, 0, m0, m1, l0, l1);
}

// The kernel's shared-memory limit for lk keys (its tile list grows with
// them), raised once a device and size.
template <int NP>
int prepare(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = Cfg<NP>::bytes((lk + Cfg<NP>::BN - 1) / Cfg<NP>::BN);
  return raise_smem(flash_memattn_h_kernel<NP>, *smem, smem_set);
}

template <int NP>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb,
           const void* key_bias, const void* q, void* o, void* lse, int B, int H, int lq, int lk,
           int lkb, float sm_scale, long long sqb, long long sqh, long long sqn, long long sob,
           long long soh, long long son, cudaStream_t st) {
  using T = typename Cfg<NP>::T;
  int smem = 0;
  const int err = prepare<NP>(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + BM - 1) / BM, B * H);
  flash_memattn_h_kernel<NP><<<grid, NTH, smem, st>>>(
      tk, tv, tb, static_cast<const float*>(key_bias), static_cast<const T*>(q),
      static_cast<T*>(o), static_cast<float*>(lse), B, H, lq, lk, lkb, sm_scale, sqb, sqh, sqn,
      sob, soh, son);
  return static_cast<int>(cudaGetLastError());
}

bool bad_bias(int lq, int lk, int lkb, const void* key_bias) {
  return lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
         reinterpret_cast<uintptr_t>(key_bias) % 16 != 0;
}

}  // namespace

// bf16. q (B, H, Lq, 256), k (B, H, Lk, 256), v (B, H, Lk, 64) with (batch,
// head, row) element strides, each a multiple of 8 and the bases 16-byte
// aligned; key_bias (B, lkb) f32 contiguous and 16-byte aligned, lkb >= Lk
// a multiple of 4, columns past Lk at -1e9; o (B, H, Lq, 64) by strides;
// lse (B, H, Lq) f32 or null. Returns a CUDA error, 1000 + the CUresult if
// a tensor map is refused, or 999 when cuTensorMapEncodeTiled cannot be
// found.
extern "C" int flash_memattn_h_fwd(const void* q, const void* k, const void* v,
                                   const void* key_bias, void* o, void* lse, int B, int H, int lq,
                                   int lk, int lkb, float sm_scale, long long sqb, long long sqh,
                                   long long sqn, long long skb, long long skh, long long skn,
                                   long long svb, long long svh, long long svn, long long sob,
                                   long long soh, long long son, void* stream) {
  if (bad_bias(lq, lk, lkb, key_bias)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv, tb;
  CUresult r = map_heads(fn, &tk, k, DK, lk, H, B, skb, skh, skn, Cfg<1>::BN);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, DV, lk, H, B, svb, svh, svn, Cfg<1>::BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, Cfg<1>::BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return launch<1>(tk, tv, tb, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb, sqh, sqn,
                   sob, soh, son, static_cast<cudaStream_t>(stream));
}

// fp32. q (B, H, Lq, 256) f32 with (batch, head, row) element strides,
// each a multiple of 2 and the base 8-byte aligned; kp, vp the split
// copies of k and v (flash_sdpa_split_parts with tile 32, the key tile
// here: (2 B, H, Lk, 256) and (2 B, H, Lk, 64) bf16, the rows of live
// tiles written); key_bias as above; o f32 by strides; lse as above.
extern "C" int flash_memattn_h_f32_fwd(const void* q, const void* kp, const void* vp,
                                       const void* key_bias, void* o, void* lse, int B, int H,
                                       int lq, int lk, int lkb, float sm_scale, long long sqb,
                                       long long sqh, long long sqn, long long sob,
                                       long long soh, long long son, void* stream) {
  if (bad_bias(lq, lk, lkb, key_bias)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap tk, tv, tb;
  CUresult r = map_parts(fn, &tk, kp, DK, lk, H, B, Cfg<2>::BN);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, vp, DV, lk, H, B, Cfg<2>::BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, Cfg<2>::BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return launch<2>(tk, tv, tb, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb, sqh, sqn,
                   sob, soh, son, static_cast<cudaStream_t>(stream));
}

// The kernel's resources (wgmma_common.cuh kernel_attrs) in bf16 (fp32 =
// 0) or fp32 at lk keys: out = {registers, spilled bytes a thread, shared
// bytes a block, blocks an SM}.
extern "C" int flash_memattn_h_attrs(int fp32, int lk, int* out) {
  int smem = 0, err = 0;
  if (fp32 == 0 && (err = prepare<1>(lk, &smem)) == 0)
    return kernel_attrs(flash_memattn_h_kernel<1>, NTH, smem, out);
  if (fp32 != 0 && (err = prepare<2>(lk, &smem)) == 0)
    return kernel_attrs(flash_memattn_h_kernel<2>, NTH, smem, out);
  return err;
}
