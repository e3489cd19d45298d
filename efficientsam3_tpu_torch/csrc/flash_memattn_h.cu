// Flash cross-attention over the tracker's cached memory bank, raw values
// narrower than the keys, for Hopper (sm_90a): wgmma, TMA and a
// warp-specialised pipeline, bf16 operands and fp32 operands on split bf16
// parts, over bf16 / fp32 keys or over int8 keys (one template over the
// parts and the key type; the int8 instantiation is described at the end).
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
// step and read it from L2. What held the mma.sync kernel before it (the
// former flash_qsmem.cuh, 1.9945 ms at 3 live slots against a bound of
// 0.3652): Q's fragments re-read from shared memory by every warp at every key
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
//
// Over int8 keys (flash_memattn_q8_h_kernel) it replaces `flash_memattn_q8`
// (`_memattn_kernel_q8` :589 and `_memattn_kernel_q8_lse` :647, their
// pallas_calls at :763 and :739): the tracker's opt-in quantize_bank
// serving mode, 4 launches a tracked frame. The bank's keys arrive
// quantized per row (quantize_rows: int8 values and an f32 scale a key);
// q is quantized per row here, with the softmax scale folded into its
// scale: fp32 |max| floored at 1e-8, an IEEE division by |max| / 127,
// values rounded half to even, which are quantize_rows(q, sm_scale)'s int8
// values and scales bit for bit. S is an int8 x int8 -> int32 product and
// logit = float(s) * k_scale[key] * q_scale[row], a key whose bias is <=
// -5e8 masked (the bias is a mask here, as in the JAX kernel, which
// carried it on the key scale); from the logits on it is the exact bank's
// function above (fp32 online softmax, P rounded to the value dtype for
// P V, the denominator from the unrounded P, the LSE, 0 and -1e9 for a row
// with no live key).
//  - the product: wgmma.mma_async m64n64k32.s32.s8.s8. wgmma takes 8-bit
//    operands K-major only, and Q K^T has both so. The PTX ISA allows A
//    from registers for .s8 / .u8 at k32 (CUTLASS's RS_TN int8 atoms use
//    it), so q is quantized in the prologue straight into A fragments: 32
//    registers a thread for the group's 64 x 256 int8 rows, half of bf16's
//    64. A row's 256 values lie across its quad, so its |max| takes two
//    shuffles; q is read twice (|max|, then the values);
//  - the int8 K tile: 64 keys of 256 bytes, two 128-column slabs at the
//    128-byte swizzle (TileI8): a k-step of 32 int8 is 32 bytes, the
//    descriptors of the bf16 d = 256 tile in bytes. Its TMA map is UINT8
//    (the driver has no signed 8-bit type; TMA copies bytes);
//  - the s32 accumulator has the f32 one's thread layout: after a convert
//    and the two scales (q's times sm_scale log2(e) per row, k's per column
//    from the stage) the softmax and P-as-A-operand code above carry over;
//  - a stage: the K tile (16 KB), V (8 KB a part) and the tile's 64 key
//    scales and 64 biases (TMA rows, as the biases); seven stages in bf16
//    (24.5 KB each), six in fp32 (v split: 32.5 KB), 64-key tiles in both;
//  - fp32: q quantized from fp32 the same way; only v needs parts: one
//    split pass skipping dead 64-key tiles (flash_sdpa_split_parts, tile
//    64), P V as above from a fresh fragment added into O by FMAs.
// Bound at the tracker shape per live slot (7 entries, 36288 live keys):
// 96 G int8 operations (0.049 ms at the int8 peak), 24 GFLOP of P V
// (0.024 ms) beside 188 M exponentials (0.051 ms on the special-function
// units), 9.4 MB of int8 keys: with the product twice as fast, the
// exponentials and P V weigh as much as Q K^T, so the two consumer groups'
// ping-pong carries more of the time than in the exact bank. What held
// the mma.sync kernel before it (the former flash_memattn_q8.cu, 1.7858 ms
// at 3 live slots, bound 0.2190): 4 warps and 64 queries a block,
// mma.m16n8k32.s8 fed by 32-bit shared-memory loads, two cp.async stages.
// As built (ptxas): 168 registers at launch, 240 a consumer thread, no
// spills, one block an SM. Measured (bench_vit_attn.py --q8, NVIDIA H100
// 80GB HBM3, 700 W, in turns with that kernel; ms in a CUDA graph): bf16
// 0.6855 / 0.6858 at 3 live slots x 7 entries (1.7933 / 1.7914), 0.6799 /
// 0.6883 at 1 (0.9412 / 0.9036), 2.0286 / 2.0519 at 8 (3.0065 / 3.0023),
// each a little below the exact bank on the dequantized keys (0.7077 /
// 0.7078 / 2.0990 in the same runs); fp32 at 1 entry 0.1862 / 0.1825 with
// v's split pass (0.3258 / 0.3321), at 7 entries 0.9552 / 0.9511 (the
// mma.sync kernel missed 1e-4 there: 1.39e-4). The int8 product did not
// buy what its rate promised: Q K^T at twice the bf16 rate left the time
// where the exact bank's is. Tried and not kept, in turns with this
// design: the int32 scores converted by an integer add on the FMA pipe
// instead of the conversion unit (0.6850 / 0.6869 against 0.6867 /
// 0.6817), the two groups issuing Q K^T in any order (0.7467 / 0.7503
// against 0.6841 / 0.6872), 128-key tiles in four stages (0.6967 / 0.6903
// against 0.6820 / 0.6848), four stages of 64 keys (0.6965 / 0.6938 against
// 0.6954 / 0.6867), each block starting its walk at its own share of the
// tile list (0.7171 / 0.7156 against 0.6867 / 0.6827: the 41 blocks of a
// slot reading the same tile at a time share it in the L2). So neither the
// product, the conversion, the per-tile barriers nor the stage ring holds
// it; each group's chain of S, softmax and P V within a tile is the likely
// limit (not measured: no per-pipe counters on this card's machine).

#include <type_traits>

#include "wgmma_common.cuh"

using namespace wgmma;

namespace {

constexpr int DK = 256, DV = 64;
constexpr int BM = 128;                 // queries a block
constexpr int NCONS = 256, NTH = NCONS + 128;  // two consumer warpgroups and a producer one
constexpr int PROD_REGS = 24, CONS_REGS = 240;
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <= 65536, "register pool");

// NP parts an operand: 1 for bf16, 2 for fp32 (split hi / lo); Q8: int8
// keys with a scale a key (flash_memattn_q8), whose keys are one part at
// either dtype and whose q is quantized in the prologue. Shared memory from
// a 1024-aligned base.
template <int NP, bool Q8>
struct Cfg {
  using T = std::conditional_t<NP == 1, bf16, float>;
  static constexpr int BN = NP == 1 || Q8 ? 64 : 32;  // keys a tile
  static constexpr int NSTAGE = Q8 ? (NP == 1 ? 7 : 6) : (NP == 1 ? 5 : 3);
  using TK = std::conditional_t<Q8, TileI8<DK, BN>, Tile<DK, BN>>;  // one part of a K tile
  using TV = Tile<DV, BN>;  // one part of a V tile
  using TQ = Tile<DK, 64>;  // a group's Q lo (fp32, exact keys)
  static constexpr int NKP = Q8 ? 1 : NP;        // parts of a K tile
  static constexpr bool QLO = NP == 2 && !Q8;    // Q lo tiles in shared memory
  static constexpr int K_HI = 0, K_LO = TK::BYTES;  // within a stage: K parts, then V parts
  static constexpr int V_HI = NKP * TK::BYTES, V_LO = V_HI + TV::BYTES;
  static constexpr int STAGE = NKP * TK::BYTES + NP * TV::BYTES;
  static constexpr int OFF_S = 0;                                       // [NSTAGE] stages
  static constexpr int OFF_QLO = OFF_S + NSTAGE * STAGE;                // [2] groups' Q lo
  static constexpr int OFF_BIAS = OFF_QLO + (QLO ? 2 * TQ::BYTES : 0);  // [NSTAGE][BN] f32
  static constexpr int OFF_KS = OFF_BIAS + NSTAGE * BN * 4;  // [NSTAGE][BN] f32 key scales (Q8)
  static constexpr int OFF_BAR = OFF_KS + (Q8 ? NSTAGE * BN * 4 : 0);  // full[], empty[]
  static constexpr int OFF_NLIVE = OFF_BAR + 2 * NSTAGE * 8;
  static constexpr int OFF_LIVE = (OFF_NLIVE + 4 + 15) / 16 * 16;      // a byte a tile, the list
  static constexpr int STAGE_TX = STAGE + (Q8 ? 2 : 1) * BN * 4;
  static_assert(STAGE % 1024 == 0 && TK::BYTES % 1024 == 0, "slabs on 1024-byte boundaries");
  static int bytes(int ntiles) {
    return 1024 + OFF_LIVE + (ntiles + 15) / 16 * 16 + (2 * ntiles + 15) / 16 * 16;
  }
};

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float amax4(float4 x) {
  return fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
}

// x / s rounded half to even (IEEE division), four int8 in a register, the
// first value in the low byte.
__device__ __forceinline__ uint32_t pack4_s8(float4 x, float s) {
  const int i0 = __float2int_rn(__fdiv_rn(x.x, s)), i1 = __float2int_rn(__fdiv_rn(x.y, s));
  const int i2 = __float2int_rn(__fdiv_rn(x.z, s)), i3 = __float2int_rn(__fdiv_rn(x.w, s));
  return (uint32_t)(i0 & 0xff) | ((uint32_t)(i1 & 0xff) << 8) | ((uint32_t)(i2 & 0xff) << 16) |
         ((uint32_t)(i3 & 0xff) << 24);
}

// Q rows r0, r0 + 8 (those below lq; the others zeros) quantized per row as
// the int8 A operand of DK / 32 k-steps of 32 columns (wgmma_s8_rs: {row
// r0, cols 4t..}, {r0 + 8, 4t..}, {r0, 16 + 4t..}, {r0 + 8, 16 + 4t..}):
// scale s = max(|x|, 1e-8) / 127 and values x / s rounded half to even,
// both IEEE, which are quantize_rows' int8 values and scales bit for bit.
// A row's 256 values lie across its quad, 64 a thread, so its |max| takes
// two shuffles. q is read twice (|max|, then the values) rather than held.
template <typename T>
__device__ __forceinline__ void quantize_q(const T* q, long long sqn, int r0, int lq,
                                           uint32_t (&qa)[DK / 32][4], float& s0, float& s1) {
  const int t = threadIdx.x & 3;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK / 32; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), c = 32 * kk + 16 * (e >> 1) + 4 * t;
      if (row < lq) {
        const float m = amax4(load4(q + row * sqn + c));
        if (e & 1) a1 = fmaxf(a1, m);
        else a0 = fmaxf(a0, m);
      }
    }
  a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, 1));
  a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, 2));
  a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, 1));
  a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, 2));
  s0 = __fdiv_rn(fmaxf(a0, 1e-8f), 127.f);
  s1 = __fdiv_rn(fmaxf(a1, 1e-8f), 127.f);
#pragma unroll
  for (int kk = 0; kk < DK / 32; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), c = 32 * kk + 16 * (e >> 1) + 4 * t;
      const float4 x = row < lq ? load4(q + row * sqn + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      qa[kk][e] = pack4_s8(x, (e & 1) ? s1 : s0);
    }
}

// The int8 scores of a tile (64 queries x 8 NJ keys, int32) as logits in
// log2 units: float(s) * k_scale * (q_scale * sm_scale * log2(e)) with the
// tile's key scales at ks and biases at bs; a masked key (bias <= -5e8) at
// -1e9 log2(e), its scale never read into the product.
template <int NJ>
__device__ __forceinline__ void q8_logits(const int (&si)[4 * NJ], float (&sc)[4 * NJ],
                                          const float* bs, const float* ks, float qs0, float qs1) {
  const int t = threadIdx.x & 3;
  constexpr float DEAD_KEY = NEG_INF * LOG2E;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 8 + 2 * t;
    const float2 bv = *reinterpret_cast<const float2*>(bs + c);
    const float2 kv = *reinterpret_cast<const float2*>(ks + c);
    const bool v0 = bv.x > 0.5f * NEG_INF, v1 = bv.y > 0.5f * NEG_INF;
    sc[4 * j + 0] = v0 ? static_cast<float>(si[4 * j + 0]) * kv.x * qs0 : DEAD_KEY;
    sc[4 * j + 1] = v1 ? static_cast<float>(si[4 * j + 1]) * kv.y * qs0 : DEAD_KEY;
    sc[4 * j + 2] = v0 ? static_cast<float>(si[4 * j + 2]) * kv.x * qs1 : DEAD_KEY;
    sc[4 * j + 3] = v1 ? static_cast<float>(si[4 * j + 3]) * kv.y * qs1 : DEAD_KEY;
  }
}

// The kernel's body; the two kernels below are its exact-key and int8-key
// instantiations (tm_ks, the key scales' map, is read only by the second).
template <int NP, bool Q8>
__device__ __forceinline__ void memattn_body(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                             const CUtensorMap& tm_bias, const CUtensorMap& tm_ks,
                                             const float* __restrict__ key_bias,
                                             const typename Cfg<NP, Q8>::T* __restrict__ q,
                                             typename Cfg<NP, Q8>::T* __restrict__ o,
                                             float* __restrict__ lse, int B, int H, int lq, int lk,
                                             int lkb, float sm_scale, long long sqb, long long sqh,
                                             long long sqn, long long sob, long long soh,
                                             long long son) {
  using C = Cfg<NP, Q8>;
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
        if constexpr (C::NKP == 2)  // the split copy: hi at batch b, lo at b + B
          TK::load(st + C::K_LO, &tm_k, full, key0, h, b + B);
        if constexpr (NP == 2) TV::load(st + C::V_LO, &tm_v, full, key0, h, b + B);
        tma_load_2d(s_base + C::OFF_BIAS + s * BN * 4, &tm_bias, full, key0, b);
        if constexpr (Q8) tma_load_2d(s_base + C::OFF_KS + s * BN * 4, &tm_ks, full, key0, b);
      });
    return;
  }

  // ---------------- two consumer warpgroups, 64 queries each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  // Q rows r0, r1 as the A operand of the k-steps of Q K^T. Exact keys: 16
  // k-steps of 16 columns ({row g, cols 2t..}, {g + 8, 2t..}, {g, 2t + 8..},
  // {g + 8, 2t + 8..}), at fp32 the hi part, the lo part at the same places
  // of the group's Q lo tile. int8 keys: 8 k-steps of 32 int8 columns,
  // quantized here, and the rows' scales times sm_scale log2(e)
  constexpr int QK = Q8 ? DK / 32 : DK / 16;
  uint32_t qa[QK][4];
  float qs0 = 0.f, qs1 = 0.f;
  const uint32_t ql = s_base + C::OFF_QLO + wg * TQ::BYTES;
  if constexpr (Q8) {
    quantize_q(q, sqn, r0, lq, qa, qs0, qs1);
    qs0 = qs0 * sm_scale * LOG2E;
    qs1 = qs1 * sm_scale * LOG2E;
  } else {
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
  }
  if constexpr (C::QLO) {
    fence_proxy_async();
    named_sync<128>(3 + wg);  // the group's Q lo tile written before its wgmma reads it
  }

  const float scale2 = sm_scale * LOG2E;
  const float* bias_s = reinterpret_cast<const float*>(smem + C::OFF_BIAS);
  const float* ks_s = reinterpret_cast<const float*>(smem + C::OFF_KS);
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

    // S = Q K^T (exact keys at fp32 on parts; int8 keys in int32), this
    // group's turn on the tensor cores
    float sc[BN / 2];
    int si[Q8 ? BN / 2 : 1];
    named_sync<NCONS>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      const uint64_t khd = TK::desc_k(st + C::K_HI, kk);
      if constexpr (Q8) {
        wgmma_s8_rs(si, qa[kk], khd, kk > 0);
      } else {
        wgmma_rs<0>(sc, qa[kk], khd, kk > 0);
        if constexpr (NP == 2) {
          wgmma_rs<0>(sc, qa[kk], TK::desc_k(st + C::K_LO, kk));
          wgmma_m64n32k16_ss(sc, TQ::desc_k(ql, kk), khd, 1);
        }
      }
    }
    wgmma_commit();
    if (wg == 0 || i + 1 < nlive) named_arrive<NCONS>(2 - wg);  // the other group's turn
    wgmma_wait0();
    if constexpr (Q8) {
      fence_regs(si);
      q8_logits<BN / 8>(si, sc, bias_s + s * BN, ks_s + s * BN, qs0, qs1);
    } else {
      fence_regs(sc);
    }

    float corr0, corr1;
    if constexpr (NP == 1) {
      // O = O * corr + bf16(P) V, P from registers, V an MN-major operand
      uint32_t pa[BN / 16][4];
      if constexpr (Q8)
        softmax_logits<BN / 8>(sc, m0, m1, l0, l1, corr0, corr1, pack_emit<BN / 8>(pa));
      else
        softmax_pack<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0,
                             corr1, pa);
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
      if constexpr (Q8)
        softmax_logits<BN / 8>(sc, m0, m1, l0, l1, corr0, corr1, split_emit<BN / 8>(ph, pl));
      else
        softmax_split<BN / 8>(sc, bias_s + s * BN, key0, lk, scale2, m0, m1, l0, l1, corr0,
                              corr1, ph, pl);
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

// The kernels' parameters: the maps of K (or its split copy, or the int8
// keys), V (or its split copy), the key-bias rows and, for int8 keys, the
// key-scale rows (the exact-key kernel is handed the bias map there).
#define MEMATTN_PARAMS(NP, Q8)                                                                \
  const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,        \
      const __grid_constant__ CUtensorMap tm_bias, const __grid_constant__ CUtensorMap tm_ks, \
      const float* __restrict__ key_bias, const typename Cfg<NP, Q8>::T* __restrict__ q,      \
      typename Cfg<NP, Q8>::T* __restrict__ o, float* __restrict__ lse, int B, int H, int lq, \
      int lk, int lkb, float sm_scale, long long sqb, long long sqh, long long sqn,           \
      long long sob, long long soh, long long son
#define MEMATTN_ARGS                                                                     \
  tm_k, tm_v, tm_bias, tm_ks, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb, sqh, \
      sqn, sob, soh, son

template <int NP>
__global__ void __launch_bounds__(NTH, 1) flash_memattn_h_kernel(MEMATTN_PARAMS(NP, false)) {
  memattn_body<NP, false>(MEMATTN_ARGS);
}

template <int NP>
__global__ void __launch_bounds__(NTH, 1) flash_memattn_q8_h_kernel(MEMATTN_PARAMS(NP, true)) {
  memattn_body<NP, true>(MEMATTN_ARGS);
}

template <int NP, bool Q8>
auto kernel_of() {
  if constexpr (Q8) return flash_memattn_q8_h_kernel<NP>;
  else return flash_memattn_h_kernel<NP>;
}

// The kernel's shared-memory limit for lk keys (its tile list grows with
// them), raised once a device and size.
template <int NP, bool Q8>
int prepare(int lk, int* smem) {
  static int smem_set[64] = {};
  *smem = Cfg<NP, Q8>::bytes((lk + Cfg<NP, Q8>::BN - 1) / Cfg<NP, Q8>::BN);
  return raise_smem(kernel_of<NP, Q8>(), *smem, smem_set);
}

template <int NP, bool Q8>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tb,
           const CUtensorMap& ts, const void* key_bias, const void* q, void* o, void* lse, int B,
           int H, int lq, int lk, int lkb, float sm_scale, long long sqb, long long sqh,
           long long sqn, long long sob, long long soh, long long son, cudaStream_t st) {
  using T = typename Cfg<NP, Q8>::T;
  int smem = 0;
  const int err = prepare<NP, Q8>(lk, &smem);
  if (err != 0) return err;
  const dim3 grid((lq + BM - 1) / BM, B * H);
#define MEMATTN_LAUNCH(KERNEL)                                                               \
  KERNEL<NP><<<grid, NTH, smem, st>>>(tk, tv, tb, ts, static_cast<const float*>(key_bias),    \
                                      static_cast<const T*>(q), static_cast<T*>(o),           \
                                      static_cast<float*>(lse), B, H, lq, lk, lkb, sm_scale,  \
                                      sqb, sqh, sqn, sob, soh, son)
  if constexpr (Q8) MEMATTN_LAUNCH(flash_memattn_q8_h_kernel);
  else MEMATTN_LAUNCH(flash_memattn_h_kernel);
#undef MEMATTN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

bool bad_bias(int lq, int lk, int lkb, const void* key_bias) {
  return lkb % 4 != 0 || lkb < lk || lq <= 0 || lk <= 0 ||
         reinterpret_cast<uintptr_t>(key_bias) % 16 != 0;
}

// What the int8 entries take beyond bad_bias: Lk a multiple of the 64-key
// tile (a padded bank), the key-scale rows as the key-bias rows.
bool bad_q8(int lq, int lk, int lkb, const void* key_bias, const void* k_scale) {
  return bad_bias(lq, lk, lkb, key_bias) || lk % 64 != 0 ||
         reinterpret_cast<uintptr_t>(k_scale) % 16 != 0;
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
  constexpr int BN = Cfg<1, false>::BN;
  CUtensorMap tk, tv, tb;
  CUresult r = map_heads(fn, &tk, k, DK, lk, H, B, skb, skh, skn, BN);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, DV, lk, H, B, svb, svh, svn, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return launch<1, false>(tk, tv, tb, tb, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb,
                          sqh, sqn, sob, soh, son, static_cast<cudaStream_t>(stream));
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
  constexpr int BN = Cfg<2, false>::BN;
  CUtensorMap tk, tv, tb;
  CUresult r = map_parts(fn, &tk, kp, DK, lk, H, B, BN);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, vp, DV, lk, H, B, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return launch<2, false>(tk, tv, tb, tb, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb,
                          sqh, sqn, sob, soh, son, static_cast<cudaStream_t>(stream));
}

// int8 keys, bf16 q, v and o (flash_memattn_q8). k (B, H, Lk, 256) int8
// with (batch, head, row) strides in bytes, each a multiple of 16 and the
// base 16-byte aligned, Lk a multiple of 64; k_scale (B, lkb) f32 laid out
// as key_bias (padded columns ignored); q, v, key_bias, o and lse as
// flash_memattn_h_fwd's.
extern "C" int flash_memattn_q8_h_fwd(const void* q, const void* k, const void* k_scale,
                                      const void* v, const void* key_bias, void* o, void* lse,
                                      int B, int H, int lq, int lk, int lkb, float sm_scale,
                                      long long sqb, long long sqh, long long sqn, long long skb,
                                      long long skh, long long skn, long long svb, long long svh,
                                      long long svn, long long sob, long long soh, long long son,
                                      void* stream) {
  if (bad_q8(lq, lk, lkb, key_bias, k_scale)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  constexpr int BN = Cfg<1, true>::BN;
  CUtensorMap tk, tv, tb, ts;
  CUresult r = map_heads_i8(fn, &tk, k, DK, lk, H, B, skb, skh, skn, BN);
  if (r == CUDA_SUCCESS) r = map_heads(fn, &tv, v, DV, lk, H, B, svb, svh, svn, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &ts, k_scale, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return launch<1, true>(tk, tv, tb, ts, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb,
                         sqh, sqn, sob, soh, son, static_cast<cudaStream_t>(stream));
}

// int8 keys, fp32 q and o: q as flash_memattn_h_f32_fwd's, k and k_scale as
// flash_memattn_q8_h_fwd's, vp the split copy of v (flash_sdpa_split_parts
// with tile 64, the key tile here: (2 B, H, Lk, 64) bf16, the rows of live
// tiles written).
extern "C" int flash_memattn_q8_h_f32_fwd(const void* q, const void* k, const void* k_scale,
                                          const void* vp, const void* key_bias, void* o,
                                          void* lse, int B, int H, int lq, int lk, int lkb,
                                          float sm_scale, long long sqb, long long sqh,
                                          long long sqn, long long skb, long long skh,
                                          long long skn, long long sob, long long soh,
                                          long long son, void* stream) {
  if (bad_q8(lq, lk, lkb, key_bias, k_scale)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  constexpr int BN = Cfg<2, true>::BN;
  CUtensorMap tk, tv, tb, ts;
  CUresult r = map_heads_i8(fn, &tk, k, DK, lk, H, B, skb, skh, skn, BN);
  if (r == CUDA_SUCCESS) r = map_parts(fn, &tv, vp, DV, lk, H, B, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &tb, key_bias, lkb, B, BN);
  if (r == CUDA_SUCCESS) r = map_rows_f32(fn, &ts, k_scale, lkb, B, BN);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  return launch<2, true>(tk, tv, tb, ts, key_bias, q, o, lse, B, H, lq, lk, lkb, sm_scale, sqb,
                         sqh, sqn, sob, soh, son, static_cast<cudaStream_t>(stream));
}

// The kernels' resources (wgmma_common.cuh kernel_attrs) in bf16 (fp32 =
// 0) or fp32 at lk keys, over exact keys or (the _q8 query) int8 keys: out
// = {registers, spilled bytes a thread, shared bytes a block, blocks an
// SM}.
template <bool Q8>
int attrs(int fp32, int lk, int* out) {
  int smem = 0, err = 0;
  if (fp32 == 0 && (err = prepare<1, Q8>(lk, &smem)) == 0)
    return kernel_attrs(kernel_of<1, Q8>(), NTH, smem, out);
  if (fp32 != 0 && (err = prepare<2, Q8>(lk, &smem)) == 0)
    return kernel_attrs(kernel_of<2, Q8>(), NTH, smem, out);
  return err;
}

extern "C" int flash_memattn_h_attrs(int fp32, int lk, int* out) {
  return attrs<false>(fp32, lk, out);
}

extern "C" int flash_memattn_q8_h_attrs(int fp32, int lk, int* out) {
  return attrs<true>(fp32, lk, out);
}
