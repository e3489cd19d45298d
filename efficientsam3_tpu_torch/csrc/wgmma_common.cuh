// Shared pieces of the warp-specialised Hopper attention kernels
// (flash_sdpa_h.cu: the bf16 forward at d = 32, 64, 80 and 256;
// flash_sdpa_h_fp32.cu: the forward at d = 32, 64, 80 and 256 on fp32
// operands; flash_memattn_h.cu: the tracker's bank attention in bf16 and
// fp32, over bf16 / fp32 keys and over int8 keys (flash_memattn_q8);
// flash_sdpa_bwd_h.cu: the bf16 dK / dV backward at d = 32, 64 and 80;
// flash_sdpa_bwd_dq_h.cu: the bf16 dQ backward at d = 32, 64 and 80;
// flash_sdpa_bwd_h_fp32.cu and flash_sdpa_bwd_dq_h_fp32.cu: the dK / dV and
// the dQ backward at d = 32, 64 and 80 on fp32 operands;
// flash_sdpa_bwd_wide_h.cu: the bf16 dQ and dK / dV backward at d = 256;
// flash_sdpa_bwd_wide_h_fp32.cu: the same at d = 256 on fp32 operands;
// flash_xattn_rpb.cu: the decoder's boxRPB cross-attention in bf16 and
// fp32): mbarriers, TMA loads, wgmma shared memory descriptors and
// instructions, named barriers, thread-block cluster barriers and reads of
// a partner block's shared memory, the exchanges between consumer
// warpgroups, the live-tile list, and on the host the tensor maps, encoded
// through cudaGetDriverEntryPoint (no -lcuda).
//
// Layouts. A (rows x D) bf16 tile is loaded by TMA in slabs of slab_cols(D)
// columns, each slab a box whose rows carry the swizzle of their width:
// one slab at d = 32 and 64 (rows of 64 and 128 bytes), four 64-column
// slabs with the 128-byte swizzle at d = 256, and five 16-column slabs with
// the 32-byte swizzle at d = 80, slab j at j * rows * (row bytes). The
// 160-byte rows of d = 80 have no swizzle of their own: two 64-column slabs
// would carry 48 columns of zeros (256 bytes a row, one forward block an
// SM), and a 64 + 16 split would need two tensor maps an operand and two
// products for P V; five 32-byte slabs waste nothing, keep one map, and
// make N = 80 five whole swizzle atoms (CUTLASS's choice for such an N).
// Each 8-row group of a slab is one swizzle atom (256, 512 or 1024 bytes)
// and every slab starts on a 1024-byte boundary. wgmma reads such a tile
// (Tile below):
//  - K-major (the contraction along the row: Q, K, V, dO as QK^T-type
//    operands): stride byte offset = 8 rows, a k-step of 16 columns is 32
//    bytes along the row, and a slab holds (row bytes) / 32 k-steps before
//    the next slab (the leading byte offset is not read);
//  - MN-major (the contraction across rows: V in P V, dO in P^T dO, Q in
//    dS^T Q, K in dS K; the transpose bit): stride byte offset = 8 rows, a
//    k-step of 16 rows is 16 rows' bytes. The N extent is the columns: one
//    swizzle atom wide at d <= 64, where the leading byte offset is not
//    read; at d = 80 and 256 N spans the slabs, and the leading byte offset
//    is the slab stride, the step from one atom to the next along N
//    (desc_mn_wide at d = 256).
//
// Split parts (fp32 operands). wgmma multiplies bf16, so an fp32 operand x
// goes in as two bf16 parts, hi = bf16(x) (round to nearest even) and lo =
// bf16(x - hi) (split_pair), and a product a b as hi_a hi_b + hi_a lo_b +
// lo_a hi_b into one fp32 accumulator (lo_a lo_b, ~2^-16 of the product,
// is dropped). A part is an ordinary bf16 tile: TMA loads it
// from a split copy, or a kernel writes it into shared memory itself in
// the swizzle TMA would give it (swz128 at d = 256, Tile::at at d <= 80,
// then fence_proxy_async before wgmma reads it).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e9f;  // the JAX kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
// Shared-memory matrix descriptor of a tile whose rows are ROW bytes and
// carry the swizzle of that width: start address, leading and stride byte
// offsets (16-byte units), layout type (1: 128-byte, 2: 64-byte, 3: 32-byte
// swizzle).
template <int ROW>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "rows of 32, 64 or 128 bytes");
  constexpr uint64_t layout = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// K-major operand: k-step kk (16 columns) of the tile at saddr.
template <int ROW>
__device__ __forceinline__ uint64_t desc_k(uint32_t saddr, int kk) {
  return make_desc<ROW>(saddr + kk * 32, 16, 8 * ROW);
}
// MN-major operand (transpose bit): k-step kk (16 rows) of the tile at saddr.
template <int ROW>
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr, int kk) {
  return make_desc<ROW>(saddr + kk * 16 * ROW, 16 * ROW, 8 * ROW);
}

// MN-major operand N columns wide over 64-column slabs `slab` bytes apart
// (128-byte swizzle): k-step kk (16 rows) of the tile at saddr, the
// leading byte offset the slab stride.
__device__ __forceinline__ uint64_t desc_mn_wide(uint32_t saddr, int kk, uint32_t slab) {
  return make_desc<128>(saddr + kk * 16 * 128, slab, 8 * 128);
}

// Offset, in the descriptor's 16-byte units, of k-step kk (16 columns) of a
// K-major d = 256 tile whose 64-column slabs are SLAB bytes apart (128-byte
// swizzle): a slab every four k-steps. Added to the first k-step's
// descriptor: the start address field does not carry, as shared addresses
// stay under 2^18.
template <int SLAB>
__device__ __forceinline__ uint64_t kstep_off(int kk) {
  return static_cast<uint64_t>(((kk >> 2) * SLAB + (kk & 3) * 32) >> 4);
}

// Columns a slab of a d-wide bf16 tile holds (the Layouts note): d itself
// up to 64, 64 at d = 256, 16 at d = 80.
__host__ __device__ constexpr int slab_cols(int d) {
  return d <= 64 ? d : d % 64 == 0 ? 64 : 16;
}

// Byte offset of byte `byte` (0 .. ROW - 1) of row `row` in a slab of
// ROW-byte rows with the swizzle of that width, as TMA writes it
// (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B; the slab 1024-byte aligned): the
// 16-byte chunk index XOR address bits 7 and up (the row's place among the
// 128-byte lines of its swizzle atom: row at 128, row / 2 at 64, row / 4 at
// 32), over ROW / 16 chunks.
template <int ROW>
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "rows of 32, 64 or 128 bytes");
  return row * ROW + ((((byte >> 4) ^ (row * ROW >> 7)) & (ROW / 16 - 1)) << 4) + (byte & 15);
}

// A ROWS x D bf16 tile in slabs: its geometry, its wgmma descriptors, and
// its TMA load from a map_heads map of the same d. At d = 32 and 64 (one
// slab) desc_k and desc_mn are those of the one-slab functions above.
template <int D, int ROWS>
struct Tile {
  static constexpr int COLS = slab_cols(D);
  static constexpr int ROW = 2 * COLS;        // bytes a slab row, and its swizzle
  static constexpr int NSLAB = D / COLS;
  static constexpr int SLAB = ROWS * ROW;     // bytes a slab
  static constexpr int BYTES = NSLAB * SLAB;  // bytes the tile
  static_assert(SLAB % 1024 == 0, "slabs start on 1024-byte boundaries");
  // K-major operand: k-step kk (16 columns) of the rows from saddr (the
  // tile's first slab, or a row offset in it)
  __device__ __forceinline__ static uint64_t desc_k(uint32_t saddr, int kk) {
    constexpr int KPS = ROW / 32;  // k-steps a slab
    return wgmma::desc_k<ROW>(saddr + (kk / KPS) * SLAB, kk % KPS);
  }
  // MN-major operand, N = D columns: k-step kk (16 rows); across the slabs
  // through the leading byte offset
  __device__ __forceinline__ static uint64_t desc_mn(uint32_t saddr, int kk) {
    if constexpr (NSLAB == 1) return wgmma::desc_mn<ROW>(saddr, kk);
    return make_desc<ROW>(saddr + kk * 16 * ROW, SLAB, 8 * ROW);
  }
  // rows row0.. of one (batch, head) into the tile at dst, a box a slab
  __device__ __forceinline__ static void load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row0, int h, int b) {
#pragma unroll
    for (int j = 0; j < NSLAB; ++j) tma_load_4d(dst + j * SLAB, map, bar, j * COLS, row0, h, b);
  }
  // Byte offset of element (row, col) where TMA would put it: a kernel
  // that writes a tile itself (a resident operand's split parts) stores a
  // bf16 pair (col even) as one 32-bit word there
  __device__ __forceinline__ static uint32_t at(int row, int col) {
    return (col / COLS) * SLAB + swz<ROW>(row, (col % COLS) * 2);
  }
};

// A ROWS x D int8 tile (D a multiple of 128: rows of D bytes) in slabs of
// 128 columns at the 128-byte swizzle, slab j at j * ROWS * 128: the bytes
// of a bf16 Tile<D / 2, ROWS>, so a k-step of 32 int8 columns (32 bytes)
// has that tile's K-major descriptors; its TMA load from a map_heads_i8 map.
template <int D, int ROWS>
struct TileI8 {
  static constexpr int ROW = 128, NSLAB = D / 128;
  static constexpr int SLAB = ROWS * ROW;
  static constexpr int BYTES = NSLAB * SLAB;
  static_assert(D % 128 == 0 && SLAB % 1024 == 0, "128-byte slabs on 1024-byte boundaries");
  __device__ __forceinline__ static uint64_t desc_k(uint32_t saddr, int kk) {
    return wgmma::desc_k<ROW>(saddr + (kk / 4) * SLAB, kk % 4);
  }
  __device__ __forceinline__ static void load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row0, int h, int b) {
#pragma unroll
    for (int j = 0; j < NSLAB; ++j) tma_load_4d(dst + j * SLAB, map, bar, j * ROW, row0, h, b);
  }
};

// Byte offset of byte `byte` (0..127) of row `row` in a slab with the
// 128-byte swizzle, as TMA writes it (CU_TENSOR_MAP_SWIZZLE_128B): the
// 16-byte chunk index XOR the row's index within its 8-row atom.
__device__ __forceinline__ uint32_t swz128(int row, int byte) { return swz<128>(row, byte); }

// Order this thread's shared-memory stores before later reads by the async
// proxy (wgmma operands a kernel wrote itself).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64) (+)= A B, both from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) (+)= A B, both from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N) (+)= A B, A (64 x 16) from registers in the accumulator layout
// of a 64-row product (or the same fragment layout loaded from memory), B
// from shared memory: MN-major with the transpose bit (TRANS_B = 1) or
// K-major (0).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// The same at N = 80 (head dim 80: a B operand five 32-byte swizzle atoms
// wide, read through the leading byte offset, Tile<80, ROWS>::desc_mn).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// The same at N = 128 and 256 (head dim 256: a B operand four swizzle atoms
// wide, read through the leading byte offset, desc_mn_wide).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 64) (+)= A B in int32, int8 operands: A (64 x 32) from registers
// (4 registers a thread of 4 bytes each: {row g, cols 4t..4t + 3}, {g + 8,
// 4t..}, {g, 16 + 4t..}, {g + 8, 16 + 4t..} of the warp's 16 rows, the lower
// column in the lower byte, as mma.m16n8k32), B from shared memory K-major
// (the only layout wgmma takes for 8-bit operands; a k-step of 32 bytes, so
// the descriptors of a bf16 tile of the same row bytes). The s32
// accumulator has the f32 one's thread layout.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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

// The fp32 pair (x, y) as packed bf16 parts: hi = bf16(x, y), rounded to
// nearest even, and lo = bf16(x - hi, y - hi) (x - hi is exact in fp32).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Named barriers over N threads (the consumer warpgroups).
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// ---- thread-block clusters
// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster: shared-memory writes before
// it are seen by reads after it in any block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this block's shared address `saddr` in block `rank` of
// the cluster (distributed shared memory), and 8 or 16 bytes read there
// (volatile: not moved across cluster_sync; no memory clobber, so that
// several reads can be in flight at once).
__device__ __forceinline__ uint32_t cluster_addr(uint32_t saddr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// Exchanges between two consumer warpgroups through shared memory, value e
// of thread wt (0..127 in its warpgroup) at buf[e * 128 + wt]: each warp
// reads and writes 128 consecutive bytes, no bank conflicts. The two
// groups' threads wt hold the same fragment positions of their products.
template <int N, typename T>
__device__ __forceinline__ void xchg_put(T* buf, int wt, const T (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) buf[e * 128 + wt] = v[e];
}
template <int N, typename T>
__device__ __forceinline__ void xchg_get(T (&v)[N], const T* buf, int wt) {
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = buf[e * 128 + wt];
}

// The four 64-column slabs (SLAB bytes apart at dst) of rows row0.. of one
// (batch, head) of a d = 256 map.
template <int SLAB>
__device__ __forceinline__ void tma_load_slabs(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int row0, int h, int b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) tma_load_4d(dst + j * SLAB, map, bar, 64 * j, row0, h, b);
}

// The key tiles of TILE keys that hold a live key (key bias > -5e8; the row
// (lkb >= Lk columns, a multiple of 4, 16-byte aligned) is padded with
// -1e9), compacted in order into `list`; `flags` (a byte a tile) is
// scratch. Every thread of the block calls it and gets the count (`count`
// a shared int). Stores of 1 to a flag may race: same value.
template <int TILE, int NTHR>
__device__ __forceinline__ int live_tiles(const float* key_bias, int lkb, int ntiles,
                                          unsigned char* flags, unsigned short* list, int* count) {
  for (int i = threadIdx.x; i < ntiles; i += NTHR) flags[i] = 0;
  __syncthreads();
  const float4* kb4 = reinterpret_cast<const float4*>(key_bias);
  for (int i = threadIdx.x; i < lkb / 4; i += NTHR) {
    const float4 bv = kb4[i];
    if (fmaxf(fmaxf(bv.x, bv.y), fmaxf(bv.z, bv.w)) > 0.5f * NEG_INF) flags[4 * i / TILE] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool lv = i < ntiles && flags[i];
      const unsigned mask = __ballot_sync(0xffffffffu, lv);
      if (lv) list[n + __popc(mask & ((1u << lane) - 1u))] = static_cast<unsigned short>(i);
      n += __popc(mask);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// ---- the steps both d = 256 backward pairs take (flash_sdpa_bwd_wide_h.cu
// in bf16, flash_sdpa_bwd_wide_h_fp32.cu on split parts), on fragments of
// 64 rows x 8 NJ columns in the accumulator layout (value 4 j + e of a
// thread: row r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1))

constexpr float DEAD = -1e30f;  // -lse * log2(e) of a masked or padded query: P = 0

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Zeros into rows row0 .. row0 + ROWS (those below n) of D columns at out,
// row stride sn: the gradients of a block with nothing live.
template <int ROWS, int D, int NTHR, typename T>
__device__ __forceinline__ void zero_rows(T* out, long long sn, int row0, int n) {
  for (int i = threadIdx.x; i < ROWS * D / 2; i += NTHR) {
    const int row = row0 + i / (D / 2), c = 2 * (i % (D / 2));
    if (row < n) store2(out + row * sn + c, 0.f, 0.f);
  }
}

// The output rows q0 .. q0 + ROWS (those below lq) of a forward block whose
// key row has no live key: 0, with lse -1e9 (lse, the (batch, head) row of
// the log-sum-exp, or null).
template <int ROWS, int D, int NTHR, typename T>
__device__ __forceinline__ void dead_rows(T* o, long long son, float* lse, int q0, int lq) {
  zero_rows<ROWS, D, NTHR>(o, son, q0, lq);
  if (lse != nullptr)
    for (int i = threadIdx.x; i < ROWS; i += NTHR)
      if (q0 + i < lq) lse[q0 + i] = NEG_INF;
}

// Whether any of the ROWS keys from key0 is live (below lk, key bias >
// -5e8). A barrier of the whole block (__syncthreads_or), which publishes
// the mbarrier inits made before it. When none is, the block's rows of dk
// and dv are zeroed here and the caller returns.
template <int ROWS, int D, int NTHR, typename T>
__device__ __forceinline__ bool keys_live(const float* key_bias, int key0, int lk, T* dk,
                                          long long skn, T* dv, long long svn) {
  int live = 0;
  if (threadIdx.x < ROWS) {
    const int key = key0 + threadIdx.x;
    live = key < lk && key_bias[key] > 0.5f * NEG_INF;
  }
  if (__syncthreads_or(live)) return true;
  zero_rows<ROWS, D, NTHR>(dk, skn, key0, lk);
  zero_rows<ROWS, D, NTHR>(dv, svn, key0, lk);
  return false;
}

// The producer's loop (one thread): stage i % NSTAGE for i < n, once the
// consumers have freed it, expects `tx` bytes and gets them from load(i,
// stage, its full barrier).
template <int NSTAGE, typename Load>
__device__ __forceinline__ void produce(int n, uint32_t bar_full, uint32_t bar_empty, uint32_t tx,
                                        Load load) {
  for (int i = 0; i < n; ++i) {
    const int s = i % NSTAGE;
    mbar_wait(bar_empty + 8 * s, ((i / NSTAGE) & 1) ^ 1);  // the first round passes
    mbar_expect_tx(bar_full + 8 * s, tx);
    load(i, s, bar_full + 8 * s);
  }
}

// The epilogue of a 64-row accumulator: this thread's rows r0 and r0 + 8
// (those below n) at out, columns col0 + 8 j + 2 t, times mul, as T.
template <int N, typename T>
__device__ __forceinline__ void store_acc(T* out, long long sn, const float (&acc)[N], int r0,
                                          int n, int col0, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = col0 + j * 8 + 2 * t;
    if (r0 < n) store2(out + r0 * sn + c, acc[4 * j + 0] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < n) store2(out + (r0 + 8) * sn + c, acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// A fragment as A operands of NJ / 2 k-steps of 16 (value pair j of rows
// r0 and r0 + 8 is operand (j / 2, 2 (j % 2) + {0, 1})): rounded to bf16,
// or split into hi and lo parts.
template <int NJ>
__device__ __forceinline__ void pack_frags(const float (&x)[4 * NJ], uint32_t (&a)[NJ / 2][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a[j >> 1][(j & 1) * 2 + 0] = pack_bf16(x[4 * j + 0], x[4 * j + 1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}
template <int NJ>
__device__ __forceinline__ void split_frags(const float (&x)[4 * NJ], uint32_t (&hi)[NJ / 2][4],
                                            uint32_t (&lo)[NJ / 2][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split_pair(x[4 * j + 0], x[4 * j + 1], hi[j >> 1][(j & 1) * 2 + 0], lo[j >> 1][(j & 1) * 2 + 0]);
    split_pair(x[4 * j + 2], x[4 * j + 3], hi[j >> 1][(j & 1) * 2 + 1], lo[j >> 1][(j & 1) * 2 + 1]);
  }
}

// The forwards' online-softmax step over one key tile of logits in log2
// units, S (64 queries x 8 NJ keys): the rows' running maxima (m0, m1 of
// rows r0, r0 + 8) moved on, and P = 2^(logit - m) handed to emit(j, p0,
// p1, p2, p3) a value group at a time (rows r0 / r0 + 8, keys 8 j + 2 t,
// + 1) as it is made, so that the caller packs or splits it without
// holding all of P; l0, l1, this thread's partial row sums, are rescaled
// and take the unrounded P; corr0, corr1 are the factors the rows' earlier
// output must be scaled by.
template <int NJ, typename Emit>
__device__ __forceinline__ void softmax_logits(const float (&sc)[4 * NJ], float& m0, float& m1,
                                               float& l0, float& l1, float& corr0, float& corr1,
                                               Emit emit) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  corr0 = ex2(m0 - mx0);
  corr1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float p0 = ex2(sc[4 * j + 0] - mx0), p1 = ex2(sc[4 * j + 1] - mx0);
    const float p2 = ex2(sc[4 * j + 2] - mx1), p3 = ex2(sc[4 * j + 3] - mx1);
    ps0 += p0 + p1;
    ps1 += p2 + p3;
    emit(j, p0, p1, p2, p3);
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
}

// softmax_logits on raw scores S (flash_sdpa_h.cu, flash_sdpa_h_fp32.cu,
// flash_memattn_h.cu's exact bank): logits S scale2 + bias log2 e with the
// tile's key bias at bs, keys from key0 past lk masked.
template <int NJ, typename Emit>
__device__ __forceinline__ void softmax_tile(float (&sc)[4 * NJ], const float* bs, int key0,
                                             int lk, float scale2, float& m0, float& m1,
                                             float& l0, float& l1, float& corr0, float& corr1,
                                             Emit emit) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 8 + 2 * t;
    const float2 bv = *reinterpret_cast<const float2*>(bs + c);
    const float b0 = key0 + c < lk ? bv.x * LOG2E : NEG_INF * LOG2E;
    const float b1 = key0 + c + 1 < lk ? bv.y * LOG2E : NEG_INF * LOG2E;
    sc[4 * j + 0] = fmaf(sc[4 * j + 0], scale2, b0);
    sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, b1);
    sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, b0);
    sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, b1);
  }
  softmax_logits<NJ>(sc, m0, m1, l0, l1, corr0, corr1, emit);
}

// Emitters for softmax_logits / softmax_tile: P rounded to bf16 as the A
// operand of NJ / 2 k-steps of 16 keys (value group j of rows r0 and r0 + 8
// is operand (j / 2, 2 (j % 2) + {0, 1}), as pack_frags), or split into hi
// and lo parts there.
template <int NJ>
__device__ __forceinline__ auto pack_emit(uint32_t (&pa)[NJ / 2][4]) {
  return [&pa](int j, float p0, float p1, float p2, float p3) {
    pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  };
}
template <int NJ>
__device__ __forceinline__ auto split_emit(uint32_t (&ph)[NJ / 2][4], uint32_t (&pl)[NJ / 2][4]) {
  return [&ph, &pl](int j, float p0, float p1, float p2, float p3) {
    split_pair(p0, p1, ph[j >> 1][(j & 1) * 2 + 0], pl[j >> 1][(j & 1) * 2 + 0]);
    split_pair(p2, p3, ph[j >> 1][(j & 1) * 2 + 1], pl[j >> 1][(j & 1) * 2 + 1]);
  };
}
template <int NJ>
__device__ __forceinline__ void softmax_pack(float (&sc)[4 * NJ], const float* bs, int key0,
                                             int lk, float scale2, float& m0, float& m1,
                                             float& l0, float& l1, float& corr0, float& corr1,
                                             uint32_t (&pa)[NJ / 2][4]) {
  softmax_tile<NJ>(sc, bs, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1, pack_emit<NJ>(pa));
}
template <int NJ>
__device__ __forceinline__ void softmax_split(float (&sc)[4 * NJ], const float* bs, int key0,
                                              int lk, float scale2, float& m0, float& m1,
                                              float& l0, float& l1, float& corr0, float& corr1,
                                              uint32_t (&ph)[NJ / 2][4],
                                              uint32_t (&pl)[NJ / 2][4]) {
  softmax_tile<NJ>(sc, bs, key0, lk, scale2, m0, m1, l0, l1, corr0, corr1,
                   split_emit<NJ>(ph, pl));
}

// The forward's epilogue for a group's 64 rows: the quad's partial row sums
// l0, l1 completed, this thread's N output values of rows r0, r0 + 8 (those
// below lq) divided by them into out (row stride son, from column col0),
// and with lse (the (batch, head) row, or null; written by the t = 0
// threads of the caller's choosing) the natural-log LSE: -1e9 for a row
// that saw no live key.
template <int N, typename T>
__device__ __forceinline__ void finish_rows(T* out, long long son, float* lse,
                                            const float (&acc)[N], int r0, int lq, int col0,
                                            float m0, float m1, float l0, float l1) {
  const int t = threadIdx.x & 3;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int c = col0 + n * 8 + 2 * t;
    if (r0 < lq) store2(out + r0 * son + c, acc[4 * n + 0] * i0, acc[4 * n + 1] * i0);
    if (r1 < lq) store2(out + r1 * son + c, acc[4 * n + 2] * i1, acc[4 * n + 3] * i1);
  }
  if (lse != nullptr && t == 0) {
    const float valid = 0.5f * NEG_INF * LOG2E;
    if (r0 < lq) lse[r0] = m0 > valid ? (m0 + __log2f(fmaxf(l0, 1e-30f))) * LN2 : NEG_INF;
    if (r1 < lq) lse[r1] = m1 > valid ? (m1 + __log2f(fmaxf(l1, 1e-30f))) * LN2 : NEG_INF;
  }
}

// dq, group 0: S (64 queries x 8 NJ keys) becomes dS = P o (dP - Delta) in
// place, P = 2^(S scale2 + bias log2 e + nl) with the tile's key bias at bs
// (keys from key0 past lk masked), dP from group 1 at buf (xchg_put's
// layout); nl and dl are this thread's rows' -lse log2 e and Delta.
template <int NJ>
__device__ __forceinline__ void dq_ds(float (&sc)[4 * NJ], const float* bs, const float* buf,
                                      int key0, int lk, float scale2, float nl0, float nl1,
                                      float dl0, float dl1) {
  const int t = threadIdx.x & 3, wt = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 8 + 2 * t;  // this thread's keys c, c + 1
    const float2 bv = *reinterpret_cast<const float2*>(bs + c);
    const float b0 = key0 + c < lk ? bv.x * LOG2E : NEG_INF * LOG2E;
    const float b1 = key0 + c + 1 < lk ? bv.y * LOG2E : NEG_INF * LOG2E;
    const float* dp = buf + 4 * j * 128 + wt;
    sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], scale2, b0) + nl0) * (dp[0] - dl0);  // row r0
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale2, b1) + nl0) * (dp[128] - dl0);
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale2, b0) + nl1) * (dp[256] - dl1);  // row r0 + 8
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale2, b1) + nl1) * (dp[384] - dl1);
  }
}

// dkv, group 0: S^T (64 keys x 8 NJ queries) becomes P^T = 2^(S^T scale2 +
// kb + nl) in place, kb this thread's keys' bias times log2 e, nl from the
// tile's lse at ls (DEAD for queries from q0 past lq or masked); then P^T
// goes to group 1 through buf, from the second tile on once group 1 has
// read the previous one (bar_free), and bar_ready says it is there.
template <int NJ, int NCONS>
__device__ __forceinline__ void dkv_send_p(float (&sc)[4 * NJ], float* buf, const float* ls, int i,
                                           int q0, int lq, float kb0, float kb1, float scale2,
                                           int bar_ready, int bar_free) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 8 + 2 * t;  // this thread's queries c, c + 1
    const float2 lv = *reinterpret_cast<const float2*>(ls + c);
    const float nl0 = q0 + c < lq && lv.x > 0.5f * NEG_INF ? -lv.x * LOG2E : DEAD;
    const float nl1 = q0 + c + 1 < lq && lv.y > 0.5f * NEG_INF ? -lv.y * LOG2E : DEAD;
    sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], scale2, kb0) + nl0);  // key r0, query c
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale2, kb0) + nl1);
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale2, kb1) + nl0);  // key r0 + 8
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale2, kb1) + nl1);
  }
  if (i > 0) named_sync<NCONS>(bar_free);
  xchg_put(buf, threadIdx.x & 127, sc);
  named_arrive<NCONS>(bar_ready);
}

// dkv, group 1: dP^T (64 keys x 8 NJ queries) becomes dS^T = P^T o (dP^T -
// Delta) in place, P^T from group 0 at buf once bar_ready, Delta of the
// tile's queries at ds; buf is freed (bar_free) unless this is the last
// tile.
template <int NJ, int NCONS>
__device__ __forceinline__ void dkv_recv_ds(float (&sc)[4 * NJ], const float* buf, const float* ds,
                                            bool more, int bar_ready, int bar_free) {
  const int t = threadIdx.x & 3, wt = threadIdx.x & 127;
  named_sync<NCONS>(bar_ready);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(ds + j * 8 + 2 * t);
    const float* p = buf + 4 * j * 128 + wt;
    sc[4 * j + 0] = p[0] * (sc[4 * j + 0] - dl.x);
    sc[4 * j + 1] = p[128] * (sc[4 * j + 1] - dl.y);
    sc[4 * j + 2] = p[256] * (sc[4 * j + 2] - dl.x);
    sc[4 * j + 3] = p[384] * (sc[4 * j + 3] - dl.y);
  }
  if (more) named_arrive<NCONS>(bar_free);
}

// ---- host: tensor maps through cudaGetDriverEntryPoint (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// A (B, H, N, d) bf16 view with element strides (sb, sh, sn) as a 4-D
// (d, N, H, B) map, boxes of `rows` rows of one (batch, head) and
// slab_cols(d) columns, swizzled at the box's width (64 bytes at d = 32,
// 128 at d = 64 and 256, 32 at d = 80; a d = 256 tile is four boxes and a
// d = 80 tile five, one a slab: Tile::load); rows past N read as zeros.
inline CUresult map_heads(EncodeTiled fn, CUtensorMap* m, const void* base, int d, int n, int H,
                          int B, long long sb, long long sh, long long sn, int rows) {
  const int width = slab_cols(d);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(width), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
            : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A (2 B, H, n, d) bf16 split copy (flash_sdpa_split_parts: hi at batch
// b, lo at b + B), contiguous, as a map_heads map of `rows`-row boxes.
inline CUresult map_parts(EncodeTiled fn, CUtensorMap* m, const void* parts, int d, int n, int H,
                          int B, int rows) {
  const long long sn = d, sh = static_cast<long long>(n) * d, sb = H * sh;
  return map_heads(fn, m, parts, d, n, H, 2 * B, sb, sh, sn, rows);
}

// A (B, H, N, d) int8 view with (byte) strides (sb, sh, sn), d a multiple of
// 128, as a 4-D (d, N, H, B) map, boxes of `rows` rows of one (batch, head)
// and 128 columns at the 128-byte swizzle (TileI8::load, a box a slab); rows
// past N read as zeros. The map's element type is UINT8 (the driver's types
// have no signed 8-bit one; TMA copies bytes, and wgmma reads them as s8).
inline CUresult map_heads_i8(EncodeTiled fn, CUtensorMap* m, const void* base, int d, int n,
                             int H, int B, long long sb, long long sh, long long sn, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn), static_cast<cuuint64_t>(sh),
                                 static_cast<cuuint64_t>(sb)};
  const cuuint32_t box[4] = {128, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A (rows, cols) f32 row-major matrix (cols a multiple of 4, the base
// 16-byte aligned) as a 2-D map of boxes of `box` columns of one row;
// columns past `cols` read as zeros.
inline CUresult map_rows_f32(EncodeTiled fn, CUtensorMap* m, const void* base, int cols, int rows,
                             int box) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, boxd,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once a device and size (`set` holds the limit set per device).
template <typename Kernel>
int raise_smem(Kernel kernel, int bytes, int (&set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set[dev] = bytes;
  }
  return 0;
}

// Resources of `kernel` at `threads` threads and `smem` bytes of dynamic
// shared memory a block: out = {registers a thread, local (spilled) bytes a
// thread, shared bytes a block, resident blocks an SM}.
template <typename Kernel>
int kernel_attrs(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes) + smem;
  out[3] = blocks;
  return 0;
}

}  // namespace wgmma
