// Same-padded 7x7 depthwise convolution over NHWC maps for Hopper (sm_90a):
// the forward, and one backward kernel that writes dx, dw and db.
//
// Replaces efficientsam3_tpu/ops/pallas/depthwise.py `_dw_call` (body
// `_dw_kernel`), the forward of the tracker memory encoder's ConvNeXt fuser
// (models/memory_encoder.CXBlock): y[b, i, j, c] = bias[c] + sum_{di, dj}
// w[di, dj, c] * x[b, i + di - 3, j + dj - 3, c], zero padding, fp32
// accumulation, one rounding to x's dtype; and its custom VJP `_dw_bwd`: dx
// is the same correlation over the output gradient g with the taps flipped
// and a zero bias, rounded to x's dtype; dw[di, dj, c] = sum x_pad[b, i +
// di, j + dj, c] * g[b, i, j, c] and db[c] = sum g[b, i, j, c] in fp32
// (jnp reductions in JAX).
//
// Bound on the H100 at the tracker shape x (8, 72, 72, 256): 49 fp32 FMAs
// an output, 1.04 GFLOP, ~15.5 us at 67 TFLOP/s, against 21.2 MB in and out
// in bf16 (~12.6 us at 3.35 TB/s; fp32 25.4 us, bound by bytes). The
// backward does twice the FMAs (dx and dw) over x, g and dx.
//
// Design. The work is a walk down the map's rows. A block owns 32 channels
// (one a lane) of a 36-column strip of one image and a run of output rows;
// the runs of every (channel group, image, strip) laid end to end are cut
// into one equal range of rows a block, and the grid is the blocks resident
// on the card (persistent blocks; ranges cross from one strip or image to
// the next).
//
// A conv warp owns CC adjacent output columns of the strip for its lane's
// channel (9 in the forward, 6 in the backward). It keeps the 49 taps of
// that channel in registers and the sums of the 7 output rows the current
// input row reaches (7 x CC accumulators): each input row it reads CC + 6
// values from shared memory and issues up to 49 CC FMAs, then stores the
// row that is complete and shifts the window down one row. Rows outside
// the map are skipped. The forward's blocks are 4 such warps (three blocks
// an SM, ~160 registers a thread); its 9-column tile ran ~8% faster than 6
// columns x 6 warps at two blocks an SM.
//
// Each warp stages the CC + 6 columns it reads of each row (its own and 3
// on each side, zero outside the map) into a ring of 8 rows of its own, by
// cp.async 4 rows ahead of the row it computes, and waits for nothing but
// its own copies (cp.async.wait_group, __syncwarp): no barrier a row, so
// the warps drift out of step and one warp's loads, stores and bookkeeping
// overlap another's FMAs. (A block barrier a row, over rows staged once for
// the whole block, held the warps in step: their non-FMA work never
// overlapped, and the forward took twice as long.) The halo columns are
// read by two warps each: L2 serves 2x the strip's bytes.
//
// The backward (dw7_bwd_kernel) runs two kinds of warps: six conv warps
// compute dx from g rows with the flipped taps, as the forward does; six
// weight warps stage x and their own columns of g, keep the channel's 49
// dw sums and its db sum in registers over every row the block walks, and
// a window of the 7 g rows (their own 6 columns) the current x row meets:
// each row they read one x row (3 rows behind the one staged, which their
// ring still holds) and multiply it into the window. When the walk leaves
// a channel group, the block adds its weight warps' sums in shared memory
// in a fixed order and writes one partial row ((block + group) indexes it:
// at most resident blocks + groups rows of 50 x 32); the last block to
// finish a group (an atomic ticket) sums that group's partials in block
// order and writes dw and db, so the result is the same bits on every
// run, in the same launch.
//
// Any C (channels past C are zero in the staged rows and never stored; a
// 16-byte cp.async path when C is a multiple of the 16-byte vector and the
// maps are aligned, element copies otherwise), any H and W, bf16 or fp32
// maps (the arithmetic is fp32 either way), taps and bias bf16 or fp32 at
// any strides (CXBlock hands in a permuted view of its conv weight; read in
// place, no cast launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 7, PAD = 3, TAPS = KS * KS;
constexpr int CG = 32;            // channels a block: one a lane
constexpr int TW = 36;            // output columns a strip: NXW warps of CC columns
constexpr int STAGES = 8;         // a warp's ring of staged rows
constexpr int AHEAD = 4;          // rows staged ahead of the one computed
constexpr int PARTS = TAPS + 1;   // a partial row: 49 tap sums and the bias sum
// the backward's weight warps read the x row 3 rows behind the one staged,
// which their ring must still hold
static_assert(AHEAD + 1 + PAD <= STAGES, "a warp's ring holds every live row");

// A thread's output columns CC and the warps of each kind NXW: the forward
// 9 x 4 (128 threads, three blocks an SM), the backward 6 x 6 (six conv
// and six weight warps, 384 threads, one block an SM; at 9 columns its
// weight warps lost what its conv warps gained).
template <bool BWD>
struct Cfg {
  static constexpr int CC = BWD ? 6 : 9;
  static constexpr int NXW = TW / CC;
  static constexpr int XCOLS = CC + KS - 1;  // columns a warp reads of a row: its own, 3 each side
  static constexpr int WARPS = BWD ? 2 * NXW : NXW;
  static_assert(NXW * CC == TW, "a strip is whole warps' columns");
  static constexpr int NT = 32 * WARPS;
  static constexpr int TAIL = BWD ? 2 * PAD : PAD;  // rows walked past a run's last row
};

// A warp's staged row: the XCOLS columns of x (the forward; the backward's
// weight warps) or of g (the backward's conv warps) it reads, and for a
// weight warp its own CC columns of g after them.
template <bool BWD, bool WGT>
struct Region {
  static constexpr int COLS = Cfg<BWD>::XCOLS + (WGT ? Cfg<BWD>::CC : 0);
  static constexpr int ROW = COLS * CG;  // elements
};

struct Params {
  const void* x;     // forward: x; backward: x (for dw)
  const void* g;     // backward: the output gradient
  const void* w;     // taps: (di, dj, c) at di * swi + dj * swj + c * swc
  const void* bias;  // forward: c at c * sb; null for none
  void* out;         // forward y, backward dx: (B, H, W, C) like x
  float* dw;         // backward: (49, C)
  float* db;         // backward: (C,)
  float* part;       // backward: (blocks + groups, 50, 32) partial sums
  int* cnt;          // backward: a zeroed ticket a channel group, left zeroed
  long long swi, swj, swc, sb;
  long long rows;    // output rows of the walk: groups * B * strips * H
  int w_fp32, b_fp32;
  int B, H, W, C, strips, vec;
};

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) { *p = __float2bfloat16(v); }
template <typename T>
__device__ __forceinline__ T zero_of() {
  T v;
  stf(&v, 0.f);
  return v;
}

__device__ __forceinline__ float ld_any(const void* base, long long off, int fp32) {
  return fp32 ? static_cast<const float*>(base)[off]
              : __bfloat162float(static_cast<const bf16*>(base)[off]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void fence_gpu() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }

// A block's walk: runs of rows [i0, i1) of item (group, image, strip) in
// the order (group, image, strip); the current row s from i0 - 3 to i1 +
// TAIL; `left`, the block's output rows after the current run.
struct Walk {
  int H, i0, i1, s, image, group, strip, left;
  bool done;
  __device__ void init(const Params& p, long long lo, long long hi) {
    H = p.H;
    const long long it = lo / H, rest = it / p.strips;
    i0 = static_cast<int>(lo - it * H);
    i1 = static_cast<int>(min(static_cast<long long>(H), i0 + (hi - lo)));
    left = static_cast<int>(hi - lo) - (i1 - i0);
    s = i0 - PAD;
    strip = static_cast<int>(it - rest * p.strips);
    group = static_cast<int>(rest / p.B);
    image = static_cast<int>(rest - static_cast<long long>(group) * p.B);
    done = hi <= lo;
  }
  // the next row; true when it begins a new run (or ends the walk)
  template <int TAIL>
  __device__ bool next(const Params& p) {
    if (++s < i1 + TAIL) return false;
    if (left == 0) {
      done = true;
      return true;
    }
    i0 = 0;
    i1 = min(H, left);
    left -= i1;
    s = -PAD;
    if (++strip == p.strips) {
      strip = 0;
      if (++image == p.B) image = 0, ++group;
    }
    return true;
  }
  // a row the run stages (3 past its rows on each side, inside the map)
  __device__ bool staged() const { return !done && s >= 0 && s < H && s < i1 + PAD; }
};

// A lane's share of staging its warp's region of a row: chunks lane + 32 k
// of 16 bytes, the same chunks every row; per run, each chunk's address in
// row 0 of the run's image (null: outside the map, zero-filled).
template <typename T, bool BWD, bool WGT>
struct Stager {
  static constexpr int EPC = 16 / sizeof(T), CH = CG / EPC;  // chunks a column
  static constexpr int XCOLS = Cfg<BWD>::XCOLS;
  static constexpr int CHUNKS = Region<BWD, WGT>::COLS * CH;
  static constexpr int PER = (CHUNKS + 31) / 32;
  const T* from[PER];
  long long row_elems;

  __device__ void begin(const Params& p, const Walk& w, int col0) {
    row_elems = static_cast<long long>(p.W) * p.C;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k, col = i / CH;
      const bool gpart = WGT && col >= XCOLS;  // a weight warp's own columns of g
      const int gx = w.strip * TW + col0 + (gpart ? col - XCOLS : col - PAD);
      const int gc = w.group * CG + (i % CH) * EPC;
      const void* map = (BWD && !WGT) || gpart ? p.g : p.x;
      from[k] = i < CHUNKS && gx >= 0 && gx < p.W && gc < p.C
                    ? static_cast<const T*>(map) +
                          static_cast<long long>(w.image) * p.H * row_elems +
                          static_cast<long long>(gx) * p.C + gc
                    : nullptr;
    }
  }
  // input row w.s of the run into a ring row; nothing for rows it does not stage
  __device__ void issue(const Params& p, const Walk& w, T* row, int col0) const {
    if (!w.staged()) return;
    const int lane = threadIdx.x & 31;
    if (p.vec) {
      const long long off = w.s * row_elems;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane + 32 * k;
        if (i < CHUNKS)
          cp_async16(row + (i / CH) * CG + (i % CH) * EPC,
                     from[k] ? from[k] + off : static_cast<const T*>(p.x), from[k] ? 16 : 0);
      }
      return;
    }
    // element copies: C not a multiple of the 16-byte vector, or misaligned maps
    const long long base = (static_cast<long long>(w.image) * p.H + w.s) * p.W;
    for (int i = lane; i < Region<BWD, WGT>::ROW; i += 32) {
      const int col = i / CG, c = i % CG;
      const bool gpart = WGT && col >= XCOLS;
      const int gx = w.strip * TW + col0 + (gpart ? col - XCOLS : col - PAD);
      const int gc = w.group * CG + c;
      const void* map = (BWD && !WGT) || gpart ? p.g : p.x;
      T v = zero_of<T>();
      if (gx >= 0 && gx < p.W && gc < p.C) v = static_cast<const T*>(map)[(base + gx) * p.C + gc];
      row[i] = v;
    }
  }
};

// The backward's block barrier (its two kinds of warps reach it from their
// own code): the PTX barrier with the block's count.
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 0, %0;\n" ::"n"(Cfg<true>::NT) : "memory");
}

// One warp's walk (WGT: a backward weight warp; else a conv warp of either
// kernel). Each warp stages the rows it reads into its own ring and waits
// for nothing but its own copies: no barrier a row, so the warps drift
// apart and one warp's loads, stores and bookkeeping overlap another's
// FMAs.
template <typename T, bool BWD, bool WGT>
__device__ __forceinline__ void walk(const Params& p, T* ring, float* red, int* s_last) {
  constexpr int ROW = Region<BWD, WGT>::ROW;
  constexpr int CC = Cfg<BWD>::CC, NXW = Cfg<BWD>::NXW, XCOLS = Cfg<BWD>::XCOLS;
  const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) - (WGT ? NXW : 0);
  const int col0 = wi * CC;
  const long long G = gridDim.x, blk = blockIdx.x;
  const long long lo = p.rows * blk / G, hi = p.rows * (blk + 1) / G;
  const long long per_group = static_cast<long long>(p.B) * p.strips * p.H;
  const long long row_elems = static_cast<long long>(p.W) * p.C;
  T* mine = ring + wi * STAGES * ROW;  // this warp's ring

  Walk cons, prod;
  cons.init(p, lo, hi);
  prod = cons;
  Stager<T, BWD, WGT> st;
  if (!prod.done) st.begin(p, prod, col0);
  int slot_in = 0;
  auto produce = [&]() {  // the producer's row into the ring, one commit group
    st.issue(p, prod, mine + slot_in * ROW, col0);
    cp_async_commit();
    slot_in = (slot_in + 1) & (STAGES - 1);
    if (prod.template next<Cfg<BWD>::TAIL>(p) && !prod.done) st.begin(p, prod, col0);
  };
#pragma unroll 1
  for (int a = 0; a < AHEAD; ++a) produce();

  float wt[TAPS], acc[KS][CC];  // conv warps: taps, the 7 pending rows' sums
  float dwa[TAPS], dba = 0.f;   // weight warps: dw and db sums
  float gw[KS][CC];             // weight warps: g rows s - 6 .. s, own columns
  float bias_v = 0.f;
  T* dst = nullptr;             // conv warps: output row 0 of the run, own columns
  int ch = 0, cols = 0;
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[k][c] = gw[k][c] = 0.f;
#pragma unroll
  for (int e = 0; e < TAPS; ++e) dwa[e] = wt[e] = 0.f;

  auto begin_run = [&]() {
    ch = cons.group * CG + lane;
    cols = min(CC, p.W - (cons.strip * TW + col0));
    if constexpr (!WGT) {
      dst = static_cast<T*>(p.out) + static_cast<long long>(cons.image) * p.H * row_elems +
            static_cast<long long>(cons.strip * TW + col0) * p.C + ch;
#pragma unroll
      for (int di = 0; di < KS; ++di)
#pragma unroll
        for (int dj = 0; dj < KS; ++dj) {  // the backward's dx takes the flipped taps
          const int si = BWD ? KS - 1 - di : di, sj = BWD ? KS - 1 - dj : dj;
          wt[di * KS + dj] =
              ch < p.C ? ld_any(p.w, si * p.swi + sj * p.swj + ch * p.swc, p.w_fp32) : 0.f;
        }
      bias_v = (p.bias != nullptr && ch < p.C) ? ld_any(p.bias, ch * p.sb, p.b_fp32) : 0.f;
    }
  };

  // the weight warps' sums of a channel group: one partial row, and the
  // group's dw / db from the last block to finish it (every warp of the
  // block takes part)
  auto flush = [&](int grp) {
    if constexpr (WGT) {
      float* r = red + wi * PARTS * CG + lane;
#pragma unroll
      for (int e = 0; e < TAPS; ++e) r[e * CG] = dwa[e];
      r[TAPS * CG] = dba;
    }
    block_barrier();
    float* part = p.part + (blk + grp) * PARTS * CG;
    for (int i = threadIdx.x; i < PARTS * CG; i += Cfg<BWD>::NT) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NXW; ++w) v += red[w * PARTS * CG + i];
      part[i] = v;
    }
    // blocks whose rows meet the group: the block of its first and last row
    const long long first = grp * per_group, last = first + per_group - 1;
    const long long kf = ((first + 1) * G - 1) / p.rows, kl = ((last + 1) * G - 1) / p.rows;
    // a ticket after the block's writes: the block's barrier, then one
    // thread's release / acquire fence around the atomic
    block_barrier();
    if (threadIdx.x == 0) {
      fence_gpu();
      *s_last = atomicAdd(p.cnt + grp, 1) == static_cast<int>(kl - kf);
      if (*s_last) fence_gpu();
    }
    block_barrier();
    if (*s_last) {
      for (int i = threadIdx.x; i < PARTS * CG; i += Cfg<BWD>::NT) {
        const int e = i / CG, c = grp * CG + (i - e * CG);
        float v = 0.f;
        for (long long k0 = kf; k0 <= kl; k0 += 8) {  // 8 loads in flight, added in order
          float t8[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            t8[u] = k0 + u <= kl ? __ldcg(p.part + (k0 + u + grp) * PARTS * CG + i) : 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) v += t8[u];
        }
        if (c < p.C) {
          if (e < TAPS)
            p.dw[static_cast<long long>(e) * p.C + c] = v;
          else
            p.db[c] = v;
        }
      }
      if (threadIdx.x == 0) p.cnt[grp] = 0;
    }
    if constexpr (WGT) {
#pragma unroll
      for (int e = 0; e < TAPS; ++e) dwa[e] = 0.f;
      dba = 0.f;
    }
  };

  if (!cons.done) begin_run();
  int t = 0;  // the ring slot of the consumer's row
#pragma unroll 1
  for (; !cons.done; t = (t + 1) & (STAGES - 1)) {
    cp_async_wait<AHEAD - 1>();
    __syncwarp();  // the warp's copies of this row are in; its reads of the slot reused are done
    produce();
    const int s = cons.s, i0 = cons.i0, i1 = cons.i1;
    const T* row = mine + t * ROW;
    if constexpr (!WGT) {
      // input row s (x, or g in the backward) into the 7 output rows it reaches
      if (s >= 0 && s < p.H && s < i1 + PAD) {
        float in[XCOLS];
#pragma unroll
        for (int q = 0; q < XCOLS; ++q) in[q] = ldf(row + q * CG + lane);
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int o = s - PAD + k;  // acc[k]'s output row, reached by tap row 6 - k
          if (o >= i0 && o < i1) {
#pragma unroll
            for (int dj = 0; dj < KS; ++dj)
#pragma unroll
              for (int c = 0; c < CC; ++c)
                acc[k][c] = fmaf(wt[(KS - 1 - k) * KS + dj], in[c + dj], acc[k][c]);
          }
        }
      }
      const int o = s - PAD;  // complete: every input row it needs is in
      if (o >= i0 && o < i1 && ch < p.C) {
        T* out = dst + o * row_elems;
#pragma unroll
        for (int c = 0; c < CC; ++c)
          if (c < cols) stf(out + static_cast<long long>(c) * p.C, acc[0][c] + bias_v);
      }
#pragma unroll
      for (int k = 0; k < KS - 1; ++k)
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[k][c] = acc[k + 1][c];
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[KS - 1][c] = 0.f;
    } else {
      // g row s into the window (zero outside the run), db
      const bool g_ok = s >= i0 && s < i1;
#pragma unroll
      for (int k = 0; k < KS - 1; ++k)
#pragma unroll
        for (int c = 0; c < CC; ++c) gw[k][c] = gw[k + 1][c];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        gw[KS - 1][c] = g_ok ? ldf(row + (XCOLS + c) * CG + lane) : 0.f;
        dba += gw[KS - 1][c];
      }
      // x row s - 3 (staged 3 rows ago) against g rows s - di, tap row di
      const int r = s - PAD;
      if (r >= 0 && r < p.H && s >= i0 && s - (KS - 1) < i1) {
        const T* xr = mine + ((t - PAD) & (STAGES - 1)) * ROW + lane;
        float xin[XCOLS];
#pragma unroll
        for (int q = 0; q < XCOLS; ++q) xin[q] = ldf(xr + q * CG);
#pragma unroll
        for (int di = 0; di < KS; ++di) {
          if (s - di >= i0 && s - di < i1) {
#pragma unroll
            for (int dj = 0; dj < KS; ++dj)
#pragma unroll
              for (int c = 0; c < CC; ++c)
                dwa[di * KS + dj] = fmaf(xin[c + dj], gw[KS - 1 - di][c], dwa[di * KS + dj]);
          }
        }
      }
    }

    const int grp = cons.group;
    if (cons.template next<Cfg<BWD>::TAIL>(p)) {
      if (!cons.done) begin_run();
      if constexpr (BWD)
        if (cons.done || cons.group != grp) flush(grp);
    }
  }
  cp_async_wait<0>();
}

template <typename T, bool BWD>
__device__ __forceinline__ void dw7_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the conv warps' rings, then (backward) the weight warps' rings and their
  // sums [NXW][50][CG], added in warp order
  constexpr int NXW = Cfg<BWD>::NXW;
  T* conv_rings = reinterpret_cast<T*>(smem_raw);
  T* wgt_rings = conv_rings + NXW * STAGES * Region<BWD, false>::ROW;
  float* red =
      reinterpret_cast<float*>(wgt_rings + (BWD ? NXW * STAGES * Region<BWD, true>::ROW : 0));
  __shared__ int s_last;
  if constexpr (BWD) {
    if ((threadIdx.x >> 5) >= NXW)
      walk<T, true, true>(p, wgt_rings, red, &s_last);
    else
      walk<T, true, false>(p, conv_rings, red, &s_last);
  } else {
    walk<T, false, false>(p, conv_rings, red, &s_last);
  }
}

template <typename T>
__global__ void __launch_bounds__(Cfg<false>::NT, 3) dw7_fwd_kernel(const Params p) {
  dw7_body<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(Cfg<true>::NT, 1) dw7_bwd_kernel(const Params p) {
  dw7_body<T, true>(p);
}

template <bool BWD>
constexpr int smem_bytes(int elem) {
  constexpr int NXW = Cfg<BWD>::NXW;
  return NXW * STAGES * (Region<BWD, false>::ROW + (BWD ? Region<BWD, true>::ROW : 0)) * elem +
         (BWD ? NXW * PARTS * CG * 4 : 0);
}

const void* kernel_for(int fp32, int bwd) {
  if (bwd) return fp32 ? reinterpret_cast<const void*>(dw7_bwd_kernel<float>)
                       : reinterpret_cast<const void*>(dw7_bwd_kernel<bf16>);
  return fp32 ? reinterpret_cast<const void*>(dw7_fwd_kernel<float>)
              : reinterpret_cast<const void*>(dw7_fwd_kernel<bf16>);
}

// The kernel's shared bytes, its threads, and the current device's SMs and
// resident blocks an SM (the dynamic shared memory allowed on first use).
int resources(int fp32, int bwd, int* smem, int* threads, int* sms, int* per_sm) {
  static int cache[64][2][2][2] = {};  // by device: SMs, blocks an SM + 1
  const void* k = kernel_for(fp32, bwd);
  *smem = bwd ? smem_bytes<true>(fp32 ? 4 : 2) : smem_bytes<false>(fp32 ? 4 : 2);
  *threads = bwd ? Cfg<true>::NT : Cfg<false>::NT;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int* c = cache[dev][fp32][bwd];
  if (c[1] == 0) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, dev);
    int n = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, *threads, *smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    c[1] = n + 1;
  }
  *sms = c[0];
  *per_sm = c[1] - 1;
  return 0;
}

int launch(Params& p, int fp32, int bwd, long long max_blocks, cudaStream_t st) {
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.C <= 0) return 0;
  int smem = 0, threads = 0, sms = 0, per_sm = 0;
  const int err = resources(fp32, bwd, &smem, &threads, &sms, &per_sm);
  if (err != 0) return err;
  p.strips = (p.W + TW - 1) / TW;
  const int groups = (p.C + CG - 1) / CG;
  p.rows = static_cast<long long>(groups) * p.B * p.strips * p.H;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > p.rows) grid = p.rows;
  if (max_blocks < grid) grid = max_blocks;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int elem = fp32 ? 4 : 2;
  p.vec = (p.C % (16 / elem) == 0) && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
          (!bwd || reinterpret_cast<uintptr_t>(p.g) % 16 == 0);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchKernel(kernel_for(fp32, bwd), dim3(static_cast<unsigned>(grid)), dim3(threads),
                       args, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = depthwise(x) + bias. x, out (B, H, W, C) contiguous, float32 when
// fp32 != 0 else bfloat16; the taps' element (di, dj, c) at di * swi + dj *
// swj + c * swc (float32 when w_fp32 else bfloat16); bias c at c * sb
// (float32 when b_fp32 else bfloat16), or null. Returns a CUDA error.
extern "C" int depthwise_conv2d_fwd(const void* x, const void* w, long long swi, long long swj,
                                    long long swc, int w_fp32, const void* bias, long long sb,
                                    int b_fp32, void* out, int B, int H, int W, int C, int k,
                                    int fp32, void* stream) {
  if (k != KS) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.x = x;
  p.w = w;
  p.swi = swi, p.swj = swj, p.swc = swc, p.w_fp32 = w_fp32;
  p.bias = bias;
  p.sb = sb, p.b_fp32 = b_fp32;
  p.out = out;
  p.B = B, p.H = H, p.W = W, p.C = C;
  return launch(p, fp32 != 0, 0, 1LL << 40, static_cast<cudaStream_t>(stream));
}

// The backward in one launch: dx (B, H, W, C) like x (the correlation of g
// with the flipped taps), dw (49, C) and db (C,) fp32. x, g contiguous, of
// one dtype (float32 when fp32 != 0 else bfloat16); the taps as for the
// forward. part: scratch of part_rows x 50 x 32 floats, at least the
// resident blocks plus ceil(C / 32) rows (the grid is cut to part_rows -
// ceil(C / 32) blocks); cnt: ceil(C / 32) zeroed ints, left zeroed.
extern "C" int depthwise_conv2d_bwd(const void* x, const void* g, const void* w, long long swi,
                                    long long swj, long long swc, int w_fp32, void* dx,
                                    void* dw, void* db, void* part, long long part_rows,
                                    void* cnt, int B, int H, int W, int C, int k, int fp32,
                                    void* stream) {
  if (k != KS) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.x = x;
  p.g = g;
  p.w = w;
  p.swi = swi, p.swj = swj, p.swc = swc, p.w_fp32 = w_fp32;
  p.out = dx;
  p.dw = static_cast<float*>(dw);
  p.db = static_cast<float*>(db);
  p.part = static_cast<float*>(part);
  p.cnt = static_cast<int*>(cnt);
  p.B = B, p.H = H, p.W = W, p.C = C;
  const long long groups = (C + CG - 1) / CG;
  return launch(p, fp32 != 0, 1, part_rows - groups, static_cast<cudaStream_t>(stream));
}

// The forward's (bwd = 0) or the backward's kernel, float32 maps when fp32
// != 0: out = {registers, spilled bytes a thread, shared bytes a block,
// resident blocks an SM, threads a block, output columns a strip}.
extern "C" int depthwise_conv2d_attrs(int fp32, int bwd, int* out) {
  int smem = 0, threads = 0, sms = 0, per_sm = 0;
  const int err = resources(fp32 != 0, bwd != 0, &smem, &threads, &sms, &per_sm);
  if (err != 0) return err;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_for(fp32 != 0, bwd != 0));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = smem + static_cast<int>(a.sharedSizeBytes);
  out[3] = per_sm;
  out[4] = threads;
  out[5] = TW;
  return 0;
}
