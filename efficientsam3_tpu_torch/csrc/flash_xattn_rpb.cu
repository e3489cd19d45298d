// Flash cross-attention with the decoder's decomposed boxRPB bias, for
// Hopper (sm_90a). Forward only (inference).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `flash_xattn_rpb`
// (`_xattn_rpb_kernel`): softmax(Q K^T * scale + bias) V where
// bias[q, y * w + x] = ey[q, y] + ex[q, x]. The (NQ, h * w) bias is rebuilt
// per tile from the f32 ey/ex rows held in shared memory and never stored
// whole. The bias is exact f32, as on the einsum path (common.py:580-582),
// not the TPU kernel's one-hot matmuls at the input dtype (bf16-rounded
// terms). Keys past h * w score -1e9, as the TPU kernel's sentinel lane did.
//
// Bound on the H100: at the decoder shape (q (1, 8, 201, 32), k/v
// (1, 8, 5184, 32)) the whole call is ~1.1 GFLOP and 8.3 M exponentials,
// a few microseconds of work, so occupancy decides: 201 queries are 4 q
// tiles per head, 32 blocks for 132 SMs. The kv axis is therefore split
// across blocks (split-K): each block runs the online softmax over its
// share of the key tiles and writes an unnormalised fp32 partial with its
// running max and sum; a second small kernel merges the partials by their
// log-sum-exp. The split count is chosen by the wrapper so that about two
// blocks per SM are in flight.

#include "attn_common.cuh"

using namespace attn;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_xattn_rpb_partial(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ ey,  // (B*H, lq, hy)
                        const float* __restrict__ ex,  // (B*H, lq, wx)
                        float* __restrict__ part_acc,  // (B*H, S, lq, D)
                        float* __restrict__ part_ml,   // (B*H, S, lq, 2)
                        int H, int lq, int lk, int hy, int wx,
                        int tiles_per_split, float sm_scale,
                        long long sqb, long long sqh, long long sqn,
                        long long skb, long long skh, long long skn,
                        long long svb, long long svh, long long svn) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vt[D][VPAD];
  extern __shared__ float rpb_s[];  // [BQ][hy] then [BQ][wx]
  float* eys = rpb_s;
  float* exs = rpb_s + BQ * hy;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qblk = blockIdx.x * BQ;
  const int row0 = qblk + warp * 16;
  q += b * sqb + h * sqh;
  k += b * skb + h * skh;
  v += b * svb + h * svh;

  // this block's ey/ex rows; rows past lq read as zero
  const float* eyb = ey + ((long long)bh * lq) * hy;
  const float* exb = ex + ((long long)bh * lq) * wx;
  for (int i = threadIdx.x; i < BQ * hy; i += NTHREADS) {
    const int r = qblk + i / hy;
    eys[i] = r < lq ? eyb[(long long)r * hy + i % hy] : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * wx; i += NTHREADS) {
    const int r = qblk + i / wx;
    exs[i] = r < lq ? exb[(long long)r * wx + i % wx] : 0.f;
  }

  uint32_t qa[D / 16][4];
  load_q<D>(qa, q, sqn, row0, lq);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (lk + BK - 1) / BK;
  const int kt0 = split * tiles_per_split;
  const int kt1 = min(ntiles, kt0 + tiles_per_split);
  const float* ey0 = eys + (warp * 16 + g) * hy;
  const float* ey1 = ey0 + 8 * hy;
  const float* ex0 = exs + (warp * 16 + g) * wx;
  const float* ex1 = ex0 + 8 * wx;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int key0 = kt * BK;
    __syncthreads();  // ey/ex staged; the previous tile's readers are done
    stage_kv<D>(ks, vt, k, skn, v, svn, key0, lk);
    __syncthreads();

    float s[BK / 8][4];
    qk_tile<D>(s, qa, ks);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + 2 * t + e;
        if (key < lk) {
          const int y = key / wx, x = key - y * wx;
          s[j][e] = s[j][e] * sm_scale + (ey0[y] + ex0[x]);
          s[j][2 + e] = s[j][2 + e] * sm_scale + (ey1[y] + ex1[x]);
        } else {
          s[j][e] = NEG_INF;
          s[j][2 + e] = NEG_INF;
        }
      }
    }
    softmax_pv<D>(s, m, l, acc, vt);
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const int r0 = row0 + g, r1 = row0 + g + 8;
  const long long base = ((long long)bh * nsplit + split) * lq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<float2*>(part_acc + (base + r0) * D + c) =
          make_float2(acc[n][0], acc[n][1]);
    if (r1 < lq)
      *reinterpret_cast<float2*>(part_acc + (base + r1) * D + c) =
          make_float2(acc[n][2], acc[n][3]);
  }
  if (t == 0) {
    if (r0 < lq) *reinterpret_cast<float2*>(part_ml + (base + r0) * 2) = make_float2(m[0], l0);
    if (r1 < lq) *reinterpret_cast<float2*>(part_ml + (base + r1) * 2) = make_float2(m[1], l1);
  }
}

// out[b, h, r, :] = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
template <int D>
__global__ void flash_xattn_rpb_merge(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      __nv_bfloat16* __restrict__ o, int H,
                                      int lq, int nsplit, long long sob,
                                      long long soh, long long son,
                                      long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % D);
  const long long br = i / D;  // bh * lq + r
  const int r = static_cast<int>(br % lq);
  const int bh = static_cast<int>(br / lq), b = bh / H, h = bh % H;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[(((long long)bh * nsplit + s) * lq + r) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long rs = ((long long)bh * nsplit + s) * lq + r;
    const float w = __expf(part_ml[rs * 2] - mx);
    den += part_ml[rs * 2 + 1] * w;
    num += part_acc[rs * D + c] * w;
  }
  o[b * sob + h * soh + r * son + c] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

extern "C" int flash_xattn_rpb_fwd(const void* q, const void* k, const void* v,
                                   const void* ey, const void* ex, void* o,
                                   void* part_acc, void* part_ml, int B, int H,
                                   int lq, int lk, int d, int hy, int wx,
                                   int nsplit, int tiles_per_split,
                                   float sm_scale, long long sqb, long long sqh,
                                   long long sqn, long long skb, long long skh,
                                   long long skn, long long svb, long long svh,
                                   long long svn, long long sob, long long soh,
                                   long long son, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = BQ * (hy + wx) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_xattn_rpb_partial<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + BQ - 1) / BQ, B * H, nsplit);
  flash_xattn_rpb_partial<32><<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(ey),
      static_cast<const float*>(ex), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, lq, lk, hy, wx, tiles_per_split, sm_scale,
      sqb, sqh, sqn, skb, skh, skn, svb, svh, svn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)B * H * lq * 32;
  const int threads = 256;
  flash_xattn_rpb_merge<32><<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(o), H, lq, nsplit, sob, soh, son, total);
  return static_cast<int>(cudaGetLastError());
}
