// Flash cross-attention over raw narrow values for Hopper (sm_90a).
//
// Replaces efficientsam3_tpu/ops/pallas/flash_attention.py `flash_memattn`
// (`_memattn_kernel` and `_memattn_kernel_lse`): the tracker's cached
// memory bank, softmax(Q K^T * scale + key_bias) V_raw with dk = 256 and the
// raw dv = 64 memory tokens as values (v_proj is applied after the
// attention, which is exact because softmax rows sum to 1), with an
// optional per-row log-sum-exp for the merge with the object-pointer
// segment. One kernel serves both Pallas variants (lse is a null pointer or
// not).
//
// The TPU kernel ran transposed (S^T = K Q^T, O^T = [V^T; 1] P^T) with the
// softmax denominator folded into the AV product as a ones row, only to
// keep the MXU's 128 lanes busy at dv = 64. None of that carries over: the
// kernel is the Q-in-shared-memory flash kernel of flash_qsmem.cuh at
// <DK, DV> = <256, 64>, with m16n8k16 tensor-core products, an fp32
// denominator summed from the unrounded P (the einsum path's choice; the
// TPU kernel's ones row summed the bf16-rounded P, ~2^-9 relative apart),
// and lse = -1e9 / output 0 for a row whose keys are all masked.
//
// Bound on the H100, per active object slot and layer at the tracker shape
// (q 5184 x 256, 36864 bank keys): 97.8 GFLOP of QK^T and 24.5 GFLOP of PV
// (~0.12 ms at the bf16 peak) and 191 M exponentials (~0.05 ms), against
// 18.9 MB of keys, 4.7 MB of values and 2.7 MB of queries (~8 us): bound
// by operations. Each of the 81 query tiles of a slot streams that slot's
// 18.9 MB of keys, so the reuse comes from L2 (50 MB): the grid runs the
// query tiles of one slot next to each other (blockIdx.x fastest). Key
// tiles of invalid bank entries (81 tiles an entry) and of the pad tail
// (9 tiles) are skipped without loading K or V. K and V are taken with
// any (batch, head, key) strides, so per-layer bank views enter uncopied.
// fp32 operands (the default build) run the same kernel on split bf16
// parts (attn_common.cuh): three products each, 150 KB of shared memory.

#include "flash_qsmem.cuh"

using namespace attn;

// fp32 != 0: q, k, v and o are float32, else bfloat16.
extern "C" int flash_memattn_fwd(const void* q, const void* k, const void* v,
                                 const void* key_bias, void* o, void* lse, int B, int H,
                                 int lq, int lk, int dk, int dv, int fp32, float sm_scale,
                                 long long sqb, long long sqh, long long sqn, long long skb,
                                 long long skh, long long skn, long long svb, long long svh,
                                 long long svn, long long sob, long long soh, long long son,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk != 256 || dv != 64) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = fp32 ? launch_qsmem<256, 64, float> : launch_qsmem<256, 64, bf16>;
  return launch(q, k, v, key_bias, o, lse, B, H, lq, lk, sm_scale, sqb, sqh, sqn, skb, skh, skn,
                svb, svh, svn, sob, soh, son, st);
}
