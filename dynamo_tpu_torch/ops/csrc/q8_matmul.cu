// W8A16 matmul for Hopper: x [M, K] bf16 @ q8 [K, N] int8, per-column
// scale [N] f32 -> [M, N] bf16, f32 accumulation on the tensor cores.
//
// Replaces dynamo_tpu/ops/q8_linear.py::_q8_matmul_kernel (behind
// q8_matmul, row 5). The int8 codes stream from HBM and turn into bf16 on
// the SM, so no bf16 copy of the weight exists in HBM; the scale, which has
// no contracted axis, lands once on the f32 sum. Two bodies:
//
//   M <= 80 (decode batches and verification chunks):
//     dequant_gemm_small_m.cuh's q8_small_m. Bound: the int8 weight stream
//     (274 MB over mistral-7b's five projections, 0.082 ms at 3.35 TB/s).
//     Split-K over the host's plan (q8_split_plan: spans of whole 32-row
//     stages, enough blocks for 132 SMs), a cp.async ring of raw code
//     tiles and x columns, one block over all M rows, codes turned into
//     mma.sync B fragments in registers; the scale lands in the epilogue
//     (one split) or in the deterministic split reduction (several), a
//     second launch.
//   M > 80 (prefill chunks): dequant_gemm.cuh's 128 x 128 prefill body,
//     shared with q4_matmul.cu. Bound: the tensor cores. TMA copies of x
//     and of the raw codes into a 4-stage ring; two warpgroups turn each
//     code, once per 128 rows of x, into wgmma's register operand (the
//     product computed transposed, x as the shared-memory operand).
//
// What held the old 16 x 64 / 64 x 128 wmma tiles at 3.9x the bound at
// M = 8 and 4.0-5.1x torch.matmul at M = 80-512, and the answer of each
// body, are in the two headers.

#include "dequant_gemm_small_m.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 = launched) or
// cudaErrorInvalidValue for a geometry or plan the kernel does not take.
// (block_n, n_split, span) is q8_split_plan's; `part` is an f32 workspace
// [n_split, M, N] when n_split > 1 (else unused, may be null).
extern "C" int q8_matmul_bf16(const void* x, const void* q8, const void* scale,
                              void* out, void* part, int m, int n, int k,
                              int block_n, int n_split, int span,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  if (m <= 0 || n <= 0 || k <= 0 || n % 16 || k % 64) {
    return (int)cudaErrorInvalidValue;
  }
  if (m > dqs::kMaxRows) {  // prefill
    if (block_n != dq::kPreBN || n_split != 1 || span != k) {
      return (int)cudaErrorInvalidValue;
    }
    return dq::launch_prefill<dq::kQ8>(x, q8, s, nullptr, out, m, n, k, 0, 0,
                                       st);
  }
  if (span <= 0 || span % dqs::kStageRows
      || n_split != (k + span - 1) / span || (n_split > 1 && !p)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m <= 16) {
    if (block_n != 128) return (int)cudaErrorInvalidValue;
    return dqs::launch_small_q8<1, 4>(x, q8, s, out, p, m, n, k, n_split,
                                      span, st);
  }
  if (block_n != 256) return (int)cudaErrorInvalidValue;
  if (m <= 48) {
    return dqs::launch_small_q8<3, 8>(x, q8, s, out, p, m, n, k, n_split,
                                      span, st);
  }
  return dqs::launch_small_q8<5, 8>(x, q8, s, out, p, m, n, k, n_split, span,
                                    st);
}
