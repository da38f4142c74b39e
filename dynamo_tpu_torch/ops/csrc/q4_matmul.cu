// W4A16 matmul for Hopper: x [M, K] bf16 @ packed int4 [K/2, N] with
// per-group scale and zero rows [K/group, N] f32 -> [M, N] bf16, f32
// accumulation on the tensor cores. Two entry points, one per pack layout:
//
//   q4_matmul_v2_bf16 replaces dynamo_tpu/ops/q4_linear.py::
//     _q4_matmul_kernel_v2 (int8 bytes, global half split: byte row r holds
//     code rows r and r + K/2 as signed nibbles biased by 8);
//   q4_matmul_v1_bf16 replaces _q4_matmul_kernel (uint8 bytes, half-block:
//     inside each group, byte row r holds code rows r and r + group/2).
//
// Packed bytes stream from HBM and are dequantized on the SM, so neither a
// bf16 nor an int8 copy of the weight exists in HBM. Two bodies:
//
//   M <= 80 (decode batches and verification chunks): dequant_gemm_small_m.cuh.
//     Bound: the packed weight stream. Split-K over the host's plan
//     (q4_split_plan: group-aligned spans, enough blocks for 132 SMs), a
//     cp.async ring of packed tiles, one block over all M rows, raw codes
//     into mma.sync fragments in registers with the zero point and scale
//     folded in once per group; several splits add their f32 partials in a
//     second, deterministic launch.
//   M > 80 (prefill chunks): dequant_gemm.cuh's 128 x 128 prefill body,
//     shared with q8_matmul.cu. Bound: the tensor cores. TMA copies of the
//     two x runs and of the packed bytes into a 4-stage ring; two
//     warpgroups dequantize each weight once per 128 rows of x in bf16x2
//     ((128 + u - (128 + z)) * s) straight into wgmma's register operand.
//     (The 64 x 128 wmma tile it replaced dequantized the weight again for
//     every 64 rows and ran at ~60 TFLOP/s.)

#include "dequant_gemm_small_m.cuh"

namespace {

// Checks the host's plan against the geometry and launches; returns
// cudaGetLastError() (0 = launched) or cudaErrorInvalidValue.
template <int MODE>
int launch_q4(const void* x, const void* w, const float* s, const float* z,
              void* out, float* part, int M, int N, int K, int group,
              int half, int block_n, int n_split, int span, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 64 || group <= 0
      || K % group || half <= 0 || half % dqs::kStageRows
      || group % dqs::kStageRows) {
    return (int)cudaErrorInvalidValue;
  }
  // A split is whole groups of both nibble runs: v1 group / 2 packed rows,
  // v2 group packed rows. The prefill body relies on this too: it reloads
  // a run's scale and zero rows only where a group starts.
  const int unit = MODE == dq::kQ4V1 ? group / 2 : group;
  if (unit % dqs::kStageRows || (K / 2) % unit) {
    return (int)cudaErrorInvalidValue;
  }
  if (M > dqs::kMaxRows) {  // prefill: the 128 x 128 body, one split
    if (block_n != dq::kPreBN || n_split != 1 || span != K / 2) {
      return (int)cudaErrorInvalidValue;
    }
    return dq::launch_prefill<MODE>(x, w, s, z, out, M, N, K, group, half,
                                    st);
  }
  if (span <= 0 || span % unit || n_split != (K / 2 + span - 1) / span
      || (n_split > 1 && !part)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M <= 16) {
    if (block_n != 64) return (int)cudaErrorInvalidValue;
    return dqs::launch_small<MODE, 1, 2>(x, w, s, z, out, part, M, N, K,
                                         group, half, n_split, span, st);
  }
  if (block_n != 128) return (int)cudaErrorInvalidValue;
  if (M <= 48) {
    return dqs::launch_small<MODE, 3, 4>(x, w, s, z, out, part, M, N, K,
                                         group, half, n_split, span, st);
  }
  return dqs::launch_small<MODE, 5, 4>(x, w, s, z, out, part, M, N, K,
                                       group, half, n_split, span, st);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// (block_n, n_split, span) is q4_split_plan's; `part` is an f32 workspace
// [n_split, M, N] when n_split > 1 (else unused, may be null).
extern "C" int q4_matmul_v1_bf16(const void* x, const void* q4,
                                 const void* scale, const void* zero, void* out,
                                 void* part, int m, int n, int k, int group,
                                 int block_n, int n_split, int span,
                                 void* stream) {
  return launch_q4<dq::kQ4V1>(x, q4, static_cast<const float*>(scale),
                              static_cast<const float*>(zero), out,
                              static_cast<float*>(part), m, n, k, group,
                              group / 2, block_n, n_split, span, stream);
}

extern "C" int q4_matmul_v2_bf16(const void* x, const void* q4,
                                 const void* scale, const void* zero, void* out,
                                 void* part, int m, int n, int k, int group,
                                 int block_n, int n_split, int span,
                                 void* stream) {
  return launch_q4<dq::kQ4V2>(x, q4, static_cast<const float*>(scale),
                              static_cast<const float*>(zero), out,
                              static_cast<float*>(part), m, n, k, group, k / 2,
                              block_n, n_split, span, stream);
}
