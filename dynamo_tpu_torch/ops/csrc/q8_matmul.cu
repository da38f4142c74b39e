// W8A16 matmul for Hopper: x [M, K] bf16 @ q8 [K, N] int8, per-column
// scale [N] f32 -> [M, N] bf16, f32 accumulation on the tensor cores.
//
// Replaces dynamo_tpu/ops/q8_linear.py::_q8_matmul_kernel (behind
// q8_matmul): int8 tiles stream from HBM, convert to bf16 in shared memory
// and feed the MMAs; the scale, which has no contracted axis, lands on the
// f32 accumulator in the epilogue. Bound: the int8 weight stream at decode
// sizes, tensor-core operations at prefill sizes. Tiling and what it leaves
// for later: dequant_gemm.cuh.

#include "dequant_gemm.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int q8_matmul_bf16(const void* x, const void* q8, const void* scale,
                              void* out, int m, int n, int k, void* stream) {
  return dq::launch<dq::kQ8>(x, q8, static_cast<const float*>(scale), nullptr,
                             out, m, n, k, 0, 0,
                             reinterpret_cast<cudaStream_t>(stream));
}
