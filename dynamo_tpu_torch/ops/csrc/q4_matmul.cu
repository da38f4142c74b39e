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
// Packed bytes stream from HBM; each block unpacks the nibbles and
// dequantizes (u - z) * s in f32 to a bf16 tile in shared memory, where the
// MMAs read it, so neither a bf16 nor an int8 copy of the weight exists in
// HBM. Bound: the packed weight stream at decode sizes, tensor-core
// operations at prefill sizes. Tiling and what it leaves for later:
// dequant_gemm.cuh.

#include "dequant_gemm.cuh"

// Both return cudaGetLastError() (0 = launched) after launching on `stream`.
extern "C" int q4_matmul_v1_bf16(const void* x, const void* q4,
                                 const void* scale, const void* zero, void* out,
                                 int m, int n, int k, int group, void* stream) {
  return dq::launch<dq::kQ4V1>(x, q4, static_cast<const float*>(scale),
                               static_cast<const float*>(zero), out, m, n, k,
                               group, group / 2,
                               reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int q4_matmul_v2_bf16(const void* x, const void* q4,
                                 const void* scale, const void* zero, void* out,
                                 int m, int n, int k, int group, void* stream) {
  return dq::launch<dq::kQ4V2>(x, q4, static_cast<const float*>(scale),
                               static_cast<const float*>(zero), out, m, n, k,
                               group, k / 2,
                               reinterpret_cast<cudaStream_t>(stream));
}
