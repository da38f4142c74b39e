// Weight-only dequantizing GEMM for Hopper: out[M, N] = x[M, K] @ W[K, N],
// x bf16, W stored as int8 codes (W8A16) or packed int4 nibbles (W4A16),
// f32 accumulation on the tensor cores, bf16 out. Shared by q8_matmul.cu
// and q4_matmul.cu, which expose the plain C entry points.
//
// The weight never exists in bf16 in HBM: each block streams its packed
// tile into registers, dequantizes it into a bf16 tile in shared memory,
// and multiplies there with nvcuda::wmma 16x16x16 bf16 fragments.
//
// Arithmetic, matching the plain PyTorch versions:
//   q8: acc = x @ bf16(q8)          (|q| <= 127 is exact in bf16)
//       out = bf16(acc * scale[n])   (per-output-channel scale, epilogue)
//   q4: w = bf16((u - z[g, n]) * s[g, n]) in f32, per group g of rows
//       out = bf16(x @ w)
//
// The int4 layouts differ only in where a byte's two nibbles sit in K. Both
// are "byte row p holds code row c_lo(p) in its low nibble and c_lo(p) + h
// in its high nibble", with c_lo(p) = (p / h) * 2h + p % h:
//   v1 (uint8 codes u):       h = group / 2 (half-block inside each group)
//   v2 (int8, nibble = u ^ 8): h = K / 2     (global half split)
// A tile of KT / 2 packed rows therefore yields two runs of KT / 2 code
// rows each, [c_lo, c_lo + KT/2) and [c_lo + h, c_lo + h + KT/2), each
// inside one quantization group; the x tile gathers the same two runs.
//
// Who runs this body: q8 at every M, q4 only at M > 80 (prefill chunks;
// q4 at M <= 80 runs dequant_gemm_small_m.cuh, which has split-K, a
// cp.async ring and one block over all rows).
// Bound on this card: at decode (M <= 16) the weight stream (HBM bytes);
// at prefill (M in the hundreds or thousands) the tensor cores.
// Design (simple and right first): one 128-thread block per BM x BN output
// tile, BM = 16 for M <= 16 (decode) and 64 otherwise; the next tile's
// global loads are issued into registers before the current tile's MMAs,
// so loads overlap compute. What holds it back: one tile of ~4 KB in
// flight per block and no split-K (at N = 4096 the decode grid holds 64
// blocks for 132 SMs), so the q8 decode shapes are latency-bound; each
// 64-row tile dequantizes the whole weight tile again through shared
// memory. Left for later work: q8 on the small-M body, wgmma and TMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dq {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps

enum Mode { kQ8 = 0, kQ4V1 = 1, kQ4V2 = 2 };

template <int MODE, int BM, int BN, int KT>
struct Tile {
  static constexpr int XLD = KT + 8;   // bf16 row pitch of the x tile
  static constexpr int WLD = BN + 8;   // bf16 row pitch of the weight tile
  static constexpr int CLD = BN + 4;   // f32 row pitch of the epilogue tile
  static constexpr int WM = BM >= 32 ? 2 : 1;  // warps along M
  static constexpr int WN = 4 / WM;            // warps along N
  static constexpr int FM = BM / (16 * WM);    // fragments per warp along M
  static constexpr int FN = BN / (16 * WN);    // fragments per warp along N
  static constexpr int KH = KT / 2;            // code rows per run
  static constexpr int WROWS = MODE == kQ8 ? KT : KH;  // weight rows per tile
  static constexpr int WCPR = BN / 16;         // 16-byte chunks per weight row
  static constexpr int WCH = WROWS * WCPR / kThreads;
  static constexpr int XCPR = KT / 8;          // 16-byte chunks per x row
  static constexpr int XCH = BM * XCPR / kThreads;
  static constexpr int SZN = MODE == kQ8 ? 1 : 4 * BN / kThreads;
  static constexpr int OCH = BM * BN / 8 / kThreads;
  static constexpr int kMain = (BM * XLD + KT * WLD) * 2 + 4 * BN * 4;
  static constexpr int kEpi = BM * CLD * 4;
  static constexpr int kBytes = kMain > kEpi ? kMain : kEpi;
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0, "tile shape");
  static_assert(WCH * kThreads == WROWS * WCPR, "weight chunks");
  static_assert(XCH * kThreads == BM * XCPR, "x chunks");
  static_assert(OCH * kThreads * 8 == BM * BN, "output chunks");
  static_assert(kBytes <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight floats -> eight bf16 (round to nearest even) in one 16-byte store.
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 o;
  o.x = pack_bf16x2(v[0], v[1]);
  o.y = pack_bf16x2(v[2], v[3]);
  o.z = pack_bf16x2(v[4], v[5]);
  o.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = o;
}

// x [M, K] bf16 row-major; w: q8 [K, N] int8 or packed q4 [K/2, N] bytes;
// s: q8 [N] or q4 [K/group, N] f32; z: q4 [K/group, N] f32 (unused for q8);
// out [M, N] bf16. `half` is the layout's h (see the header comment).
template <int MODE, int BM, int BN, int KT>
__global__ void __launch_bounds__(kThreads)
dequant_gemm(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ s, const float* __restrict__ z,
             bf16* __restrict__ out, int M, int N, int K, int group,
             int half) {
  using T = Tile<MODE, BM, BN, KT>;
  constexpr int KH = T::KH;

  __shared__ __align__(128) unsigned char smem[T::kBytes];
  bf16* xs = reinterpret_cast<bf16*>(smem);           // [BM][XLD]
  bf16* ws = xs + BM * T::XLD;                        // [KT][WLD]
  float* sz = reinterpret_cast<float*>(ws + KT * T::WLD);  // [4][BN] q4
  float* cs = reinterpret_cast<float*>(smem);         // [BM][CLD] epilogue

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / T::WN;
  const int wn = warp % T::WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int n_iter = K / KT;

  uint4 xr[T::XCH];
  uint4 wr[T::WCH];
  float szr[T::SZN];

  // Global -> registers for tile `it`.
  auto load = [&](int it) {
    int klo, khi;
    if constexpr (MODE == kQ8) {
      klo = it * KT;
      khi = klo + KH;
    } else {
      const int p0 = it * KH;
      klo = (p0 / half) * 2 * half + p0 % half;
      khi = klo + half;
    }
#pragma unroll
    for (int i = 0; i < T::XCH; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / T::XCPR;
      const int cj = c % T::XCPR;
      const int k = cj < KH / 8 ? klo + cj * 8 : khi + (cj - KH / 8) * 8;
      const int m = m0 + r;
      xr[i] = m < M ? *reinterpret_cast<const uint4*>(x + (int64_t)m * K + k)
                    : make_uint4(0, 0, 0, 0);
    }
    const int wrow0 = it * T::WROWS;
#pragma unroll
    for (int i = 0; i < T::WCH; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / T::WCPR;
      const int n = n0 + (c % T::WCPR) * 16;
      wr[i] = n < N ? *reinterpret_cast<const uint4*>(
                          w + (int64_t)(wrow0 + r) * N + n)
                    : make_uint4(0, 0, 0, 0);
    }
    if constexpr (MODE != kQ8) {
      const int glo = klo / group;
      const int ghi = khi / group;
#pragma unroll
      for (int i = 0; i < T::SZN; ++i) {
        const int c = tid + i * kThreads;
        const int which = c / BN;  // 0 s_lo, 1 z_lo, 2 s_hi, 3 z_hi
        const int n = n0 + c % BN;
        const float* src = (which & 1) ? z : s;
        const int grow = which < 2 ? glo : ghi;
        szr[i] = n < N ? src[(int64_t)grow * N + n] : 0.f;
      }
    }
  };

  // Registers -> shared memory, dequantizing the weight tile to bf16.
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < T::XCH; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(xs + (c / T::XCPR) * T::XLD
                                + (c % T::XCPR) * 8) = xr[i];
    }
    if constexpr (MODE != kQ8) {
#pragma unroll
      for (int i = 0; i < T::SZN; ++i) sz[tid + i * kThreads] = szr[i];
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < T::WCH; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / T::WCPR;
      const int col = (c % T::WCPR) * 16;
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&wr[i]);
      if constexpr (MODE == kQ8) {
        float v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = (float)(int8_t)b[e];
        bf16* dst = ws + r * T::WLD + col;
        store8(dst, v);
        store8(dst + 8, v + 8);
      } else {
        float lo[16], hi[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          int u_lo = b[e] & 0xF;
          int u_hi = b[e] >> 4;
          if (MODE == kQ4V2) {  // signed-biased nibbles: u = nibble ^ 8
            u_lo ^= 8;
            u_hi ^= 8;
          }
          lo[e] = ((float)u_lo - sz[BN + col + e]) * sz[col + e];
          hi[e] = ((float)u_hi - sz[3 * BN + col + e]) * sz[2 * BN + col + e];
        }
        bf16* dlo = ws + r * T::WLD + col;
        bf16* dhi = ws + (KH + r) * T::WLD + col;
        store8(dlo, lo);
        store8(dlo + 8, lo + 8);
        store8(dhi, hi);
        store8(dhi + 8, hi + 8);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int it = 0; it < n_iter; ++it) {
    stage();
    __syncthreads();
    if (it + 1 < n_iter) load(it + 1);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[T::FM];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(
            a[i], xs + (wm * T::FM + i) * 16 * T::XLD + kk, T::XLD);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(
            bfr, ws + kk * T::WLD + (wn * T::FN + j) * 16, T::WLD);
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
          wmma::mma_sync(acc[i][j], a[i], bfr, acc[i][j]);
      }
    }
    __syncthreads();  // xs / ws / sz are rewritten by the next stage()
  }

  // Epilogue through shared memory: per-column scale (q8), bf16, guarded
  // M and N tails.
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(
          cs + (wm * T::FM + i) * 16 * T::CLD + (wn * T::FN + j) * 16,
          acc[i][j], T::CLD, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::OCH; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (BN / 8);
    const int cj = (c % (BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + cj;
    if (m < M && n < N) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = cs[r * T::CLD + cj + e];
        if (MODE == kQ8) v[e] *= s[n + e];
      }
      store8(out + (int64_t)m * N + n, v);
    }
  }
}

template <int MODE, int BM, int BN, int KT>
void launch_tile(const void* x, const void* w, const float* s, const float* z,
                 void* out, int M, int N, int K, int group, int half,
                 cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_gemm<MODE, BM, BN, KT><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), s, z,
      static_cast<bf16*>(out), M, N, K, group, half);
}

// Picks the tile for M and the layout; returns cudaGetLastError() (0 =
// launched) or cudaErrorInvalidValue for a geometry no tile covers.
// Requirements: N % 16 == 0; K % 64 == 0; for q4 every run of KT/2 code
// rows lies inside one group (KT/2 divides h and the group).
template <int MODE>
int launch(const void* x, const void* w, const float* s, const float* z,
           void* out, int M, int N, int K, int group, int half,
           cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 64) {
    return (int)cudaErrorInvalidValue;
  }
  auto runs_fit = [&](int kh) {
    return MODE == kQ8 || (half > 0 && half % kh == 0 && group % kh == 0);
  };
  if (M <= 16 && K % 128 == 0 && runs_fit(64)) {
    launch_tile<MODE, 16, 64, 128>(x, w, s, z, out, M, N, K, group, half, st);
  } else if (M <= 16 && runs_fit(32)) {
    launch_tile<MODE, 16, 64, 64>(x, w, s, z, out, M, N, K, group, half, st);
  } else if (runs_fit(32)) {
    launch_tile<MODE, 64, 128, 64>(x, w, s, z, out, M, N, K, group, half, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace dq
