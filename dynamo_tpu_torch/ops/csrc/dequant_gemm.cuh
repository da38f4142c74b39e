// Weight-only dequantizing GEMM for Hopper, the prefill body (M > 80 rows
// of x) of all three modes: out[M, N] = x[M, K] @ W[K, N], x bf16, W stored
// as int8 codes with a per-column f32 scale (W8A16) or as packed int4
// nibbles with per-group f32 scale and zero rows (W4A16, two layouts), f32
// accumulation on the tensor cores, bf16 out. Also the PTX helpers and the
// code conversions that dequant_gemm_small_m.cuh (M <= 80) shares.
//
// Replaces, above M = 80, the bodies of dynamo_tpu/ops/q8_linear.py::
// _q8_matmul_kernel (row 5) and q4_linear.py::_q4_matmul_kernel_v2 /
// _q4_matmul_kernel (rows 6, 7); q8_matmul.cu and q4_matmul.cu expose
// the C entry points.
//
// Arithmetic, against the plain PyTorch versions:
//   q8: acc = x @ bf16(q8)          (|q| <= 127 is exact in bf16)
//       out = bf16(acc * scale[n])   (per-column scale on the accumulator)
//   q4: w = bf16((u - z[g, n]) * bf16(s[g, n])) per group g of rows: u - z
//       is exact for integer zero points in [-128, 128] (the quantizer's,
//       for any group that holds weights of both signs), then one bf16x2
//       multiply; the plain version rounds (u - z) * s, in f32, to bf16, so
//       the two differ by the rounding of s to bf16 (2^-9 relative). Kept
//       for speed: the product in f32, rounded once (an fsub and an fmul a
//       weight and a cvt a pair, ~4.5 instructions a weight), made rows 6
//       and 7 at M = 512 24% slower (PERF.md section 6).
//       out = bf16(x @ w)
//
// The int4 layouts differ only in where a byte's two nibbles sit in K. Both
// are "byte row p holds code row c_lo(p) in its low nibble and c_lo(p) + h
// in its high nibble", with c_lo(p) = (p / h) * 2h + p % h:
//   v1 (uint8 codes u):       h = group / 2 (half-block inside each group)
//   v2 (int8, nibble = u ^ 8): h = K / 2     (global half split)
// A stage of 32 packed rows therefore yields two runs of 32 code rows each,
// [c_lo, c_lo + 32) and [c_lo + h, c_lo + h + 32), each inside one
// quantization group; the x tile gathers the same two runs. q8 stages are 64
// code rows, copied as two runs of 32 the same way.
//
// Bound on this card: the tensor cores (2 M K N operations against at most
// K N weight bytes); in practice the shared-memory traffic of a stage (TMA
// writes, code reads, wgmma's reads of x) and wgmma issue.
// What held the 64 x 128 wmma tile that this body replaces at ~60 (q4) and
// ~140 (q8) TFLOP/s at M = 512, and what this body does about it:
//   - A small tile re-converting the weight. Each 64-row tile converted the
//     whole weight tile again, and M = 512 ran 8 of them per column tile.
//     Here a block owns a 128 x 128 output tile, so each weight element is
//     converted once per 128 rows of x.
//   - Two-deep register staging, ~8 KB in flight, copies by every thread.
//     Here one producer warp issues TMA copies into a ring of kPreStages
//     stages, each tracked by a full and an empty mbarrier: x as two
//     128 x 32 boxes (one per run) in the 64-byte swizzle that wgmma reads;
//     the RAW weight tile (int8, or packed int4: a half or a quarter of a
//     bf16 tile's bytes) in the 128-byte swizzle; q4's scale and zero rows
//     as 4 bulk copies on a group's first stage. (Copied with cp.async by
//     every thread, the same ring ran at ~15 bytes a cycle per SM.)
//   - The weight converted into shared memory and read back. Here the
//     weight is wgmma's A operand, built in registers: the 128 x 128 tile
//     is computed transposed, out^T = W^T x^T, by 2 warpgroups of 64 weight
//     columns each (m64n128k16, x in shared memory as B). Lane (g, t) of
//     warp q holds A rows g and g + 8, which are weight columns c and c + 1
//     (c = 64 wg + 16 q + 2g), so one 16-bit read gives a code of each, at
//     code rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-deep step (conflict-free
//     under the tile's swizzle). q8: ~2.75 instructions a code
//     (dq::q8_f32x4, dq::int_f32_bf16x2); q4: ~2 (128 + u as bf16 from one
//     prmt and one lop3 a pair, then a bf16x2 sub and mul). Two steps' A
//     fragments alternate, so the conversion of step k + 1 runs while the
//     wgmma of step k does; no bf16 copy of the weight exists anywhere,
//     and no barrier joins the warpgroups.
//   - wmma fragments through shared memory and an f32 epilogue tile. Here
//     the epilogue scales (q8) and writes a bf16 pair (columns c, c + 1) per
//     row straight from the accumulators, masking rows past M and columns
//     past N.
// Not done: thread-block clusters multicasting x, m64n256 tiles, a
// persistent grid, and split-K for grids that do not fill 132 SMs (wk/wv
// at M = 512 run 32 blocks). Three bodies built and timed on the way,
// slower and not kept, are in PERF.md section 6.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dq {

using bf16 = __nv_bfloat16;

enum Mode { kQ8 = 0, kQ4V1 = 1, kQ4V2 = 2 };

// ---- PTX helpers (as in paged_decode_pool.cu) ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma (sm_90a) ------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across a wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major bf16 operand in shared memory with the 64-byte
// swizzle (as TMA writes it): rows of 32 bf16 (64 bytes), 8-row groups 512
// bytes apart, the tile 512-byte aligned; the second 16-deep step of a row
// starts 32 bytes further.
__device__ __forceinline__ uint64_t wgmma_desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// ---- TMA and mbarriers (sm_90) ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// A 2-D box of `tm` at (c0 innermost, c1) into shared memory; completes on
// `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory; completes
// on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// d (64 x 128 f32) += A (64 x 16, bf16 in registers: warp w of the
// warpgroup holds rows 16w .. 16w + 15 as mma.m16n8k16's A fragment) * B
// (16 x 128, K-major bf16 in shared memory).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- code conversions --------------------------------------------------------

// The four int8 codes of `w` as exact f32 (value q): one lop3 for the four
// (q + 128 as an unsigned byte), then per code one prmt into the f32
// 2^23 + 128 + q and one fadd.
__device__ __forceinline__ void q8_f32x4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j))
           - 8388736.f;  // 2^23 + 128
  }
}

// Two exact integer-valued f32 below 256 in magnitude as a bf16 pair (a in
// the low half): their low 16 bits are zero, so the high halves are the
// bf16 values; one prmt.
__device__ __forceinline__ uint32_t int_f32_bf16x2(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// bf16x2 arithmetic on packed pairs (round to nearest even).
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// ---- the prefill body --------------------------------------------------------

constexpr int kPreBM = 128;       // rows of x a block owns
constexpr int kPreBN = 128;       // output columns a block owns
constexpr int kPreKT = 64;        // code rows per ring stage
constexpr int kPreThreads = 256;  // 2 warpgroups (64 weight columns each)
constexpr int kPreStages = 4;

template <int MODE>
struct Prefill {
  static constexpr int kWRows = MODE == kQ8 ? kPreKT : kPreKT / 2;
  static constexpr int kXRun = kPreBM * 64;        // [128][32] bf16, one run
  static constexpr int kX = 2 * kXRun;
  static constexpr int kW = kWRows * kPreBN;       // raw, 128-byte swizzle
  static constexpr int kSZ = MODE == kQ8 ? 0 : 4 * kPreBN * 4;
  static constexpr int kStage = kX + kW + kSZ;
  static constexpr int kBars = 2 * 8 * kPreStages;  // full, empty per slot
  static constexpr int kSmem = kPreStages * kStage + kBars + 1024;
  static_assert(kStage % 1024 == 0, "1024-byte tiles");
  static_assert(kPreBN == 128 && kPreBM == 128, "two m64n128 warpgroups");
};

template <int MODE>
__global__ void __launch_bounds__(kPreThreads + 32, 1)
dequant_gemm(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const float* __restrict__ s, const float* __restrict__ z,
             bf16* __restrict__ out, int M, int N, int K, int group,
             int half) {
  using P = Prefill<MODE>;
  constexpr int KT = kPreKT;
  constexpr int KH = KT / 2;
  constexpr int S = kPreStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                    & 1023);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kPreBN;
  const int m0 = blockIdx.y * kPreBM;
  const int n_it = K / KT;

  auto ring = [&](int slot) { return smem + slot * P::kStage; };
  // full[slot]: the stage's bytes landed; empty[slot]: both warpgroups are
  // done with it (256 arrivals)
  const uint32_t full = smem_addr(smem + S * P::kStage);
  const uint32_t empty = full + 8 * S;
  auto code_lo = [&](int it) {
    if constexpr (MODE == kQ8) {
      return it * KT;
    } else {
      const int p0 = it * KH;
      return (p0 / half) * 2 * half + p0 % half;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kPreThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kPreThreads / 32) {  // the producer warp: TMA copies only
    if (lane == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int slot = it % S;
        if (it >= S) mbar_wait(empty + 8 * slot, ((it / S) - 1) & 1);
        const uint32_t bar = full + 8 * slot;
        const int klo = code_lo(it);
        const int khi = MODE == kQ8 ? klo + KH : klo + half;
        const bool sz_rows = MODE != kQ8 && klo % group == 0;
        const int sz_bytes = 4 * min(kPreBN, N - n0);  // the columns < N
        mbar_expect_tx(bar, P::kX + P::kW + (sz_rows ? 4 * sz_bytes : 0));
        const uint32_t dst = smem_addr(ring(slot));
        tma_load_2d(dst, &tx, klo, m0, bar);
        tma_load_2d(dst + P::kXRun, &tx, khi, m0, bar);
        tma_load_2d(dst + P::kX, &tw, n0, it * P::kWRows, bar);
        if (sz_rows) {  // s_lo, z_lo, s_hi, z_hi of the stage's groups
          for (int row = 0; row < 4; ++row) {
            const float* src = ((row & 1) ? z : s)
                               + (int64_t)((row < 2 ? klo : khi) / group) * N
                               + n0;
            bulk_load(dst + P::kX + P::kW + row * kPreBN * 4, src, sz_bytes,
                      bar);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies weight columns 64 wg .. 64 wg + 63 of
  // the tile (wgmma's A, built in registers from the raw codes) with all
  // 128 rows of x (its B). Warp q of the warpgroup holds A rows 16q ..
  // 16q + 15; lane (g, t)'s rows g and g + 8 are weight columns c and c + 1
  // (one 16-bit read of two codes), c = 64 wg + 16 q + 2g.
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c = 64 * wg + 16 * (warp & 3) + 2 * g;
  // q4: bf16x2 (128 + z, 128 + z) and (s, s) of columns c, c + 1, per run
  uint32_t zz[2][2], ss[2][2];

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a[2][4];  // A fragments of two 16-deep steps in flight

  for (int it = 0; it < n_it; ++it) {
    const int slot = it % S;
    mbar_wait(full + 8 * slot, (it / S) & 1);
    const unsigned char* ws = ring(slot) + P::kX;
    const uint32_t xs = smem_addr(ring(slot));
    if constexpr (MODE != kQ8) {
      if (code_lo(it) % group == 0) {
        const float* sz = reinterpret_cast<const float*>(ws + P::kW);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int run = 0; run < 2; ++run) {
            const float* sr = sz + 2 * run * kPreBN + c + e;
            zz[e][run] = pack_bf16x2(sr[kPreBN] + 128.f, sr[kPreBN] + 128.f);
            ss[e][run] = pack_bf16x2(sr[0], sr[0]);
          }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // the wgmma that last read a[kk & 1] (two steps back) is done
      wgmma_wait<1>();
      if (kk == 1 && it > 0) {  // and so is every wgmma of stage it - 1
        mbar_arrive(empty + 8 * ((it - 1) % S));
      }
      // code rows (q4: packed rows) r0 + 2t, 2t + 1, 2t + 8, 2t + 9 of
      // columns c, c + 1
      const int r0 = MODE == kQ8 ? 16 * kk : 16 * (kk & 1);
      uint32_t h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 2 * t + (q & 1) + (q >> 1) * 8;
        h[q] = *reinterpret_cast<const uint16_t*>(
            ws + r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15));
      }
      uint32_t* ak = a[kk & 1];
      if constexpr (MODE == kQ8) {
        float f[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) q8_f32x4(h[q], f[q]);
        ak[0] = int_f32_bf16x2(f[0][0], f[1][0]);  // column c, k 2t, 2t+1
        ak[1] = int_f32_bf16x2(f[0][1], f[1][1]);  // column c + 1
        ak[2] = int_f32_bf16x2(f[2][0], f[3][0]);  // column c, k 2t + 8, 9
        ak[3] = int_f32_bf16x2(f[2][1], f[3][1]);
      } else {
        const int run = kk >> 1;  // steps 0, 1: low nibbles; 2, 3: high
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t h0 = h[2 * q], h1 = h[2 * q + 1];  // rows 2t + 8q, + 1
          if (MODE == kQ4V2) {  // signed-biased nibbles
            h0 ^= 0x8888u;
            h1 ^= 0x8888u;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // byte e (column c + e) of both rows: bf16x2 128 + u (exact),
            // then (128 + u - (128 + z)) * s
            uint32_t v = __byte_perm(h0, h1, e | (e << 4) | ((4 + e) << 8)
                                                 | ((4 + e) << 12));
            v = ((run ? v >> 4 : v) & 0x000F000Fu) | 0x43004300u;
            ak[2 * q + e] = bf16x2_mul(bf16x2_sub(v, zz[e][run]),
                                       ss[e][run]);
          }
        }
      }
      fence_regs(acc);
      wgmma_fence();
      wgmma_m64n128k16_rs(acc, a[kk & 1],
                          wgmma_desc64(xs + (kk >> 1) * P::kXRun
                                       + 32 * (kk & 1)));
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: acc[4j + e] of lane (g, t) is weight column c (+ 1 for
  // e >= 2) of x row 8j + 2t (+ 1 for odd e): a bf16 pair (c, c + 1) per row.
  const int n = n0 + c;
  if (n >= N) return;
  float2 sc = make_float2(1.f, 1.f);
  if constexpr (MODE == kQ8) sc = *reinterpret_cast<const float2*>(s + n);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + 8 * j + 2 * t;
    if (m < M) {
      *reinterpret_cast<uint32_t*>(out + (int64_t)m * N + n) =
          pack_bf16x2(acc[4 * j] * sc.x, acc[4 * j + 2] * sc.y);
    }
    if (m + 1 < M) {
      *reinterpret_cast<uint32_t*>(out + (int64_t)(m + 1) * N + n) =
          pack_bf16x2(acc[4 * j + 1] * sc.x, acc[4 * j + 3] * sc.y);
    }
  }
}

// cuTensorMapEncodeTiled (a libcuda entry point), found once through the
// runtime's entry-point query, so nothing links against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D row-major tensor [rows][cols] of `elem`-byte elements, boxes of
// box_rows x box_cols; zero fill past the edges.
inline bool make_map(CUtensorMap* tm, CUtensorMapDataType type, int elem,
                     const void* base, int rows, int cols, int box_rows,
                     int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(tm, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the prefill body on `st`; returns cudaGetLastError() (0 =
// launched) or cudaErrorInvalidValue when the tensor maps cannot be made.
// The caller checks the geometry: N % 16 == 0, K % 64 == 0, and for q4 every
// run of 32 code rows inside one group (32 divides `half` and `group`).
template <int MODE>
int launch_prefill(const void* x, const void* w, const float* s,
                   const float* z, void* out, int M, int N, int K, int group,
                   int half, cudaStream_t st) {
  using P = Prefill<MODE>;
  // Opt in to the instantiation's shared memory once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      dequant_gemm<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tx, tw;
  if (!make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, kPreBM, 32,
                CU_TENSOR_MAP_SWIZZLE_64B)
      || !make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w,
                   MODE == kQ8 ? K : K / 2, N, P::kWRows, kPreBN,
                   CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kPreBN - 1) / kPreBN, (M + kPreBM - 1) / kPreBM);
  dequant_gemm<MODE><<<grid, kPreThreads + 32, P::kSmem, st>>>(
      tx, tw, s, z, static_cast<bf16*>(out), M, N, K, group, half);
  return (int)cudaGetLastError();
}

}  // namespace dq
